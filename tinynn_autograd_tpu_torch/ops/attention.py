"""Flash attention: softmax(Q K^T * scale [+ masks]) V and its hand-written
VJP, as CUDA kernels on the GPU and their plain PyTorch versions on the CPU.

PyTorch counterpart of the JAX package's ops/attention.py. The forward keeps
one [64, 32] score tile at a time in registers (online softmax) and writes
only O and the per-row logsumexp; the backward is the recompute scheme

    D_i   = sum_d dO_id O_id                 (a torch reduction, outside)
    p_ij  = exp(s_ij - L_i)                  (L = logsumexp, saved forward)
    dV_j  = sum_i p_ij dO_i
    dp_ij = dO_i . V_j
    ds_ij = p_ij (dp_ij - D_i) * scale
    dQ_i  = sum_j ds_ij K_j
    dK_j  = sum_i ds_ij Q_i

run as two kernels, dq over query tiles and dk/dv over key tiles, so each
output is written once (``csrc/attention.cu``).

Layout: Q/K/V/O are [B, H, T, d]; lse is [B, H, Tq, 1] in f32. Q and K share
one head dim d_qk, and V (so O, dO and dV) may have its own, d_v: multi-head
latent attention's 192-wide queries and keys with 128-wide values. K/V may
carry fewer heads (grouped-query attention, Hkv | H: query head h reads kv head
h // (H/Hkv)), Tq may differ from Tk (cross attention, non-causal only),
``window`` bands causal attention to the keys in (p - window, p], and
``dropout_rate`` drops attention probabilities (on the P.V product only;
the normaliser sums the unmasked p) with a counter hash of the absolute
(head, query, key) index, so the backward replays the forward's mask without
storing it. The hash and its head index and seed under GQA are the JAX
package's, bit for bit.

Dispatch: ``mha_fwd``/``mha_bwd`` run the kernels for CUDA tensors and the
plain versions (``attention_forward_reference``/``attention_backward_
reference``, with materialised scores) for CPU tensors. ``impl="plain"`` asks
for the plain versions on the card. Nothing falls back from one to the other:
a CUDA tensor the kernels do not take raises ``ValueError`` naming the rule.
"""

import numpy as np
import torch

from tinynn_autograd_tpu_torch.ops import kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # the kernels' limit on d where d_qk == d_v
SPLIT_HEAD_DIMS = (192, 128)  # the kernels' limits on (d_qk, d_v) otherwise
_GOLDEN = 2654435761
_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# masks and the dropout hash
# --------------------------------------------------------------------------

def band_mask(t, window):
    """[t, t] boolean visibility mask: causal, optionally banded to the
    sliding window (position p sees keys in (p - window, p])."""
    m = np.tril(np.ones((t, t), np.bool_))
    if window is not None and window < t:
        m &= ~np.tril(np.ones((t, t), np.bool_), -int(window))
    return m


def _norm_window(window, causal, t):
    """None passthrough; a window needs the causal mask and must be a
    positive int; window >= t is plain causal attention (None)."""
    if window is None:
        return None
    if not causal:
        raise ValueError("sliding-window attention requires causal=True")
    window = int(window)
    if window < 1:
        raise ValueError("window must be >= 1, got %d" % window)
    return None if window >= t else window


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 tensors x in [0, 2**32) and an int c in
    [0, 2**32), in two 16-bit halves of c so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _finalize(x):
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate):
    """The keep test's uint32 threshold (``x < thresh`` keeps)."""
    return int((1.0 - rate) * (2 ** 32 - 1))


def tile_keep_mask(seed, h0, q0, k0, g, nrow, ncol, tq, tk, thresh,
                   q_axis=1, device=None):
    """Boolean [g, nrow, ncol] keep mask of one score tile: the JAX
    package's ``_tile_keep_mask`` in int64 arithmetic. ``q_axis`` names the
    tile axis (1 or 2) that carries the query index."""
    def iota(n, shape):
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)

    hi = iota(g, (g, 1, 1)) + int(h0)
    a1 = iota(nrow, (1, nrow, 1))
    a2 = iota(ncol, (1, 1, ncol))
    qi = (a1 if q_axis == 1 else a2) + int(q0)
    ki = (a2 if q_axis == 1 else a1) + int(k0)
    x = (_mul32((_mul32(hi, tq) + qi) & _M32, tk) + ki) & _M32
    x = (x + _mul32(torch.tensor(int(seed) & _M32, device=device),
                    _GOLDEN)) & _M32
    return _finalize(x) < thresh


def full_keep_mask(seed, bh, tq, tk, rate, device=None):
    """[BH, Tq, Tk] keep mask over whole planes (``_full_keep_mask``)."""
    return tile_keep_mask(seed, 0, 0, 0, bh, tq, tk, tq, tk,
                          keep_threshold(rate), device=device)


def group_seed(seed, gi):
    """The seed of GQA group ``gi`` (the JAX package calls its kernels
    once per group with this seed)."""
    if seed is None:
        return None
    return (int(seed) + gi * _GOLDEN) % 2 ** 32


def _keep_mask(seed, b, h, hkv, tq, tk, rate, device):
    """[B, H, Tq, Tk] keep mask as the JAX package's group calls make it:
    query head h = kvh * group + gi hashes with head index b * Hkv + kvh and
    ``group_seed(seed, gi)``."""
    group = h // hkv
    masks = [full_keep_mask(group_seed(seed, gi), b * hkv, tq, tk, rate,
                            device).reshape(b, hkv, 1, tq, tk)
             for gi in range(group)]
    return torch.cat(masks, dim=2).reshape(b, h, tq, tk)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _acc(x):
    """The plain versions' arithmetic type: f32, or float64 for float64
    inputs (a reference for the kernels' f32 error)."""
    return torch.promote_types(x.dtype, torch.float32)


def _masked_scores(q, k, causal, scale, window, product=torch.matmul):
    """Scores [B, H, Tq, Tk] in ``_acc(q)``, kv heads repeated to the query
    heads, masked positions at NEG_INF."""
    k = _repeat_kv(k, q.shape[1] // k.shape[1])
    acc = _acc(q)
    s = product(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if causal:
        vis = torch.from_numpy(band_mask(q.shape[2], window)).to(s.device)
        s = torch.where(vis, s, NEG_INF)
    return s


def _repeat_kv(x, group):
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def attention_forward_reference(q, k, v, causal, scale, window=None,
                                dropout_rate=0.0, seed=None,
                                product=torch.matmul):
    """(o [B,H,Tq,d_v], lse [B,H,Tq,1] f32; float64 for float64 inputs) with
    materialised scores: the kernels' arithmetic in plain PyTorch (the JAX
    package's ``_fwd_xla``). ``product(a, b)`` forms S = Q K^T and P_d V
    (a [..., m, k] @ b [..., k, n]); ``tf32.matmul_3xtf32`` there models the
    kernel's tensor-core arithmetic. The default forms P_d V by einsum."""
    b, h, tq, _ = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    s = _masked_scores(q, k, causal, scale, window, product)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = _keep_mask(seed or 0, b, h, hkv, tq, tk, dropout_rate,
                          q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    vx = _repeat_kv(v, h // hkv).to(p.dtype)
    pv = (torch.einsum("bhqk,bhkd->bhqd", p, vx) if product is torch.matmul
          else product(p, vx))
    o = pv / l
    return o.to(q.dtype), m + torch.log(l)


def attention_backward_reference(q, k, v, do, lse, delta, causal, scale,
                                 window=None, dropout_rate=0.0, seed=None,
                                 product=torch.matmul):
    """(dq, dk, dv) of the recompute scheme with materialised scores (the
    JAX package's ``_bwd_xla``); ``delta`` [B,H,Tq] is rowsum(dO * O). dq
    and dk have q's and k's head dim, dv v's. Under GQA dk/dv sum over each
    kv head's group of query heads. In f32, or in
    float64 for float64 inputs. ``product(a, b)`` forms each of the five
    matrix products (a [..., m, k] @ b [..., k, n]); ``tf32.matmul_3xtf32``
    there models the kernels' tensor-core arithmetic."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = h // hkv
    acc = _acc(q)
    kx, vx = _repeat_kv(k, group).to(acc), _repeat_kv(v, group).to(acc)
    s = _masked_scores(q, k, causal, scale, window, product)
    p = torch.exp(s - lse.reshape(b, h, tq, 1).to(acc))
    dof = do.to(acc)
    dp = product(dof, vx.transpose(-1, -2))
    if dropout_rate > 0.0:
        keep = _keep_mask(seed or 0, b, h, hkv, tq, tk, dropout_rate,
                          q.device)
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    else:
        pd = p
    ds = p * (dp - delta.reshape(b, h, tq, 1).to(acc)) * scale
    dq = product(ds, kx)
    dk = product(ds.transpose(-1, -2), q.to(acc))
    dv = product(pd.transpose(-1, -2), dof)
    if group > 1:
        dk = dk.reshape(b, hkv, group, tk, d).sum(dim=2)
        dv = dv.reshape(b, hkv, group, tk, v.shape[-1]).sum(dim=2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _bind(lib, ctypes):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    F, U = ctypes.c_float, ctypes.c_uint
    opts = [F, I, I, I, U, F, U]  # scale, causal, window, dropout, thresh,
    #                               inv, seed
    for name, n_ptrs in (("forward", 5), ("backward_dq", 7),
                         ("backward_dkv", 8)):
        n_strided = 3 if name == "forward" else 4
        design = [] if name == "forward" else [I]  # dq_design's, dkv_design's
        fn = getattr(lib, "tinynn_attention_" + name)
        fn.argtypes = [P] * n_ptrs + [I] * 7 + [L] * (3 * n_strided) \
            + opts + design + [P]
        fn.restype = ctypes.c_int


def _operands(what, q, k, v, *rest):
    """Checks what the kernels take; returns q, k, v and ``rest`` with a
    unit-stride head dim (a tensor that has another is copied)."""
    tensors = (q, k, v) + rest
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("%s needs CUDA tensors, got %s" % (
            what, ", ".join(str(t.device) for t in tensors)))
    if any(t.device != q.device for t in tensors):
        raise ValueError("%s: operands on different devices" % what)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("%s takes float32 tensors (the kernels' f32 "
                         "contract), got %s" % (what, sorted({str(t.dtype)
                                                         for t in tensors})))
    d, dv = q.shape[-1], v.shape[-1]
    if d == dv and d > MAX_HEAD_DIM:
        raise ValueError("%s: head dim %d exceeds %d, the kernels' limit"
                         % (what, d, MAX_HEAD_DIM))
    if d != dv and not split_dims(d, dv):
        raise ValueError(
            "%s: head dims %d (q, k) and %d (v): the kernels take one head "
            "dim up to %d for q, k and v, or q's and k's in (%d, %d] with "
            "v's up to %d" % ((what, d, dv, MAX_HEAD_DIM, MAX_HEAD_DIM)
                              + SPLIT_HEAD_DIMS))
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    if max(b * h, tq, tk) >= 2 ** 31 or (max(tq, tk) + 63) // 64 > 65535:
        raise ValueError("%s: shape exceeds the kernels' grid" % what)
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in tensors)


def split_dims(d, dv):
    """Whether q's and k's head dim ``d`` and v's ``dv`` are the split dims
    the kernels take (the forward's and dq's <192, 128> templates, dk/dv's
    split wgmma kernel): ``d`` in (128, 192], ``dv`` up to 128."""
    return MAX_HEAD_DIM < d <= SPLIT_HEAD_DIMS[0] and \
        1 <= dv <= SPLIT_HEAD_DIMS[1]


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _options(causal, scale, window, dropout_rate, seed):
    rate = float(dropout_rate)
    return [float(scale), int(bool(causal)), int(window or 0),
            int(rate > 0.0), keep_threshold(rate) if rate > 0.0 else 0,
            1.0 / (1.0 - rate), int(seed or 0) & _M32]


def _launch(name, counter, args):
    lib = kernels.load_library("attention", _bind)
    err = getattr(lib, "tinynn_attention_" + name)(*args)
    if err != 0:
        raise RuntimeError("attention %s kernel launch failed: CUDA error %d"
                           % (name, err))
    counter.launches += 1


def cuda_attention_forward(q, k, v, causal, scale, window=None,
                           dropout_rate=0.0, seed=None):
    """(o, lse) through the forward kernel. q [B,H,Tq,d_qk], k
    [B,Hkv,Tk,d_qk] and v [B,Hkv,Tk,d_v] float32 CUDA tensors (any strides
    with a unit-stride head dim, e.g. the transposed views of split heads);
    o is [B,H,Tq,d_v]; window/causal/dropout as in mha_fwd.
    ``cuda_attention_forward.launches`` counts the launches,
    ``.split_launches`` those at d_qk != d_v."""
    q, k, v = _operands("cuda_attention_forward", q, k, v)
    b, h, tq, d = q.shape
    hkv, tk, dv = k.shape[1], k.shape[2], v.shape[-1]
    o = torch.empty((b, h, tq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch("forward", cuda_attention_forward,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, h, hkv, tq, tk, d, dv]
            + _strides(q, k, v)
            + _options(causal, scale, window, dropout_rate, seed) + [stream])
    cuda_attention_forward.split_launches += dv != d
    return o, lse


cuda_attention_forward.launches = 0
cuda_attention_forward.split_launches = 0


def _backward_operands(what, q, k, v, do, lse, delta):
    q, k, v, do = _operands(what, q, k, v, do)
    b, h, tq, _ = q.shape
    return (q, k, v, do, lse.reshape(b, h, tq).contiguous(),
            delta.reshape(b, h, tq).contiguous())


def dq_design(d, dv=None):
    """The dq kernel's design at head dim ``d`` (v's ``dv``, d's by
    default): ``"wgmma"`` (the warp-specialised kernel on Hopper's
    warpgroup products) for d in 65-128, ``"mma"`` (the ``mma.sync``
    templates of d <= 32 and d <= 64, and of the split dims) otherwise. The
    wrapper hands the answer to the C entry point, which launches by it,
    and counts by it."""
    return "wgmma" if 64 < d <= MAX_HEAD_DIM and dv in (None, d) else "mma"


def cuda_attention_backward_dq(q, k, v, do, lse, delta, causal, scale,
                               window=None, dropout_rate=0.0, seed=None):
    """dq [B,H,Tq,d_qk] through the dq kernel (do [B,H,Tq,d_v]); ``delta``
    is rowsum(dO * O) [B,H,Tq]; ``dq_design(d_qk, d_v)`` picks the kernel.
    ``cuda_attention_backward_dq.launches`` counts the launches,
    ``.wgmma_launches`` those of the wgmma design, ``.split_launches`` those
    at d_qk != d_v."""
    q, k, v, do, lse, delta = _backward_operands(
        "cuda_attention_backward_dq", q, k, v, do, lse, delta)
    b, h, tq, d = q.shape
    hkv, tk, dv = k.shape[1], k.shape[2], v.shape[-1]
    dq = torch.empty((b, h, tq, d), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq
    stream = torch.cuda.current_stream(q.device).cuda_stream
    wgmma = dq_design(d, dv) == "wgmma"
    _launch("backward_dq", cuda_attention_backward_dq,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             b, h, hkv, tq, tk, d, dv]
            + _strides(q, k, v, do)
            + _options(causal, scale, window, dropout_rate, seed)
            + [int(wgmma), stream])
    cuda_attention_backward_dq.wgmma_launches += wgmma
    cuda_attention_backward_dq.split_launches += dv != d
    return dq


cuda_attention_backward_dq.launches = 0
cuda_attention_backward_dq.wgmma_launches = 0
cuda_attention_backward_dq.split_launches = 0


def dkv_design(d, dv=None):
    """The dk/dv kernel's design at head dim ``d`` (v's ``dv``, d's by
    default): ``"wgmma"`` (the warp-specialised kernels on Hopper's
    warpgroup products) for d in 65-128 and at the split dims, ``"mma"``
    (the ``mma.sync`` templates of d <= 32 and d <= 64) otherwise. The
    wrapper hands the answer to the C entry point, which launches by it,
    and counts by it."""
    if dv not in (None, d):
        return "wgmma" if split_dims(d, dv) else "mma"
    return "wgmma" if 64 < d <= MAX_HEAD_DIM else "mma"


def cuda_attention_backward_dkv(q, k, v, do, lse, delta, causal, scale,
                                window=None, dropout_rate=0.0, seed=None):
    """(dk [B,Hkv,Tk,d_qk], dv [B,Hkv,Tk,d_v]) through the dk/dv kernel,
    each kv head summed over its group of query heads inside the kernel;
    ``dkv_design(d_qk, d_v)`` picks the kernel.
    ``cuda_attention_backward_dkv.launches`` counts the launches,
    ``.wgmma_launches`` those of the wgmma design, ``.split_launches`` those
    at d_qk != d_v."""
    q, k, v, do, lse, delta = _backward_operands(
        "cuda_attention_backward_dkv", q, k, v, do, lse, delta)
    b, h, tq, d = q.shape
    hkv, tk, d_v = k.shape[1], k.shape[2], v.shape[-1]
    dk = torch.empty((b, hkv, tk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, hkv, tk, d_v), dtype=torch.float32, device=q.device)
    if dk.numel() == 0 or tq == 0:
        return dk.zero_(), dv.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    wgmma = dkv_design(d, d_v) == "wgmma"
    _launch("backward_dkv", cuda_attention_backward_dkv,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, hkv, tq, tk, d, d_v]
            + _strides(q, k, v, do)
            + _options(causal, scale, window, dropout_rate, seed)
            + [int(wgmma), stream])
    cuda_attention_backward_dkv.wgmma_launches += wgmma
    cuda_attention_backward_dkv.split_launches += d_v != d
    return dk, dv


cuda_attention_backward_dkv.launches = 0
cuda_attention_backward_dkv.wgmma_launches = 0
cuda_attention_backward_dkv.split_launches = 0


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _check(q, k, v, causal, window, dropout_rate):
    """Validates the call; returns the normalised window."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError("attention needs q [B,H,Tq,d_qk], k [B,Hkv,Tk,d_qk] "
                         "and v [B,Hkv,Tk,d_v] (k's batch, heads and keys), "
                         "got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, h, t, d = q.shape
    window = _norm_window(window, causal, t)
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("q %s and k %s differ in batch or head dim"
                         % (tuple(q.shape), tuple(k.shape)))
    hkv = k.shape[1]
    if hkv < 1 or h % hkv:
        raise ValueError("GQA needs kv heads (%d) to divide query heads (%d)"
                         % (hkv, h))
    if causal and k.shape[2] != t:
        raise ValueError("causal attention requires Tq == Tk, got %d vs %d"
                         % (t, k.shape[2]))
    if not 0.0 <= float(dropout_rate) < 1.0:
        raise ValueError("dropout_rate must be in [0, 1), got %r"
                         % (dropout_rate,))
    return window


def _use_kernels(impl, q):
    if impl not in (None, "plain"):
        raise ValueError("impl must be None (the tensors' device decides) or "
                         "'plain', got %r" % (impl,))
    return impl is None and q.is_cuda


def mha_fwd(q, k, v, causal=False, scale=None, impl=None, dropout_rate=0.0,
            dropout_seed=None, window=None):
    """softmax(Q K^T * scale [+ causal/window mask]) V. Q: [B, H, Tq, d_qk];
    K: [B, Hkv, Tk, d_qk]; V: [B, Hkv, Tk, d_v] (d_v == d_qk <= 128 on the
    kernels, or d_qk in (128, 192] with d_v <= 128; any pair on the plain
    version). Returns (o [B,H,Tq,d_v], lse [B,H,Tq,1] f32), lse being the
    row logsumexp of the scaled scores that mha_bwd consumes.
    ``dropout_seed`` is a uint32; None counts as 0 (under GQA the JAX
    package then gives every group seed 0, while here group gi still adds
    gi * 2654435761, as it does for any given seed)."""
    window = _check(q, k, v, causal, window, dropout_rate)
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    rate = float(dropout_rate)
    fn = (cuda_attention_forward if _use_kernels(impl, q)
          else attention_forward_reference)
    return fn(q, k, v, causal, scale, window=window, dropout_rate=rate,
              seed=dropout_seed)


def mha_bwd(q, k, v, o, lse, do, causal=False, scale=None, impl=None,
            dropout_rate=0.0, dropout_seed=None, window=None):
    """The VJP of mha_fwd (recompute scheme): (dq [B,H,Tq,d_qk], dk
    [B,Hkv,Tk,d_qk], dv [B,Hkv,Tk,d_v]). Pass the forward's dropout rate,
    seed and window: the masks are recomputed, never stored."""
    window = _check(q, k, v, causal, window, dropout_rate)
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    rate = float(dropout_rate)
    delta = (do.float() * o.float()).sum(dim=-1)  # [B, H, Tq]
    kw = dict(window=window, dropout_rate=rate, seed=dropout_seed)
    if _use_kernels(impl, q):
        dq = cuda_attention_backward_dq(q, k, v, do, lse, delta, causal,
                                        scale, **kw)
        dk, dv = cuda_attention_backward_dkv(q, k, v, do, lse, delta, causal,
                                             scale, **kw)
        return dq, dk, dv
    return attention_backward_reference(q, k, v, do, lse, delta, causal,
                                        scale, **kw)
