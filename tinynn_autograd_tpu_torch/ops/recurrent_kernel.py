"""The recurrent kernels: the LSTM and GRU time loops, forward and backward,
as CUDA kernels on the GPU and their plain PyTorch versions on the CPU.

PyTorch counterpart of the JAX package's ops/recurrent_kernel.py. Each
function takes the hoisted input projection (or the output cotangent) over
all T steps and runs the serial part of one layer in one direction:

    LSTM forward   xp [T,B,4H], wh [H,4H], h0, c0 [B,H]
                   -> hs, cs [T,B,H], gates (i, f, g, o) [T,B,4H]
    LSTM backward  gt, cs, cprev [T,B,H], gates [T,B,4H], whT [4H,H]
                   -> dzs [T,B,4H], dh0, dc0 [B,H]
    GRU forward    ap [T,B,3H], wh [H,3H], h0 [B,H]
                   -> hs [T,B,H], gates (z, r, n) [T,B,3H], un [T,B,H]
    GRU backward   gt, hprev, un [T,B,H], gates [T,B,3H], whT [3H,H]
                   -> das, dus [T,B,3H], dh0 [B,H]

``reverse=True`` runs a backward-in-time cell (the forward walks t from T-1
down to 0, its backward from 0 up).

On a CUDA device the ``cuda_*`` wrappers launch the kernels of
``csrc/recurrent.cu``: one launch per layer and direction, a thread block
cluster splitting the hidden units so that each block keeps its share of wh
in shared memory (see the source). ``plan`` is the H100 shape rule: it picks
the cluster size and the batch rows a cluster takes (as many clusters as
the card holds at once, by the kernels' occupancy query), and raises
``ValueError`` for an H whose share does not fit (H > 328 for the LSTM, 384
for the GRU). The ``*_reference`` functions are the same arithmetic as a
Python loop over time in plain PyTorch (the hidden product is
``torch.matmul``); they serve CPU tensors and the checks on the card, and a
CUDA tensor never falls back to them.
"""

import functools

import torch

from tinynn_autograd_tpu_torch.ops import kernels

THREADS = 256
MAX_KPARTS = 8
SMEM_LIMIT = 232448  # shared memory a block may use (227 KB)
CLUSTERS = (1, 2, 4, 8)
MAX_ROWS = 8  # the kernels are built for 1 to 8 batch rows a cluster
GATES = {"lstm": 4, "gru": 3}
# the kernels' phases, in the order of their ``phase_ns`` entries: the
# set-up once, then each step's phases in the order the kernel runs them
PHASES = {"forward": ("set-up", "product", "gates", "hand-off"),
          "backward": ("set-up", "gates", "hand-off", "product")}


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _order(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


def lstm_forward_reference(xp, wh, h0, c0, reverse=False):
    """(hs, cs [T,B,H], gates [T,B,4H]): the K5 recurrence, a step at a
    time (the JAX package's ``_fwd_kernel``)."""
    T, B, H4 = xp.shape
    H = H4 // 4
    hs = xp.new_empty((T, B, H))
    cs = xp.new_empty((T, B, H))
    gates = xp.new_empty((T, B, H4))
    h, c = h0, c0
    for t in _order(T, reverse):
        z = xp[t] + torch.matmul(h, wh)
        ig = torch.sigmoid(z[:, :H])
        fg = torch.sigmoid(z[:, H:2 * H])
        gg = torch.tanh(z[:, 2 * H:3 * H])
        og = torch.sigmoid(z[:, 3 * H:])
        c = fg * c + ig * gg
        h = og * torch.tanh(c)
        gates[t] = torch.cat([ig, fg, gg, og], dim=-1)
        cs[t] = c
        hs[t] = h
    return hs, cs, gates


def lstm_backward_reference(gt, gates, cs, cprev, whT, reverse=False):
    """(dzs [T,B,4H], dh0, dc0 [B,H]): the K5b reverse recurrence carrying
    (dh, dc) (the JAX package's ``_bwd_kernel``)."""
    T, B, H = gt.shape
    dzs = gt.new_empty((T, B, 4 * H))
    dh = gt.new_zeros((B, H))
    dc = gt.new_zeros((B, H))
    for t in _order(T, not reverse):
        g4 = gates[t]
        ig, fg = g4[:, :H], g4[:, H:2 * H]
        gg, og = g4[:, 2 * H:3 * H], g4[:, 3 * H:]
        tc = torch.tanh(cs[t])
        dht = gt[t] + dh
        do = dht * tc
        dct = dht * og * (1.0 - tc * tc) + dc
        di = dct * gg
        dg = dct * ig
        df = dct * cprev[t]
        dz = torch.cat([di * ig * (1.0 - ig),
                        df * fg * (1.0 - fg),
                        dg * (1.0 - gg * gg),
                        do * og * (1.0 - og)], dim=-1)
        dzs[t] = dz
        dh = torch.matmul(dz, whT)
        dc = dct * fg
    return dzs, dh, dc


def gru_forward_reference(ap, wh, h0, reverse=False):
    """(hs [T,B,H], gates (z, r, n) [T,B,3H], un [T,B,H]): the K5c
    recurrence (the JAX package's ``_gru_fwd_kernel``); the reset gate
    multiplies the hidden contribution un = (h @ wh)_n."""
    T, B, H3 = ap.shape
    H = H3 // 3
    hs = ap.new_empty((T, B, H))
    gates = ap.new_empty((T, B, H3))
    un_s = ap.new_empty((T, B, H))
    h = h0
    for t in _order(T, reverse):
        u = torch.matmul(h, wh)
        a = ap[t]
        z = torch.sigmoid(a[:, :H] + u[:, :H])
        r = torch.sigmoid(a[:, H:2 * H] + u[:, H:2 * H])
        un = u[:, 2 * H:]
        n = torch.tanh(a[:, 2 * H:] + r * un)
        h = (1.0 - z) * n + z * h
        gates[t] = torch.cat([z, r, n], dim=-1)
        un_s[t] = un
        hs[t] = h
    return hs, gates, un_s


def gru_backward_reference(gt, hprev, gates, un, whT, reverse=False):
    """(das, dus [T,B,3H], dh0 [B,H]): the K5d reverse recurrence carrying
    dh (the JAX package's ``_gru_bwd_kernel``)."""
    T, B, H = gt.shape
    das = gt.new_empty((T, B, 3 * H))
    dus = gt.new_empty((T, B, 3 * H))
    dh = gt.new_zeros((B, H))
    for t in _order(T, not reverse):
        g3 = gates[t]
        z, r, n = g3[:, :H], g3[:, H:2 * H], g3[:, 2 * H:]
        dht = gt[t] + dh
        dz_gate = dht * (hprev[t] - n)
        dn_pre = dht * (1.0 - z) * (1.0 - n * n)
        dr = dn_pre * un[t]
        dun = dn_pre * r
        daz = dz_gate * z * (1.0 - z)
        dar = dr * r * (1.0 - r)
        das[t] = torch.cat([daz, dar, dn_pre], dim=-1)
        du = torch.cat([daz, dar, dun], dim=-1)
        dus[t] = du
        dh = dht * z + torch.matmul(du, whT)
    return das, dus, dh


# --------------------------------------------------------------------------
# the H100 shape rule
# --------------------------------------------------------------------------

def _round4(x):
    return (x + 3) // 4 * 4


def _layout(H, G, backward, cluster, rows):
    """(units a block owns, bytes of shared memory a block uses): the
    kernels' ``layout`` in csrc/recurrent.cu."""
    units = -(-H // cluster)
    depth = _round4(G * H if backward else H)
    cols = units if backward else G * units
    kparts = min(MAX_KPARTS, max(1, THREADS // cols))
    floats = depth * cols + 2 * rows * depth + kparts * rows * cols
    return units, 4 * floats


def plan(cell, backward, B, H, max_clusters):
    """(cluster size, batch rows a cluster takes) of one launch:
    the fewest blocks a cluster whose shares of wh fit shared memory, then
    the fewest rows a cluster (1 to 8, at most 256 (row, unit) pairs a
    block) whose clusters the card holds at once, ``max_clusters(cluster,
    rows)`` of them (the kernels' occupancy query on the card); the most
    rows when no count of rows keeps the launch in one wave.
    Raises ValueError for an H beyond ``max_hidden``, where a cluster of 8
    blocks cannot hold the forward's or the backward's shares of wh, so
    that a layer the backward cannot train does not run forward either."""
    G = GATES[cell]
    if not supports(cell, H):
        raise ValueError(
            "the %s kernels cannot hold H=%d: wh's shares in a cluster of %d "
            "blocks need %d (forward) and %d (backward) bytes of shared "
            "memory a block, which may use %d (H <= %d)"
            % (cell, H, CLUSTERS[-1],
               _layout(H, G, False, CLUSTERS[-1], 1)[1],
               _layout(H, G, True, CLUSTERS[-1], 1)[1], SMEM_LIMIT,
               max_hidden(cell)))
    for cluster in CLUSTERS:
        units, smem = _layout(H, G, backward, cluster, 1)
        if units > THREADS or smem > SMEM_LIMIT:
            continue
        feasible = [rows for rows in range(1, MAX_ROWS + 1)
                    if rows * units <= THREADS
                    and _layout(H, G, backward, cluster, rows)[1]
                    <= SMEM_LIMIT]
        for rows in feasible:
            if -(-B // rows) <= max_clusters(cluster, rows):
                return cluster, rows
        return cluster, feasible[-1]
    raise AssertionError("no cluster holds H=%d within max_hidden" % H)


def supports(cell, H):
    """True when both kernels of ``cell`` take hidden width H."""
    return 1 <= H <= max_hidden(cell)


@functools.lru_cache(maxsize=None)
def max_hidden(cell):
    """The largest H whose forward and backward shares fit a cluster of 8."""
    G = GATES[cell]
    H = 1
    while all(_layout(H + 1, G, bw, CLUSTERS[-1], 1)[1] <= SMEM_LIMIT
              for bw in (False, True)):
        H += 1
    return H


_MAX_CLUSTERS = {}


def _max_clusters(cell, backward, H, cluster, rows, device):
    """The kernels' occupancy query: how many clusters of this plan the
    card holds at once (cached)."""
    key = (cell, backward, H, cluster, rows, str(device))
    if key not in _MAX_CLUSTERS:
        import ctypes

        lib = kernels.load_library("recurrent", _bind)
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.tinynn_recurrent_max_clusters(
                int(cell == "gru"), int(backward), H, cluster, rows,
                ctypes.byref(out))
        if err != 0:
            raise RuntimeError("the recurrent kernels' occupancy query "
                               "failed: CUDA error %d" % err)
        _MAX_CLUSTERS[key] = out.value
    return _MAX_CLUSTERS[key]


def plan_on(cell, backward, B, H, device):
    """``plan`` with the card's own occupancy."""
    return plan(cell, backward, B, H,
                lambda cluster, rows: _max_clusters(cell, backward, H,
                                                    cluster, rows, device))


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _bind(lib, ctypes):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tail = [I] * 6 + [P, P]  # T, B, H, reverse, cluster, rows, phase_ns,
    #                          stream
    signatures = {
        "lstm_forward": [P, P, L, L] + [P] * 5,
        "lstm_backward": [P] * 5 + [L, L] + [P] * 3,
        "gru_forward": [P, P, L, L] + [P] * 4,
        "gru_backward": [P] * 5 + [L, L] + [P] * 3,
    }
    for name, head in signatures.items():
        fn = getattr(lib, "tinynn_" + name)
        fn.argtypes = head + tail
        fn.restype = ctypes.c_int
    lib.tinynn_recurrent_max_clusters.argtypes = [I] * 5 + [P]
    lib.tinynn_recurrent_max_clusters.restype = ctypes.c_int


def _checked(what, tensors, shapes):
    """Checks device, type and shape of each tensor against ``shapes``."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("%s needs CUDA tensors, got %s" % (
            what, ", ".join(str(t.device) for t in tensors)))
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("%s: operands on different devices" % what)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("%s takes float32 tensors (the kernels run f32 "
                         "FMA), got %s" % (what, sorted({str(t.dtype)
                                                         for t in tensors})))
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s: operand of shape %s, expected %s"
                             % (what, tuple(t.shape), tuple(shape)))
    if max(t.numel() for t in tensors) >= 2 ** 31:
        raise ValueError("%s: shape exceeds the kernels' 32-bit sizes" % what)


def _launch(name, counter, T, B, H, reverse, operands, outputs, phase_ns):
    """Launches ``tinynn_<name>`` on ``operands`` (contiguous but wh or
    whT, which is read through its strides) and ``outputs``, unless there
    is nothing to compute."""
    cell, direction = name.split("_")
    backward = direction == "backward"
    if any(t.numel() == 0 for t in outputs):
        return
    device = outputs[0].device
    if phase_ns is not None and (
            phase_ns.device != device or phase_ns.dtype != torch.int64
            or tuple(phase_ns.shape) != (len(PHASES[direction]),)):
        raise ValueError("phase_ns must be an int64 [%d] tensor on %s"
                         % (len(PHASES[direction]), device))
    cluster, rows = plan_on(cell, backward, B, H, device)
    w_at = 4 if backward else 1
    w = operands[w_at]
    args = [t.data_ptr() for t in operands + outputs]
    args[w_at + 1:w_at + 1] = [w.stride(0), w.stride(1)]
    lib = kernels.load_library("recurrent", _bind)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, "tinynn_" + name)(
        *args, T, B, H, int(bool(reverse)), cluster, rows,
        None if phase_ns is None else phase_ns.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("recurrent %s kernel launch failed: CUDA error %d"
                           % (name, err))
    counter.launches += 1


def cuda_lstm_forward(xp, wh, h0, c0, reverse=False, phase_ns=None):
    """``lstm_forward_reference`` through K5, on float32 CUDA tensors (wh in
    any strides). ``phase_ns``, an int64 CUDA tensor [4], accumulates the
    launch's time by phase (``PHASES``). ``cuda_lstm_forward.launches``
    counts the launches."""
    T, B, H4 = xp.shape
    H = H4 // 4
    _checked("cuda_lstm_forward", [xp, wh, h0, c0],
             [(T, B, 4 * H), (H, 4 * H), (B, H), (B, H)])
    hs = xp.new_empty((T, B, H))
    cs = xp.new_empty((T, B, H))
    gates = xp.new_empty((T, B, 4 * H))
    # the contiguous copies stay alive until the launch is queued
    operands = [xp.contiguous(), wh, h0.contiguous(), c0.contiguous()]
    _launch("lstm_forward", cuda_lstm_forward, T, B, H, reverse, operands,
            [hs, cs, gates], phase_ns)
    return hs, cs, gates


cuda_lstm_forward.launches = 0


def cuda_lstm_backward(gt, gates, cs, cprev, whT, reverse=False,
                       phase_ns=None):
    """``lstm_backward_reference`` through K5b (whT in any strides, e.g. the
    transposed view of wh; ``phase_ns`` as in cuda_lstm_forward).
    ``cuda_lstm_backward.launches`` counts the launches."""
    T, B, H = gt.shape
    _checked("cuda_lstm_backward", [gt, gates, cs, cprev, whT],
             [(T, B, H), (T, B, 4 * H), (T, B, H), (T, B, H), (4 * H, H)])
    dzs = gt.new_empty((T, B, 4 * H))
    dh0 = gt.new_zeros((B, H))
    dc0 = gt.new_zeros((B, H))
    if T == 0:
        return dzs, dh0, dc0
    operands = [gt.contiguous(), gates.contiguous(), cs.contiguous(),
                cprev.contiguous(), whT]
    _launch("lstm_backward", cuda_lstm_backward, T, B, H, reverse, operands,
            [dzs, dh0, dc0], phase_ns)
    return dzs, dh0, dc0


cuda_lstm_backward.launches = 0


def cuda_gru_forward(ap, wh, h0, reverse=False, phase_ns=None):
    """``gru_forward_reference`` through K5c (wh in any strides; ``phase_ns``
    as in cuda_lstm_forward). ``cuda_gru_forward.launches`` counts the
    launches."""
    T, B, H3 = ap.shape
    H = H3 // 3
    _checked("cuda_gru_forward", [ap, wh, h0],
             [(T, B, 3 * H), (H, 3 * H), (B, H)])
    hs = ap.new_empty((T, B, H))
    gates = ap.new_empty((T, B, 3 * H))
    un = ap.new_empty((T, B, H))
    operands = [ap.contiguous(), wh, h0.contiguous()]
    _launch("gru_forward", cuda_gru_forward, T, B, H, reverse, operands,
            [hs, gates, un], phase_ns)
    return hs, gates, un


cuda_gru_forward.launches = 0


def cuda_gru_backward(gt, hprev, gates, un, whT, reverse=False,
                      phase_ns=None):
    """``gru_backward_reference`` through K5d (whT in any strides;
    ``phase_ns`` as in cuda_lstm_forward). ``cuda_gru_backward.launches``
    counts the launches."""
    T, B, H = gt.shape
    _checked("cuda_gru_backward", [gt, hprev, gates, un, whT],
             [(T, B, H), (T, B, H), (T, B, 3 * H), (T, B, H), (3 * H, H)])
    das = gt.new_empty((T, B, 3 * H))
    dus = gt.new_empty((T, B, 3 * H))
    dh0 = gt.new_zeros((B, H))
    if T == 0:
        return das, dus, dh0
    operands = [gt.contiguous(), hprev.contiguous(), gates.contiguous(),
                un.contiguous(), whT]
    _launch("gru_backward", cuda_gru_backward, T, B, H, reverse, operands,
            [das, dus, dh0], phase_ns)
    return das, dus, dh0


cuda_gru_backward.launches = 0
