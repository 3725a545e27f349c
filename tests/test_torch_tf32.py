"""The 3xTF32 arithmetic of the attention kernels, held on the CPU:
``ops/tf32.py``'s rounding against an independent float64 reference, the
split's reach, the 3-term product against float64 at the attention's
products (where plain TF32 must miss the f32 gate), and the attention
forward and backward built from ``matmul_3xtf32`` against the JAX package's
``mha_fwd`` and ``mha_bwd`` (Pallas kernels in interpret mode, as
``tests/test_torch_attention.py`` runs them), the forward also against
float64.

Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinynn_autograd_tpu.ops import attention as jattn

from tinynn_autograd_tpu_torch.ops import attention, tf32

torch.set_num_threads(1)

# the attention backward's gates on the card: rtol 1e-4 and an atol of 1e-4
# of the largest float64 value
GATE_RTOL = 1e-4
GATE_ATOL = 1e-4
# against the JAX package: f32 sums in other orders (test_torch_attention.py)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
BWD_TOL = dict(rtol=1e-5, atol=1e-5)
# against float64: the 3xTF32 forward within F64_FACTOR times the f32 plain
# version's max error, as chip_smoke.py holds the kernel; plain TF32 past it
F64_FACTOR = 4.0

# test_torch_attention.py's cases: (B, H, Hkv, Tq, Tk, d, causal, window,
# dropout rate)
CASES = {"noncausal": (2, 2, 2, 32, 32, 8, False, None, 0.0),
         "causal": (2, 2, 2, 32, 32, 8, True, None, 0.0),
         "window": (1, 2, 2, 48, 48, 8, True, 5, 0.0),
         "cross": (2, 2, 2, 16, 48, 8, False, None, 0.0),
         "gqa": (2, 4, 2, 32, 32, 8, True, None, 0.0),
         "dropout": (2, 2, 2, 32, 32, 8, True, None, 0.1),
         "gqa_dropout": (1, 4, 2, 32, 32, 16, False, None, 0.1)}
SEED = 1234


def _f32(bits):
    return torch.tensor(np.array(bits, np.uint32).view(np.float32))


def _bits_of(x):
    return x.numpy().view(np.uint32)


def _nearest_tf32(x):
    """An independent reference: of the two TF32 neighbours of each finite
    f32 (its bits cut towards zero, and one TF32 unit further from zero),
    the nearer in float64, a tie going away from zero."""
    bits = x.view(np.uint32)
    low = (bits & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    high = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(
        np.float32).astype(np.float64)
    xd = x.astype(np.float64)
    pick_high = np.abs(high - xd) <= np.abs(xd - low)
    return np.where(pick_high, high, low).astype(np.float32)


# --------------------------------------------------------------------------
# the rounding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits,want", [
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),   # its negative: away from zero too
    (0x3F800FFF, 0x3F800000),   # just below the tie
    (0x3F803000, 0x3F804000),   # a tie above an odd TF32 value
    (0x3F9FF000, 0x3FA00000),   # a carry into the next mantissa
    (0x3FFFF000, 0x40000000),   # a carry into the exponent
    (0x7F7FE000, 0x7F7FE000),   # the largest finite TF32 value
    (0x7F7FFFFF, 0x7F800000),   # the largest finite f32: to inf
    (0xFF7FFFFF, 0xFF800000),   # and its negative to -inf
    (0x00000FFF, 0x00000000),   # a subnormal below half a TF32 unit
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x007FF000, 0x00800000),   # the largest subnormals: the least normal
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0 keeps its sign
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
])
def test_round_tf32_at_the_edges(bits, want):
    got = tf32.round_tf32(_f32([bits]))
    assert _bits_of(got)[0] == want


def test_round_tf32_keeps_nan():
    x = _f32([0x7FC00000, 0xFFC00001, 0x7F800001])
    assert torch.isnan(tf32.round_tf32(x)).all()


def test_round_tf32_matches_the_nearest_tf32_over_random_bits():
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2 ** 32, size=200_000, dtype=np.uint64).astype(
        np.uint32)
    exponent = (bits >> 23) & 0xFF
    bits = bits[exponent < 0xFE]  # finite, and no carry to inf
    x = bits.view(np.float32)
    got = tf32.round_tf32(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _nearest_tf32(x).view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()


def test_truncate_and_split():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(
        (rng.randn(100_000) * np.exp(rng.uniform(-30, 30, 100_000)))
        .astype(np.float32))
    cut = tf32.truncate_tf32(x)
    assert (cut.abs() <= x.abs()).all()
    assert not (_bits_of(cut) & 0x1FFF).any()
    hi, lo = tf32.split_tf32(x)
    assert not (_bits_of(hi) & 0x1FFF).any()
    assert not (_bits_of(lo) & 0x1FFF).any()
    assert torch.equal(hi, tf32.round_tf32(x))
    # hi + lo holds x to within 2^-21 of |x| (lo cut towards zero at its
    # 11th significant bit); hi alone only to 2^-11
    xd = x.double()
    err = (hi.double() + lo.double() - xd).abs()
    assert (err <= 2.0 ** -21 * xd.abs()).all()
    assert float((err / xd.abs()).max()) < 2.0 ** -21
    assert float(((hi.double() - xd).abs() / xd.abs()).max()) > 2.0 ** -13


# --------------------------------------------------------------------------
# the products
# --------------------------------------------------------------------------

def _products(seed=0, t=256, d=64):
    """The attention backward's five products at one head: S = Q K^T and
    dP = dO V^T over the head dim, dQ = dS K, dK = dS^T Q and dV = P^T dO
    over the sequence, on float64-exact operands."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(t, d).astype(np.float32))
                   for _ in range(4))
    s = (q.double() @ k.double().T) / np.sqrt(d)
    p = torch.softmax(s, dim=-1)
    dp = do.double() @ v.double().T
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / np.sqrt(d)
    p, ds = p.float(), ds.float()
    return {"S": (q, k.T), "dP": (do, v.T), "dQ": (ds, k),
            "dK": (ds.T, q), "dV": (p.T, do)}


def _gate_miss(got, a, b):
    """How far ``got`` is past the f32 gate against a @ b in float64 (<= 1
    passes): max over elements of |got - want| / (atol + rtol |want|)."""
    want = a.double() @ b.double()
    atol = GATE_ATOL * float(want.abs().max())
    return float(((got.double() - want).abs()
                  / (atol + GATE_RTOL * want.abs())).max())


@pytest.mark.parametrize("name", ["S", "dP", "dQ", "dK", "dV"])
def test_3xtf32_meets_the_f32_gate_and_tf32_misses_it(name):
    a, b = _products()[name]
    assert _gate_miss(tf32.matmul_3xtf32(a, b), a, b) <= 1.0
    assert _gate_miss(tf32.matmul_tf32(a, b), a, b) > 1.0


def test_3xtf32_error_is_near_f32s():
    # at the products' float64 error: within 4x f32's own, TF32's far past
    for name, (a, b) in _products(seed=3).items():
        want = a.double() @ b.double()
        errs = [float((f(a, b).double() - want).abs().max())
                for f in (tf32.matmul_3xtf32, torch.matmul, tf32.matmul_tf32)]
        assert errs[0] <= 4.0 * errs[1], (name, errs)
        assert errs[2] > 4.0 * errs[1], (name, errs)


# --------------------------------------------------------------------------
# the attention backward in 3xTF32 against the JAX package
# --------------------------------------------------------------------------

def _inputs(name, seed=0):
    b, h, hkv, tq, tk, d, causal, window, rate = CASES[name]
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*shape).astype(np.float32) for shape in (
        (b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d), (b, h, tq, d))]
    kw = dict(causal=causal, scale=0.3, window=window, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    return arrays, kw


@pytest.fixture(params=["pallas_interpret", "pallas_gridded"])
def jax_impl(request, monkeypatch):
    """The JAX Pallas kernels in interpret mode: at their default routing
    (the whole-plane forms at these sizes) and, with 16-row tiles, the
    gridded ones."""
    if request.param == "pallas_gridded":
        monkeypatch.setattr(jattn, "_BLOCK", 16)
        monkeypatch.setattr(jattn, "_SINGLE_MAX_T", 8)
    return "pallas_interpret"


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_backward_matches_jax(name, jax_impl):
    (q, k, v, do), kw = _inputs(name)
    jo, jlse = jattn.mha_fwd(*map(jnp.asarray, (q, k, v)), impl=jax_impl,
                             **kw)
    want = jattn.mha_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                         jnp.asarray(do), impl=jax_impl, **kw)
    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jlse))
    delta = (tdo * o).sum(dim=-1)
    got = attention.attention_backward_reference(
        tq_, tk_, tv_, tdo, lse, delta, kw["causal"], kw["scale"],
        window=attention._norm_window(kw["window"], kw["causal"],
                                      q.shape[2]),
        dropout_rate=kw["dropout_rate"], seed=kw["dropout_seed"],
        product=tf32.matmul_3xtf32)
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what,
                                   **BWD_TOL)


# --------------------------------------------------------------------------
# the attention forward in 3xTF32
# --------------------------------------------------------------------------

def _forward(q, k, v, kw, product):
    return attention.attention_forward_reference(
        q, k, v, kw["causal"], kw["scale"],
        window=attention._norm_window(kw["window"], kw["causal"],
                                      q.shape[2]),
        dropout_rate=kw["dropout_rate"], seed=kw["dropout_seed"],
        product=product)


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_forward_matches_jax(name, jax_impl):
    (q, k, v, _), kw = _inputs(name)
    jo, jlse = jattn.mha_fwd(*map(jnp.asarray, (q, k, v)), impl=jax_impl,
                             **kw)
    o, lse = _forward(*map(torch.from_numpy, (q, k, v)), kw,
                      tf32.matmul_3xtf32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), err_msg="o",
                               **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), err_msg="lse",
                               **FWD_TOL)


def test_3xtf32_forward_error_is_near_f32s():
    # one causal head pair at T=256, d=64: o and lse against float64 within
    # F64_FACTOR times the f32 plain version's error; plain TF32's past it
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32))
               for _ in range(3))
    kw = dict(causal=True, scale=1.0 / 8.0, window=None, dropout_rate=0.0,
              dropout_seed=None)
    exact = _forward(q.double(), k.double(), v.double(), kw, torch.matmul)
    errs = {}
    for name, product in (("3xtf32", tf32.matmul_3xtf32),
                          ("f32", torch.matmul), ("tf32", tf32.matmul_tf32)):
        got = _forward(q, k, v, kw, product)
        errs[name] = [float((a.double() - b).abs().max())
                      for a, b in zip(got, exact)]
    for i, what in enumerate(("o", "lse")):
        assert errs["3xtf32"][i] <= F64_FACTOR * errs["f32"][i], (what, errs)
        assert errs["tf32"][i] > F64_FACTOR * errs["f32"][i], (what, errs)


def test_forward_reference_default_product_is_unchanged():
    # the default keeps the einsum: bit for bit what it computed before
    (q, k, v, _), kw = _inputs("gqa_dropout")
    q, k, v = map(torch.from_numpy, (q, k, v))
    o, lse = _forward(q, k, v, kw, torch.matmul)
    s = attention._masked_scores(q, k, kw["causal"], kw["scale"], None)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = attention._keep_mask(SEED, 1, 4, 2, 32, 32, 0.1, None)
    p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - 0.1))
    want = torch.einsum("bhqk,bhkd->bhqd", p,
                        v.repeat_interleave(2, dim=1)) / l
    assert torch.equal(o, want) and torch.equal(lse, m + torch.log(l))
