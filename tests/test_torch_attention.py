"""The PyTorch package's attention against the JAX package's: the plain
``mha_fwd``/``mha_bwd`` against the JAX ``mha_fwd``/``mha_bwd`` through its
XLA path, its Pallas kernels in interpret mode at their default routing (the
whole-plane forms at these sizes) and, with the tile edge cut to 16, its
gridded kernels (K4's online-softmax forward, K4d's dq and dk/dv); the
dropout hash; ``flash_attention_`` on the tape; the errors.

Inputs come from numpy with a seed. Tolerances: o and lse at rtol 1e-5/atol
1e-6, dq/dk/dv at rtol 1e-5/atol 1e-5 (f32 sums in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinynn_autograd_tpu.ops import attention as jattn

from tinynn_autograd_tpu_torch import Tensor, ops
from tinynn_autograd_tpu_torch.ops import attention, kernels
from tinynn_autograd_tpu_torch.utils import seeder

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
BWD_TOL = dict(rtol=1e-5, atol=1e-5)

# (B, H, Hkv, Tq, Tk, d, causal, window, dropout rate)
CASES = {"noncausal": (2, 2, 2, 32, 32, 8, False, None, 0.0),
         "causal": (2, 2, 2, 32, 32, 8, True, None, 0.0),
         "window": (1, 2, 2, 48, 48, 8, True, 5, 0.0),
         "cross": (2, 2, 2, 16, 48, 8, False, None, 0.0),
         "gqa": (2, 4, 2, 32, 32, 8, True, None, 0.0),
         "dropout": (2, 2, 2, 32, 32, 8, True, None, 0.1),
         "gqa_dropout": (1, 4, 2, 32, 32, 16, False, None, 0.1)}
SEED = 1234


def _inputs(name, seed=0):
    b, h, hkv, tq, tk, d, causal, window, rate = CASES[name]
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*shape).astype(np.float32) for shape in (
        (b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d), (b, h, tq, d))]
    kw = dict(causal=causal, scale=0.3, window=window, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    return arrays, kw


@pytest.fixture(params=["xla", "pallas_interpret", "pallas_gridded"])
def jax_impl(request, monkeypatch):
    """The JAX implementation to hold the port against; "pallas_gridded"
    is interpret mode with 16-row tiles and the whole-plane forms off, so
    that the online-softmax forward and the gridded backward run."""
    if request.param == "pallas_gridded":
        monkeypatch.setattr(jattn, "_BLOCK", 16)
        monkeypatch.setattr(jattn, "_SINGLE_MAX_T", 8)
        return "pallas_interpret"
    return request.param


@pytest.mark.parametrize("name", sorted(CASES))
def test_mha_matches_jax(name, jax_impl):
    (q, k, v, do), kw = _inputs(name)
    jo, jlse = jattn.mha_fwd(*map(jnp.asarray, (q, k, v)), impl=jax_impl,
                             **kw)
    jgrads = jattn.mha_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                           jnp.asarray(do), impl=jax_impl, **kw)
    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tlse = attention.mha_fwd(tq_, tk_, tv_, **kw)
    assert to.shape == q.shape and tlse.shape == q.shape[:3] + (1,)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), err_msg="o",
                               **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               err_msg="lse", **FWD_TOL)
    # the backward from the JAX forward's o and lse, so that only the
    # backward is compared
    tgrads = attention.mha_bwd(tq_, tk_, tv_, torch.tensor(np.asarray(jo)),
                               torch.tensor(np.asarray(jlse)), tdo, **kw)
    for what, a, b, shape in zip(("dq", "dk", "dv"), tgrads, jgrads,
                                 (q.shape, k.shape, v.shape)):
        assert a.shape == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what,
                                   **BWD_TOL)


def test_gqa_dropout_seed_none_counts_as_zero():
    (q, k, v, _), kw = _inputs("gqa_dropout")
    args = tuple(map(torch.from_numpy, (q, k, v)))
    a, _ = attention.mha_fwd(*args, **dict(kw, dropout_seed=None))
    b, _ = attention.mha_fwd(*args, **dict(kw, dropout_seed=0))
    assert torch.equal(a, b)


def test_dropout_changes_the_result_and_replays():
    (q, k, v, _), kw = _inputs("dropout")
    args = tuple(map(torch.from_numpy, (q, k, v)))
    o1, _ = attention.mha_fwd(*args, **kw)
    o2, _ = attention.mha_fwd(*args, **kw)
    o3, _ = attention.mha_fwd(*args, **dict(kw, dropout_seed=SEED + 1))
    o0, _ = attention.mha_fwd(*args, **dict(kw, dropout_rate=0.0))
    assert torch.equal(o1, o2)
    assert not torch.allclose(o1, o3) and not torch.allclose(o1, o0)


# --------------------------------------------------------------------------
# the hash
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(0, 0.1), (2 ** 32 - 1, 0.5),
                                       (987654321, 0.9)])
def test_full_keep_mask_matches_jax(seed, rate):
    want = np.asarray(jattn._full_keep_mask(seed, 6, 40, 72, rate))
    got = attention.full_keep_mask(seed, 6, 40, 72, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs((1.0 - got.mean()) - rate) < 0.02


def test_tile_keep_mask_matches_jax_transposed_and_offset():
    thresh = attention.keep_threshold(0.3)
    assert thresh == int(jattn._keep_thresh(0.3))
    for q_axis in (1, 2):
        args = (77, 3, 16, 32, 2, 8, 24, 64, 96)
        want = np.asarray(jattn._tile_keep_mask(
            *args, jattn._keep_thresh(0.3), q_axis=q_axis))
        got = attention.tile_keep_mask(*args, thresh, q_axis=q_axis).numpy()
        np.testing.assert_array_equal(got, want)


def test_gqa_keep_mask_is_the_group_calls_mask():
    # query head h = kvh * group + gi hashes as the JAX group call gi does:
    # head index b * Hkv + kvh, seed + gi * 2654435761
    b, h, hkv, t = 2, 6, 2, 16
    got = attention._keep_mask(SEED, b, h, hkv, t, t, 0.3, "cpu").numpy()
    group = h // hkv
    for gi in range(group):
        want = np.asarray(jattn._full_keep_mask(
            jattn._group_seed(SEED, gi), b * hkv, t, t, 0.3))
        np.testing.assert_array_equal(
            got.reshape(b, hkv, group, t, t)[:, :, gi].reshape(-1, t, t),
            want)
    assert attention.group_seed(SEED, 1) == int(jattn._group_seed(SEED, 1))


# --------------------------------------------------------------------------
# the primitive on the tape
# --------------------------------------------------------------------------

def _tape_attention(q, k, v, causal, scale, window):
    scores = (q @ k.transpose((0, 1, 3, 2))) * scale
    if causal:
        mask = np.where(attention.band_mask(q.shape[2], window), 0.0,
                        -1e9).astype(np.float32)
        scores = scores + mask
    return ops.softmax_(scores, axis=-1) @ v


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 3)])
def test_flash_attention_tape_grads_match_the_tape_chain(causal, window):
    (q, k, v, do), _ = _inputs("causal", seed=3)
    results = []
    for fused in (True, False):
        ts = [Tensor(a, requires_grad=True) for a in (q, k, v)]
        if fused:
            out = ops.flash_attention_(*ts, causal=causal, scale=0.3,
                                       window=window)
        else:
            out = _tape_attention(*ts, causal, 0.3, window)
        out.backward(do)
        results.append([out.numpy()] + [t.grad.numpy() for t in ts])
    np.testing.assert_allclose(results[0][0], results[1][0], **FWD_TOL)
    for what, a, b in zip(("dq", "dk", "dv"), results[0][1:], results[1][1:]):
        np.testing.assert_allclose(a, b, err_msg=what, **BWD_TOL)


def test_flash_attention_memoises_one_backward(monkeypatch):
    (q, k, v, do), _ = _inputs("gqa")
    calls = []
    real = attention.mha_bwd
    monkeypatch.setattr(attention, "mha_bwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ts = [Tensor(a, requires_grad=True) for a in (q, k, v)]
    out = ops.flash_attention_(*ts, causal=True)
    out.backward(do)
    assert len(calls) == 1
    assert ts[1].grad.shape == k.shape
    # the same gradients as the JAX primitive
    from tinynn_autograd_tpu import Tensor as JTensor
    from tinynn_autograd_tpu import ops as jops

    jts = [JTensor(a, requires_grad=True) for a in (q, k, v)]
    jout = jops.flash_attention_(*jts, causal=True)
    jout.backward(JTensor(do))
    for a, b in zip(ts, jts):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b.grad),
                                   **BWD_TOL)


def test_flash_attention_dropout_seed():
    assert ops._attn_dropout_seed(0.0, 5) is None
    assert ops._attn_dropout_seed(0.1, 2 ** 32 + 5) == 5
    seeder.random_seed(4)
    a = ops._attn_dropout_seed(0.1, None)
    seeder.random_seed(4)
    assert ops._attn_dropout_seed(0.1, None) == a and 0 <= a < 2 ** 32
    with pytest.raises(TypeError):
        ops._attn_dropout_seed(0.1, "key")
    # an explicit seed gives the JAX primitive's output
    from tinynn_autograd_tpu import Tensor as JTensor
    from tinynn_autograd_tpu import ops as jops

    (q, k, v, _), _ = _inputs("dropout")
    got = ops.flash_attention_(*map(Tensor, (q, k, v)), causal=True,
                               dropout_rate=0.1, dropout_rng=SEED)
    want = jops.flash_attention_(*map(JTensor, (q, k, v)), causal=True,
                                 dropout_rate=0.1,
                                 dropout_rng=("pltpu_seed", SEED))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), **FWD_TOL)


# --------------------------------------------------------------------------
# errors and the wrappers without a GPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shapes,kw,match", [
    (((1, 1, 8, 4), (1, 1, 16, 4)), dict(causal=True), "Tq == Tk"),
    (((1, 1, 8, 4), (1, 1, 8, 4)), dict(window=4), "requires causal"),
    (((1, 1, 8, 4), (1, 1, 8, 4)), dict(causal=True, window=0), ">= 1"),
    (((1, 3, 8, 4), (1, 2, 8, 4)), {}, "divide"),
    (((1, 2, 8, 4), (1, 2, 8, 5)), {}, "head dim"),
    (((1, 2, 8, 4), (1, 2, 8, 4)), dict(dropout_rate=1.0), r"\[0, 1\)"),
    (((1, 2, 8, 4), (1, 2, 8, 4)), dict(impl="xla"), "impl"),
])
def test_invalid_calls_raise(shapes, kw, match):
    q, k = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        attention.mha_fwd(q, k, k, **kw)
    with pytest.raises(ValueError):
        attention.mha_fwd(*(Tensor(x).data for x in (q, k, k)), **kw)


@pytest.mark.parametrize("fn,n_extra", [
    (attention.cuda_attention_forward, 0),
    (attention.cuda_attention_backward_dq, 3),
    (attention.cuda_attention_backward_dkv, 3)])
def test_cuda_wrappers_refuse_cpu_tensors(fn, n_extra):
    x = torch.zeros((1, 2, 8, 4))
    extra = [x, torch.zeros((1, 2, 8, 1)), torch.zeros((1, 2, 8))][:n_extra]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(x, x, x, *extra, causal=False, scale=0.5)
    assert fn.launches == before
    assert "attention" not in kernels._loaded  # nothing was built


def test_plain_impl_and_cpu_tensors_take_the_plain_version():
    (q, k, v, _), kw = _inputs("gqa")
    args = tuple(map(torch.from_numpy, (q, k, v)))
    before = attention.cuda_attention_forward.launches
    a = attention.mha_fwd(*args, **kw)
    b = attention.mha_fwd(*args, impl="plain", **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert attention.cuda_attention_forward.launches == before


# the backward kernels' designs: dq and dk/dv each pick theirs by head dim
DESIGNS = {"dq": "dq_design", "dkv": "dkv_design"}
WRAPPERS = {"dq": "cuda_attention_backward_dq",
            "dkv": "cuda_attention_backward_dkv"}


@pytest.mark.parametrize("kernel", sorted(DESIGNS))
@pytest.mark.parametrize("d,design", [
    (8, "mma"), (32, "mma"), (40, "mma"), (64, "mma"),
    (65, "wgmma"), (80, "wgmma"), (96, "wgmma"), (128, "wgmma")])
def test_backward_design_by_head_dim(kernel, d, design):
    # one function of d picks each backward kernel: the wrapper hands its
    # answer to the C entry point and counts `wgmma_launches` by it
    assert getattr(attention, DESIGNS[kernel])(d) == design


@pytest.mark.parametrize("d,dv", [(192, 128), (160, 96), (129, 1),
                                  (192, 64)])
def test_backward_design_at_split_head_dims(d, dv):
    # multi-head latent attention's split dims: dk/dv on its split wgmma
    # kernel, dq on its <192, 128> template
    assert attention.dkv_design(d, dv) == "wgmma"
    assert attention.dq_design(d, dv) == "mma"


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wgmma_counter_stays_on_cpu_refusal(kernel):
    fn = getattr(attention, WRAPPERS[kernel])
    x = torch.zeros((1, 2, 8, 128))
    before = (fn.launches, fn.wgmma_launches)
    with pytest.raises(ValueError, match="CUDA"):
        fn(x, x, x, x, torch.zeros((1, 2, 8, 1)), torch.zeros((1, 2, 8)),
           causal=True, scale=0.5)
    assert (fn.launches, fn.wgmma_launches) == before
