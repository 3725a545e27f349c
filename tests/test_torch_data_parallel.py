"""The port's data parallelism (``parallel/``), its ring all-reduce (P3,
``ops/ring_allreduce.py``) and the ranked whole-epoch kernel's plain version
(K2 with the K6 ring, ``ops/fused_epoch.py``) against the JAX package.

The JAX side runs on the 8 simulated host devices of tests/conftest.py: its
``DataParallel.train_epochs(fused=True)`` runs the data-parallel megakernel
in Pallas's distributed interpret mode (the ring's remote copies and
semaphores simulated), ``fused=False`` its ``pmean`` step tier. The port's
mesh names the CPU once per rank. Both start from the same parameters
(copied with ``params_from_jax``) and see the same numpy batches, unshuffled
(the JAX package shuffles each rank's shard with threefry).

The CUDA kernels run only on a card: tests/test_torch_cuda.py holds them to
these plain versions there.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tinynn_autograd_tpu.models import build_mnist_mlp as jax_mlp
from tinynn_autograd_tpu.nn import layers as jlayers
from tinynn_autograd_tpu.nn import optimizer as jopt
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss as JCE
from tinynn_autograd_tpu.nn.model import Model as JModel
from tinynn_autograd_tpu.nn.net import Net as JNet
from tinynn_autograd_tpu.parallel import DataParallel as JDataParallel
from tinynn_autograd_tpu.parallel import make_mesh as jax_make_mesh
from tinynn_autograd_tpu.utils import seeder as jax_seeder

from tinynn_autograd_tpu_torch.models import build_mnist_mlp
from tinynn_autograd_tpu_torch.nn import layers, optimizer
from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu_torch.nn.model import Model
from tinynn_autograd_tpu_torch.nn.net import Net
from tinynn_autograd_tpu_torch.ops import fused_epoch, kernels, ring_allreduce
from tinynn_autograd_tpu_torch.parallel import (
    DataParallel, make_mesh, make_mesh_2d,
)
from tinynn_autograd_tpu_torch.utils import datasets
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

N_DEV, LOCAL_BATCH, N_STEPS = 4, 4, 2  # tests/test_dp_megakernel.py's toy
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
COMPOSED_TOL = dict(rtol=2e-4, atol=1e-5)  # as test_dp_megakernel.py:114
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(n=N_DEV):
    return make_mesh(devices=[torch.device("cpu")] * n)


def _data(n=N_DEV * LOCAL_BATCH * N_STEPS, din=8, dout=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, din).astype(np.float32)
    y = np.eye(dout, dtype=np.float32)[rng.randint(0, dout, n)]
    return x, y


OPTS = {"sgd": ("SGD", dict(lr=0.1)), "adam": ("Adam", dict(lr=1e-2))}


def _toy_pair(opt="adam", dropout=False, seed=0):
    """tests/test_dp_megakernel.py's toy net, Dense(16, num_in=8), ReLU,
    [Dropout(0.25),] Dense(4), in both packages with equal parameters."""
    cls, kw = OPTS[opt]
    jax_seeder.random_seed(seed)
    jl = [jlayers.Dense(16, num_in=8), jlayers.ReLU()]
    tl = [layers.Dense(16, num_in=8), layers.ReLU()]
    if dropout:
        jl.append(jlayers.Dropout(0.25))
        tl.append(layers.Dropout(0.25))
    jnet = JNet(jl + [jlayers.Dense(4, num_in=16)])
    jm = JModel(jnet, JCE(), getattr(jopt, cls)(**kw))
    tm = Model(Net(tl + [layers.Dense(4, num_in=16)]),
               SoftmaxCrossEntropyLoss(), getattr(optimizer, cls)(**kw),
               device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    return jm, tm


def _compose_batches(x, y, n_dev=N_DEV, local_batch=LOCAL_BATCH,
                     n_steps=N_STEPS):
    """Global batch s of the DP epoch: the concatenation over ranks of each
    rank's s-th local slice (shuffle=False)."""
    per_x, per_y = np.split(x, n_dev), np.split(y, n_dev)
    return [(np.concatenate([d[s * local_batch:(s + 1) * local_batch]
                             for d in per_x]),
             np.concatenate([d[s * local_batch:(s + 1) * local_batch]
                             for d in per_y]))
            for s in range(n_steps)]


def _assert_trees_close(jtree, ttree, tol, what):
    jtree = jax.tree.map(np.asarray, jtree)
    ttree = params_to_numpy(ttree)
    assert len(jtree) == len(ttree)
    for i, (a, b) in enumerate(zip(jtree, ttree)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg="%s layer %d %s"
                                       % (what, i, k), **tol)


# --------------------------------------------------------------------------
# P3: the ring all-reduce
# --------------------------------------------------------------------------

@pytest.mark.parametrize("values", ["arange", "random"])
def test_ring_reference_matches_the_sum_and_the_ring_order(values):
    # tests/test_dp_megakernel.py:81's 8 devices of [8, 128]
    n = 8
    if values == "arange":
        x = np.arange(n * 8 * 128, dtype=np.float32).reshape(n, 8, 128)
    else:
        x = np.random.RandomState(1).randn(n, 8, 128).astype(np.float32)
    out = ring_allreduce.ring_all_reduce_reference(
        [torch.from_numpy(a) for a in x])
    assert len(out) == n
    for r, got in enumerate(out):
        np.testing.assert_allclose(got.numpy(), x.sum(axis=0), rtol=1e-6,
                                   atol=1e-5)
        # the TPU kernel's order: its own, then what each hop brought in
        acc = x[r].copy()
        for k in range(1, n):
            acc = acc + x[(r - k) % n]
        np.testing.assert_array_equal(got.numpy(), acc)


def test_ring_order_differs_between_ranks_but_not_by_much():
    x = np.random.RandomState(2).randn(4, 1000).astype(np.float32) * 1e3
    out = ring_allreduce.ring_all_reduce_reference(
        [torch.from_numpy(a) for a in x])
    spread = max(float((o - out[0]).abs().max()) for o in out)
    assert 0 < spread < 1e-3
    assert ring_allreduce.ring_order(4, 1) == [1, 0, 3, 2]


@pytest.mark.parametrize("n", list(range(1, 17)))
def test_ring_order_and_plain_version_at_every_rank_count(n):
    # the order of sums the one-pass exchange keeps: rank r adds its own
    # buffer, then r - 1, r - 2, ... (mod n), rounding after every add
    for r in range(n):
        order = ring_allreduce.ring_order(n, r)
        assert order == [(r - k) % n for k in range(n)]
        assert sorted(order) == list(range(n))
    x = np.random.RandomState(n).randn(n, 37).astype(np.float32) * 10
    out = ring_allreduce.ring_all_reduce_reference(
        [torch.from_numpy(a) for a in x])
    assert len(out) == n
    for r, got in enumerate(out):
        acc = x[r].copy()
        for k in range(1, n):
            acc = acc + x[(r - k) % n]
        np.testing.assert_array_equal(got.numpy(), acc)


def test_ring_all_reduce_takes_the_plain_version_on_the_cpu():
    before = ring_allreduce.cuda_ring_all_reduce.launches
    xs = [torch.full((3,), float(r)) for r in range(3)]
    out = ring_allreduce.ring_all_reduce(xs)
    assert [o.tolist() for o in out] == [[3.0] * 3] * 3
    assert ring_allreduce.cuda_ring_all_reduce.launches == before


def test_cuda_ring_wrapper_raises_on_cpu_tensors():
    before = ring_allreduce.cuda_ring_all_reduce.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_allreduce.cuda_ring_all_reduce([torch.zeros(4)] * 2)
    with pytest.raises(ValueError, match="1 to 16"):
        ring_allreduce.cuda_ring_all_reduce([torch.zeros(4)] * 17)
    assert ring_allreduce.cuda_ring_all_reduce.launches == before


def test_ring_module_imports_without_nvcc_and_builds_nothing():
    mod = importlib.reload(ring_allreduce)
    assert "ctypes" not in vars(mod)
    assert "ring_allreduce" not in kernels._loaded
    assert mod.cuda_ring_all_reduce.launches == 0
    cmd = kernels.nvcc_command("nvcc", mod.SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/ring_allreduce.cu")


# --------------------------------------------------------------------------
# the megakernel tier: plain K2 with the K6 ring against the JAX one
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sgd", "adam", "dropout"])
def test_dp_megakernel_matches_jax_dp_megakernel(case):
    opt = "sgd" if case == "dropout" else case
    x, y = _data()
    jm, tm = _toy_pair(opt, dropout=case == "dropout")
    jdp = JDataParallel(jm, mesh=jax_make_mesh(N_DEV))
    dp = DataParallel(tm, mesh=_mesh())
    lj = np.asarray(jdp.train_epochs(x, y, n_epochs=2,
                                     batch_size=N_DEV * LOCAL_BATCH,
                                     shuffle=False, fused=True))
    lt = dp.train_epochs(x, y, n_epochs=2, batch_size=N_DEV * LOCAL_BATCH,
                         shuffle=False, fused=True)
    assert lt.shape == (2, N_STEPS)
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_trees_close(jdp._params, tm.net.params_tree(), STATE_TOL,
                        "params")
    assert int(jdp._opt_state["t"]) == tm.optimizer.state_dict()["t"] == 4


def test_dp_megakernel_ranks_draw_their_own_masks():
    # rank r seeds its Dropouts with step t + 7919 r: the masks of ranks
    # that see the same rows differ, and the replicas stay close
    x, y = _data(N_DEV * LOCAL_BATCH)
    x[:] = x[:LOCAL_BATCH].repeat(N_DEV, 0)
    y[:] = y[:LOCAL_BATCH].repeat(N_DEV, 0)
    _, tm = _toy_pair("sgd", dropout=True)
    dp = DataParallel(tm, mesh=_mesh())
    spec = fused_epoch.epoch_spec(tm.net, tm.optimizer)
    params = [fused_epoch.dense_leaves(tm.net, tm.net.params_tree())]
    params += [[(w.clone(), b.clone()) for w, b in params[0]]
               for _ in range(N_DEV - 1)]
    xb = torch.from_numpy(x).reshape(N_DEV, 1, LOCAL_BATCH, 8)
    yb = torch.from_numpy(y).reshape(N_DEV, 1, LOCAL_BATCH, 4)
    losses = fused_epoch.fused_epoch_reference(
        spec, params, [{}] * N_DEV, xb, yb,
        torch.from_numpy(tm.optimizer.step_scalars(0, 1)))
    assert len(set(losses[:, 0].tolist())) == N_DEV
    assert dp.replica_spread() == 0.0


@pytest.mark.parametrize("fused", [True, False])
def test_both_tiers_match_single_device_training_on_composed_batches(fused):
    x, y = _data()
    _, tm = _toy_pair("adam")
    _, ref = _toy_pair("adam")
    dp = DataParallel(tm, mesh=_mesh())
    losses = dp.train_epochs(x, y, n_epochs=2,
                             batch_size=N_DEV * LOCAL_BATCH, shuffle=False,
                             fused=fused).numpy()
    for ep in range(2):
        for s, (xb, yb) in enumerate(_compose_batches(x, y)):
            np.testing.assert_allclose(
                losses[ep, s], float(ref.train_step(xb, yb)),
                err_msg="epoch %d step %d" % (ep, s), **COMPOSED_TOL)
    for a, b in zip(params_to_numpy(tm.net.params_tree()),
                    params_to_numpy(ref.net.params_tree())):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **COMPOSED_TOL)


def test_dp_step_tier_matches_jax_dp_epoch():
    x, y = _data()
    jm, tm = _toy_pair("adam")
    jdp = JDataParallel(jm, mesh=jax_make_mesh(N_DEV))
    dp = DataParallel(tm, mesh=_mesh())
    lj = np.asarray(jdp.train_epochs(x, y, n_epochs=2,
                                     batch_size=N_DEV * LOCAL_BATCH,
                                     shuffle=False, fused=False))
    lt = dp.train_epochs(x, y, n_epochs=2, batch_size=N_DEV * LOCAL_BATCH,
                         shuffle=False, fused=False)
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_trees_close(jdp._params, tm.net.params_tree(), STATE_TOL,
                        "params")


def test_flagship_slice_over_four_ranks_matches_jax():
    """The flagship's widths, 4 ranks of 32 rows, 2 steps: the port's
    megakernel tier (plain K2 with the K6 ring) and its step tier against
    the JAX package's DP step tier (``pmean``; its interpret-mode
    megakernel takes ~10 s at these widths), from pinned weights."""
    (x, y), _ = datasets.synthetic_mnist(256, 10, seed=31)
    y = datasets.one_hot(y)
    with jax_seeder.scope(0):
        jnet = jax_mlp()
    start = params_from_jax(jnet.params_tree(), "cpu")
    jdp = JDataParallel(JModel(jnet, JCE(), jopt.Adam(1e-3)),
                        mesh=jax_make_mesh(N_DEV))
    lj = np.asarray(jdp.train_epochs(x, y, n_epochs=1, batch_size=128,
                                     shuffle=False, fused=False))
    for fused in (True, False):
        tm = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
                   optimizer.Adam(1e-3), device="cpu")
        tm.net.set_parameters([{k: v.clone() for k, v in d.items()}
                               for d in start])
        dp = DataParallel(tm, mesh=_mesh())
        lt = dp.train_epochs(x, y, n_epochs=1, batch_size=128,
                             shuffle=False, fused=fused)
        assert lt.shape == (1, 2)
        np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
        _assert_trees_close(jdp._params, tm.net.params_tree(), STATE_TOL,
                            "params fused=%s" % fused)


def test_reported_loss_is_the_mean_of_the_ranks_local_means():
    x, y = _data(N_DEV * LOCAL_BATCH)
    _, tm = _toy_pair("sgd")
    _, probe = _toy_pair("sgd")
    local = [float(probe.loss.loss(probe.forward(xs), ys).data)
             for xs, ys in zip(np.split(x, N_DEV), np.split(y, N_DEV))]
    loss = DataParallel(tm, mesh=_mesh()).train_step(x, y)
    np.testing.assert_allclose(float(loss), np.mean(local), rtol=1e-6)


def test_step_tier_after_the_megakernel_recopies_the_replicas():
    x, y = _data()
    _, tm = _toy_pair("adam")
    dp = DataParallel(tm, mesh=_mesh())
    dp.train_epochs(x, y, 1, batch_size=16, shuffle=False, fused=True)
    assert dp._replicas is not None and len(dp._replicas) == N_DEV - 1
    dp.train_step(x[:16], y[:16])
    assert dp._replicas is None and dp.replica_spread() == 0.0
    assert tm.optimizer.state_dict()["t"] == 3
    dp.train_epochs(x, y, 1, batch_size=16, shuffle=True, fused=True)
    assert tm.optimizer.state_dict()["t"] == 5


def test_auto_on_the_cpu_takes_the_step_tier(monkeypatch):
    calls = []
    plain = fused_epoch.fused_epoch_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fused_epoch, "fused_epoch_reference", counted)
    x, y = _data()
    _, tm = _toy_pair("adam")
    dp = DataParallel(tm, mesh=_mesh())
    dp.train_epoch(x, y, batch_size=16, fused="auto")
    assert calls == []
    dp.train_epoch(x, y, batch_size=16, fused=True)
    assert calls == [1]


# --------------------------------------------------------------------------
# refusals, the mesh, predict, checkpoints, the example
# --------------------------------------------------------------------------

def test_fused_true_on_a_net_the_kernel_refuses_raises():
    model = Model(Net([layers.Dropout(0.1), layers.Dense(4, num_in=8)]),
                  SoftmaxCrossEntropyLoss(), optimizer.SGD(0.1), device="cpu")
    x, y = _data()
    with pytest.raises(ValueError, match="not eligible.*Dropout 0 is on"):
        DataParallel(model, mesh=_mesh()).train_epochs(
            x, y, 1, batch_size=16, shuffle=False, fused=True)


def test_dp_megakernel_counts_every_rank_against_the_budget():
    net = build_mnist_mlp()
    net.init((32, 784))
    opt = optimizer.Adam(1e-3)
    loss = SoftmaxCrossEntropyLoss()
    tree = net.params_tree()
    assert fused_epoch.supports(net, tree, opt, loss, (32, 784), n_ranks=4)
    reason = fused_epoch.unsupported_reason(net, tree, opt, loss, (32, 784),
                                            n_ranks=8)
    assert "exceeds" in reason
    assert "1 to 16" in fused_epoch.unsupported_reason(net, tree, opt, loss,
                                                       n_ranks=17)


def test_indivisible_batches_raise():
    x, y = _data()
    _, tm = _toy_pair("sgd")
    dp = DataParallel(tm, mesh=_mesh())
    with pytest.raises(ValueError, match="Global batch 18 not divisible by "
                       "mesh size 4"):
        dp.train_step(x[:18], y[:18])
    with pytest.raises(ValueError, match="must divide by mesh size 4"):
        dp.train_epochs(x[:30], y[:30], 1, batch_size=16)
    with pytest.raises(ValueError, match="must divide by mesh size 4"):
        dp.train_epochs(x, y, 1, batch_size=18)


def test_accum_steps_is_not_ported():
    x, y = _data()
    _, tm = _toy_pair("sgd")
    with pytest.raises(NotImplementedError, match="accum_steps"):
        DataParallel(tm, mesh=_mesh()).train_step(x, y, accum_steps=2)


def test_mesh_of_distinct_cards_is_not_built():
    with pytest.raises(NotImplementedError, match="peer memory"):
        make_mesh(devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="distinct devices"):
        make_mesh_2d((1, 2), devices=["cpu", "cuda"])
    with pytest.raises(ValueError, match="Requested 5 devices, only 4"):
        make_mesh(5, devices=["cpu"] * 4)
    # "cuda" and "cuda:0" name the same card
    assert make_mesh(devices=["cuda", "cuda:0"]).size == 2


def test_meshes_and_the_model_device():
    mesh = make_mesh_2d((2, 3), devices=["cpu"] * 6)
    assert mesh.shape == (2, 3) and mesh.axis_names == ("data", "model")
    assert mesh.size == 6 and mesh.device == torch.device("cpu")
    mesh = make_mesh(2, axis_name="batch", devices=["cpu"] * 4)
    assert mesh.shape == (2,) and mesh.axis_names == ("batch",)
    _, tm = _toy_pair("sgd")
    with pytest.raises(ValueError, match="the model lives on cpu"):
        DataParallel(tm, mesh=make_mesh(devices=["cuda"] * 2))
    assert DataParallel(tm, mesh=_mesh()).n_devices == N_DEV


def test_predict_shards_the_batch_and_falls_back_when_it_does_not_divide():
    x, _ = _data()
    _, tm = _toy_pair("sgd")
    dp = DataParallel(tm, mesh=_mesh())
    want = tm.predict(x).numpy()
    np.testing.assert_allclose(dp.predict(x).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(dp.predict(x[:7]).numpy(), want[:7],
                               rtol=1e-6)


def test_save_and_load_through_a_plain_model(tmp_path):
    x, y = _data()
    _, tm = _toy_pair("adam")
    dp = DataParallel(tm, mesh=_mesh())
    dp.train_epochs(x, y, 2, batch_size=16, shuffle=False, fused=True)
    path = str(tmp_path / "dp.ckpt")
    dp.save(path)
    _, plain = _toy_pair("adam", seed=9)
    plain.load(path)
    for a, b in zip(params_to_numpy(plain.net.params_tree()),
                    params_to_numpy(tm.net.params_tree())):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert plain.optimizer.state_dict()["t"] == 4
    # and back into a DataParallel: every rank starts from the checkpoint
    _, other = _toy_pair("adam", seed=9)
    dp2 = DataParallel(other, mesh=_mesh())
    dp2.load(path)
    np.testing.assert_array_equal(dp2.predict(x).numpy(),
                                  dp.predict(x).numpy())
    assert dp2._replicas is None


def test_run_torch_dp_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "mnist",
                                      "run_torch.py"),
         "--device", "cpu", "--dp", "2", "--num_ep", "1", "--seed", "0",
         "--batch_size", "1000", "--data_dir", "/nonexistent"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "2 ranks sharing cpu" in proc.stdout
    assert "Epoch 0" in proc.stdout


def test_seed_scan_of_the_ranked_hold_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "k2_seed_scan.py"), "--device",
         "cpu", "--ranks", "--seeds", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "data seed 0: least ReLU input over the 10 steps of 4 ranks" \
        in proc.stdout
