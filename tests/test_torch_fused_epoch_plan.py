"""The whole-epoch kernel's launch plan (K2, ``ops/fused_epoch.py``): the
K-splits of its products, their K slices and the gradient rows' layout,
and the plain version summing each product slice by slice as a planned
launch does, against the JAX package's megakernel.

On the card each product of a step (a layer's forward, [dW; db] and dh)
runs as ``plan_epoch`` says: ``split`` blocks of a thread block cluster
share an output tile, each summing a slice of whole 32-deep stages of K,
and the slices are added in order. ``fused_epoch_reference(plan=)`` sums
in that order; here it is held, with the JAX side's Pallas megakernel in
interpret mode, at K2's gates (losses rtol 1e-5/atol 1e-6, state rtol
1e-4/atol 1e-5), on one rank and on four.
"""

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
from tinynn_autograd_tpu_torch.ops import fused_epoch
from tinynn_autograd_tpu_torch.parallel import DataParallel, make_mesh
from tinynn_autograd_tpu_torch.utils import datasets
from tinynn_autograd_tpu_torch.utils.convert import (
    params_from_jax, params_to_numpy,
)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
FLAGSHIP = [(784, 200), (200, 100), (100, 70), (70, 30), (30, 10)]
# (layers, rows a rank, blocks a rank, ranks): the flagship on the H100's
# 264 co-resident blocks (two an SM) and on 4 ranks of 66, the 16-layer
# limit, a narrow net, and a card of one cluster
PLAN_CASES = {
    "flagship_264": (FLAGSHIP, 128, 264, 1),
    "flagship_4_ranks_of_66": (FLAGSHIP, 32, 66, 4),
    "sixteen_layers": ([(784, 256)] + [(256, 256)] * 14 + [(256, 10)], 128,
                       256, 1),
    "narrow": ([(8, 16), (16, 4)], 16, 264, 1),
    "one_cluster": (FLAGSHIP, 128, 8, 1),
}


def _stages(k):
    return -(-k // fused_epoch.STAGE)


def _deepest(layers, blocks=256):
    """The plan that splits every product as far as it goes: the cluster
    size or the product's stages, whichever is fewer."""
    return fused_epoch.EpochPlan(tuple(
        (min(8, _stages(d_in)), min(8, _stages(batch)),
         min(8, _stages(d_out)) if l else 1)
        for l, (d_in, d_out, batch) in enumerate(layers)), 8, blocks)


# --------------------------------------------------------------------------
# the plan, its slices, the gradient layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_splits_fit_the_cluster_and_the_stages(case):
    layer_list, batch, blocks, n_ranks = PLAN_CASES[case]
    plan = fused_epoch.plan_epoch(layer_list, batch, blocks, n_ranks=n_ranks)
    assert plan.cluster == fused_epoch.CLUSTER == 8
    # a rank's blocks are a whole number of clusters, within those it has
    assert plan.blocks % plan.cluster == 0
    assert plan.cluster <= plan.blocks <= blocks
    assert len(plan.splits) == len(layer_list)
    for l, ((d_in, d_out), split) in enumerate(zip(layer_list, plan.splits)):
        for s, k in zip(split, (d_in, batch, d_out)):
            assert 1 <= s <= min(8, _stages(k)), (l, split)
            slices = fused_epoch.k_slices(k, s)
            # the slices cover K in order, whole stages, none empty
            assert slices[0][0] == 0 and slices[-1][1] == k
            assert all(a < b for a, b in slices)
            assert all(b == c for (_, b), (c, _) in zip(slices, slices[1:]))
            assert all(a % fused_epoch.STAGE == 0 for a, _ in slices)
        if l == 0:
            assert split[2] == 1  # the first layer has no dh


def test_plan_splits_the_flagship_first_layer_and_spares_short_products():
    plan = fused_epoch.plan_epoch(FLAGSHIP, 128, 264)
    # 28 tiles of 25 stages: split across the clusters' idle blocks
    assert plan.splits[0][0] > 1
    # the last layers' products are one to three stages deep: no split
    assert plan.splits[-1] == (1, 1, 1)
    assert fused_epoch.plan_epoch(FLAGSHIP, 128, 264, max_split=1).splits \
        == ((1, 1, 1),) * len(FLAGSHIP)


def test_plan_takes_fewer_blocks_where_barriers_outweigh_them():
    # every phase ends in a barrier over the rank's blocks (and all ranks
    # share the card): the model gives the flagship fewer blocks than the
    # card holds, and 4 ranks fewer a rank than one rank alone
    one = fused_epoch.plan_epoch(FLAGSHIP, 128, 240)
    four = fused_epoch.plan_epoch(FLAGSHIP, 32, 60, n_ranks=4)
    assert one.blocks < 240 and 4 * four.blocks < 240
    cost = [fused_epoch._plan_at(FLAGSHIP, 128, n, 8, 8, 1)[0]
            for n in range(1, 31)]
    assert cost[one.blocks // 8 - 1] == min(cost)


def test_plan_refuses_a_grid_of_no_cluster():
    with pytest.raises(ValueError, match="hold no cluster"):
        fused_epoch.plan_epoch(FLAGSHIP, 128, 7)


@pytest.mark.parametrize("k,split,want", [
    (784, 7, [(0, 96), (96, 224), (224, 320), (320, 448), (448, 544),
              (544, 672), (672, 784)]),
    (784, 8, [(0, 96), (96, 192), (192, 288), (288, 384), (384, 480),
              (480, 576), (576, 672), (672, 784)]),
    (128, 4, [(0, 32), (32, 64), (64, 96), (96, 128)]),
    (70, 3, [(0, 32), (32, 64), (64, 70)]),
    (10, 1, [(0, 10)]),
])
def test_k_slices_take_whole_stages_evenly(k, split, want):
    assert fused_epoch.k_slices(k, split) == want


@pytest.mark.parametrize("k,split", [(100, 5), (10, 2), (784, 0)])
def test_k_slices_refuse_an_empty_slice(k, split):
    with pytest.raises(ValueError):
        fused_epoch.k_slices(k, split)


def test_grad_layout_starts_every_leaf_on_a_float4():
    offsets, n = fused_epoch.grad_layout(FLAGSHIP)
    end = 0
    for (d_in, d_out), (w_at, b_at) in zip(FLAGSHIP, offsets):
        assert w_at % 4 == 0 and b_at % 4 == 0
        assert w_at >= end and b_at >= w_at + d_in * d_out
        end = b_at + d_out
    assert n % 4 == 0 and end <= n < end + 4
    assert n == 186616  # 186,610 gradients and 6 floats of padding


# --------------------------------------------------------------------------
# the planned plain version
# --------------------------------------------------------------------------

def _flagship_pair():
    """Flagship MLPs with the pinned JAX initial parameters, Adam 1e-3."""
    with jax_seeder.scope(0):
        jnet = jax_mlp()
    jm = JModel(jnet, JCE(), jopt.Adam(1e-3))
    tm = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
               optimizer.Adam(1e-3), device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    return jm, tm


def _assert_trees_close(jtree, ttree, tol, what):
    jtree = jax.tree.map(np.asarray, jtree)
    ttree = params_to_numpy(ttree)
    assert len(jtree) == len(ttree)
    for i, (a, b) in enumerate(zip(jtree, ttree)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], err_msg="%s layer %d %s"
                                       % (what, i, k), **tol)


def _planned(monkeypatch, plan):
    """Within the test, the CPU tier's plain version sums as ``plan``
    says; returns the list its runs are counted in."""
    runs = []
    plain = fused_epoch.fused_epoch_reference

    def planned(*args, **kw):
        runs.append(plan)
        return plain(*args, plan=plan, **kw)

    monkeypatch.setattr(fused_epoch, "fused_epoch_reference", planned)
    return runs


@pytest.mark.parametrize("plan_name", ["h100_264", "deepest"])
def test_planned_flagship_epoch_matches_jax(plan_name, monkeypatch):
    (x, y), _ = datasets.synthetic_mnist(4 * 128, 10, seed=31)
    y = datasets.one_hot(y)
    jm, tm = _flagship_pair()
    plan = (fused_epoch.plan_epoch(FLAGSHIP, 128, 264) if plan_name
            == "h100_264" else _deepest([(i, o, 128) for i, o in FLAGSHIP]))
    runs = _planned(monkeypatch, plan)
    lj = np.asarray(jm.train_epoch(x, y, batch_size=128, shuffle=False,
                                   fused=True))
    lt = tm.train_epoch(x, y, batch_size=128, shuffle=False, fused=True)
    assert lt.shape == (4,) and len(runs) == 1
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_trees_close(jm.net.params_tree(), tm.net.params_tree(),
                        STATE_TOL, "params")
    state = tm.optimizer.state_dict()
    for name in ("m", "v"):
        _assert_trees_close(jm._opt_state["slots"][name],
                            state["slots"][name], STATE_TOL, name)


def _plan_kernel_state(plan):
    """Three flagship steps of the plain version under ``plan``: the
    losses and every leaf after them."""
    _, tm = _flagship_pair()
    opt = tm.optimizer
    spec = fused_epoch.epoch_spec(tm.net, opt)
    (x, y), _ = datasets.synthetic_mnist(3 * 128, 10, seed=31)
    xb = torch.from_numpy(x).reshape(3, 128, 784)
    yb = torch.from_numpy(datasets.one_hot(y)).reshape(3, 128, 10)
    params = [{k: v.clone() for k, v in d.items()}
              for d in tm.net.params_tree()]
    slots = opt.init_state(params)["slots"]
    losses = fused_epoch.fused_epoch_reference(
        spec, fused_epoch.dense_leaves(tm.net, params),
        {k: fused_epoch.dense_leaves(tm.net, v) for k, v in slots.items()},
        xb, yb, torch.from_numpy(opt.step_scalars(0, 3)), plan=plan)
    leaves = [v for tree in [params] + [slots[k] for k in sorted(slots)]
              for d in tree for _, v in sorted(d.items())]
    return losses, leaves


def test_a_plan_of_single_slices_is_the_default_arithmetic():
    one = fused_epoch.plan_epoch(FLAGSHIP, 128, 264, max_split=1)
    got, got_state = _plan_kernel_state(one)
    want, want_state = _plan_kernel_state(None)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))


def test_a_split_plan_changes_only_the_order_of_sums():
    got, got_state = _plan_kernel_state(
        _deepest([(i, o, 128) for i, o in FLAGSHIP]))
    want, want_state = _plan_kernel_state(None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOSS_TOL)
    for a, b in zip(got_state, want_state):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STATE_TOL)
    # the slices' partial sums do round apart
    assert any(not torch.equal(a, b) for a, b in zip(got_state, want_state))


# four ranks of four rows, layers 2-3 stages deep so that the slices are
# more than one
RANK_DIMS = [(72, 64), (64, 40), (40, 4)]


def _rank_pair():
    jax_seeder.random_seed(0)
    jl, tl = [], []
    for i, (d_in, d_out) in enumerate(RANK_DIMS):
        jl.append(jlayers.Dense(d_out, num_in=d_in))
        tl.append(layers.Dense(d_out, num_in=d_in))
        if i + 1 < len(RANK_DIMS):
            jl.append(jlayers.ReLU())
            tl.append(layers.ReLU())
    jnet = JNet(jl)
    jm = JModel(jnet, JCE(), jopt.Adam(1e-2))
    tm = Model(Net(tl), SoftmaxCrossEntropyLoss(), optimizer.Adam(1e-2),
               device="cpu")
    tm.net.set_parameters(params_from_jax(jnet.params_tree(), "cpu"))
    return jm, tm


def test_planned_ranked_epoch_matches_jax_dp_megakernel(monkeypatch):
    n_dev, local, n_steps = 4, 4, 2
    rng = np.random.RandomState(0)
    x = rng.randn(n_dev * local * n_steps, RANK_DIMS[0][0]).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, len(x))]
    jm, tm = _rank_pair()
    plan = _deepest([(i, o, local) for i, o in RANK_DIMS], blocks=64)
    assert [s[0] for s in plan.splits] == [3, 2, 2]
    runs = _planned(monkeypatch, plan)
    jdp = JDataParallel(jm, mesh=jax_make_mesh(n_dev))
    dp = DataParallel(tm, mesh=make_mesh(devices=[torch.device("cpu")]
                                         * n_dev))
    lj = np.asarray(jdp.train_epochs(x, y, n_epochs=2,
                                     batch_size=n_dev * local,
                                     shuffle=False, fused=True))
    lt = dp.train_epochs(x, y, n_epochs=2, batch_size=n_dev * local,
                         shuffle=False, fused=True)
    assert lt.shape == (2, n_steps) and len(runs) == 2
    np.testing.assert_allclose(lt.numpy(), lj, **LOSS_TOL)
    _assert_trees_close(jdp._params, tm.net.params_tree(), STATE_TOL,
                        "params")
