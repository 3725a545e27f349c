"""Whole-epoch training kernel (K2): every step of an epoch in one launch.

PyTorch counterpart of the JAX package's ops/fused_epoch.py. The JAX
megakernel keeps the parameters and optimizer moments in VMEM across a
sequential grid of steps and traces its body from the tape. Here the body is
written out by hand in ``csrc/fused_epoch.cu``: one persistent cooperative
CUDA kernel per epoch, with the state resident in device memory (and in the
50 MB L2) and grid-wide barriers between the phases of a step. It takes the
nets ``supports`` accepts: Dense layers, each followed by at most one ReLU,
Sigmoid or Tanh and then at most one Dropout (not after the last Dense),
Flatten, softmax cross-entropy (with or without class weights), and any of
the seven optimizers with any weight decay, learning-rate schedule and
``clip_norm``.

Dropout masks come from the counter hash of ``ops/dropout.py``: the Dropout
at position ``idx`` among the net's seeded layers draws, in the step whose
optimizer counter is ``t`` before its update, with seed ``t * 1000003 +
idx`` mod 2**32 (``Net.forward``'s rule), over the row-major index of its
[batch, width] input. So K2, its plain version and the step loop draw the
same masks as the JAX megakernel in interpret mode.

Ranks (K6, the data-parallel megakernel): with ``n_ranks`` > 1 the one
launch runs n ranks that share the card, each on its own replica, optimizer
slots and batch shard; between the backward and the optimizer each rank
sums every rank's gradients in the ring's order through one in-kernel
exchange (``csrc/ring.cuh``, the device code of P3,
``ops/ring_allreduce.py``: one all-rank arrival, one pass) and multiplies
by 1/n: the JAX package's ``grad_ring_all_reduce``, to the bit. Rank r seeds
its Dropouts with step ``t + 7919 r`` (``rank_step``), as the JAX kernel
adds ``axis_index * 7919``. A 4-D ``xb`` ([n_ranks, n_steps, batch,
features]) asks for ranks: the parameters and slots are then lists with one
entry per rank, and the losses [n_ranks, n_steps] each rank's mean over
its shard.

Each product of a step (a layer's forward, its weight gradient dW with db,
and the input gradient dh) runs on the card as a plan says: ``plan_epoch``
picks the clusters a rank takes and gives each product a K-split, the
blocks of a thread block cluster that share one output tile, each summing
a slice of whole 32-deep stages of K before the slices are added in order
(a cost model in plain Python, so the CPU tests check it). The plain
version takes the same plan (``plan=``), and then sums each product slice
by slice in that order; by default it sums each product at once.

- ``supports``: can the kernel run this (net, optimizer, loss)?
- ``build_fused_epoch``: ``epoch_fn(params, slots, t0, xb, yb) -> (t,
  losses)``. The parameters and slots are the model's own tensors, updated
  IN PLACE: that saves a copy of the state (2.2 MB for the flagship with
  Adam) per epoch. On a CUDA device it launches the kernel; on the CPU it
  runs the plain version. While ``utils/profiler`` records, the host's
  scalars, plan and launch are spans (``tinynn.k2.*``) and the kernel's
  phase clock adds into the device counter ``k2.phase_ns``, its steps
  into ``k2.steps``.
- ``epoch_spec``: what the kernel is told about the net and the optimizer.
- ``fused_epoch_reference``: the plain PyTorch version, the same arithmetic
  layer by layer (not through the tape). For CPU tensors and the tests.
- ``plan_epoch``, ``k_slices``, ``grad_layout``: the launch's plan, its
  K slices and the layout of the gradient rows, in plain Python.
- ``cuda_fused_epoch``: the kernel's wrapper. It launches or raises, never
  falls back; ``cuda_fused_epoch.launches`` counts its launches.
- ``cuda_fused_epoch_ranks``: the ranked kernel's wrapper (K2 with K6), the
  same launch with a shard, a replica and slots a rank; its own count.
"""

import dataclasses
import numbers
from collections import namedtuple

import numpy as np
import torch

from tinynn_autograd_tpu_torch.ops import dropout, kernels
from tinynn_autograd_tpu_torch.ops.ring_allreduce import (
    MAX_RANKS, SYNC_WORDS, ring_all_reduce_reference,
)
from tinynn_autograd_tpu_torch.utils import profiler

SOURCE = kernels.CSRC_DIR / "fused_epoch.cu"

# Activation codes of the kernel's C interface.
ACT_NONE, ACT_RELU, ACT_SIGMOID, ACT_TANH = 0, 1, 2, 3
# The rules of csrc/optim_rules.cuh (K2's, K3b's and P2's), in the order of
# its ``Opt`` enum: an optimizer class's ``kernel_code`` indexes it.
OPTIMIZERS = ("SGD", "Adam", "Momentum", "Lion", "RMSProp", "Adagrad",
              "Adadelta")
MAX_LAYERS = 16  # MAX_LAYERS in csrc/fused_epoch.cu

# The state the kernel keeps resident from step to step: parameters,
# optimizer slots, gradients and activations. On the H100 it lives in device
# memory and is served from the 50 MB L2 (two 25 MB halves), so it is held
# to about half of it, 24 MB, leaving the rest for the batches streaming
# through and other work on the card. The flagship with Adam needs 3.4 MB.
# (The TPU kernel's VMEM budget of 6 MB is a TPU figure and does not apply.)
STATE_BUDGET = 24 * 1024 * 1024
RANK_SEED_STRIDE = 7919  # kRankSeedStride in csrc/hash.cuh
STAGE = 32    # BK in csrc/fused_epoch.cu: the depth of a K stage
TILE = 32     # TILE: the edge of an output tile
CLUSTER = 8   # CLUSTER: the blocks of a cluster, the largest K-split

# The plan's cost model, in microseconds of a phase on the H100, for
# ranking plans (fitted to the flagship's phases by phase_ns and to its
# epochs under other plans, bench_k2_plans.py): a round's copies,
# the k-groups' sums and the epilogue; one 32-deep stage of products; a
# split's partial rows and cluster barrier; the barrier that ends a phase,
# which grows with the blocks that arrive at it; and the optimizer's pass
# over two float4 units a thread.
_PLAN_LOAD_US = 3.0
_PLAN_STAGE_US = 0.5
_PLAN_REDUCE_US = 1.5
_PLAN_BARRIER_US = 0.5
_PLAN_BARRIER_BLOCK_US = 0.012
_PLAN_UPDATE_US = 2.0
THREADS = 256  # THREADS in csrc/fused_epoch.cu: a block's threads

# What a launch runs: each Dense layer's K-splits of its forward, dW and dh
# products, the blocks of a cluster, and the blocks a rank takes (whole
# clusters).
EpochPlan = namedtuple("EpochPlan", "splits cluster blocks")
KernelGrid = namedtuple("KernelGrid", "clusters cluster blocks_per_sm sms")


def rank_step(t, rank):
    """The step rank ``rank`` seeds its Dropouts with in the step whose
    counter is ``t``: ``t + 7919 rank`` mod 2**32 (the JAX megakernel adds
    ``axis_index * 7919`` to its step seed)."""
    return (int(t) + RANK_SEED_STRIDE * int(rank)) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class EpochSpec:
    """What the kernel is told about the net and the optimizer."""
    # (d_in, d_out, activation code, dropout rate, seed index) for each
    # Dense: the rate of the Dropout after it (0.0 without one) and that
    # Dropout's position among the net's seeded layers (-1 without one)
    layers: tuple
    optimizer: int      # the rule's code (OPTIMIZERS' order)
    slot_names: tuple = ()  # the rule's slots, its slot0 and slot1
    consts: tuple = (0.0, 0.0, 0.0, 0.0)  # the rule's constants c0-c3, f32
    weight_decay: float = 0.0
    clip_norm: float = 0.0  # global-norm gradient clipping; 0.0 is off


def _activation_code(layer):
    from tinynn_autograd_tpu_torch.nn.layers import ReLU, Sigmoid, Tanh

    return {ReLU: ACT_RELU, Sigmoid: ACT_SIGMOID,
            Tanh: ACT_TANH}.get(type(layer))


def _dense_indices(net):
    from tinynn_autograd_tpu_torch.nn.layers import Dense

    return [i for i, layer in enumerate(net.layers)
            if isinstance(layer, Dense)]


def _dropout_reason(net, dense):
    """Why a Dropout of the net sits where the kernel cannot apply it, or
    None. It may follow a Dense's activation, or a Dense other than the
    last that has none."""
    from tinynn_autograd_tpu_torch.nn.layers import Dense, Dropout

    layers = net.layers
    for i, layer in enumerate(layers):
        if not isinstance(layer, Dropout):
            continue
        if i < dense[0]:
            return ("Dropout %d is on the inputs, before the first Dense "
                    "layer" % i)
        if i > dense[-1]:
            return ("Dropout %d follows the last Dense layer (it would "
                    "drop logits)" % i)
        prev = layers[i - 1]
        if isinstance(prev, Dropout):
            return "Dropout %d directly follows another Dropout" % i
        if isinstance(prev, Dense) and \
                _activation_code(layers[i + 1]) is not None:
            return ("Dropout %d sits between a Dense layer and its "
                    "activation" % i)
        if not (isinstance(prev, Dense) or (
                _activation_code(prev) is not None
                and isinstance(layers[i - 2], Dense))):
            return ("Dropout %d does not follow a Dense layer or its "
                    "activation" % i)
    return None


def unsupported_reason(net, params_tree, optimizer, loss, batch_shape=None,
                       n_ranks=1):
    """Why the kernel cannot run this (net, optimizer, loss), or None when
    it can. ``batch_shape`` ([batch, *features]), where given, also checks
    the input layout and counts the activations in the state. With
    ``n_ranks`` ranks the state of every rank counts, and with more than
    one two more planes of gradients a leaf too (``batch_shape`` is then a
    rank's shard)."""
    from tinynn_autograd_tpu_torch.nn.layers import Dense, Dropout, Flatten
    from tinynn_autograd_tpu_torch.nn.losses import SoftmaxCrossEntropyLoss

    dense = _dense_indices(net)
    reason = _dropout_reason(net, dense) if dense else None
    if reason is not None:
        return reason
    prev_dense = False
    for layer in net.layers:
        if getattr(layer, "compute_dtype", None) is not None:
            return ("layer %s sets compute_dtype: the kernel runs f32 math"
                    % layer.name)
        if isinstance(layer, Dense):
            if "b" not in layer.params:
                return "a Dense layer has no bias: the kernel's carry one"
            prev_dense = True
        elif _activation_code(layer) is not None:
            if not prev_dense:
                return ("activation %s does not directly follow a Dense "
                        "layer" % layer.name)
            prev_dense = False
        elif isinstance(layer, (Flatten, Dropout)):
            prev_dense = False
        else:
            return ("layer %s is not Dense, ReLU, Sigmoid, Tanh, Flatten or "
                    "Dropout" % type(layer).__name__)
    if not dense:
        return "the net has no Dense layer"
    if len(dense) > MAX_LAYERS:
        return "more than %d Dense layers" % MAX_LAYERS
    if batch_shape is not None and len(batch_shape) != 2 and not any(
            isinstance(layer, Flatten) for layer in net.layers[:dense[0]]):
        return ("inputs of shape %s reach the first Dense layer without a "
                "Flatten" % (tuple(batch_shape),))
    if optimizer.kernel_code is None:
        return "optimizer %s has no rule in the kernel" \
            % type(optimizer).__name__
    if not (callable(optimizer.lr) or isinstance(optimizer.lr,
                                                 numbers.Real)):
        return "the learning rate is neither a number nor a schedule"
    if optimizer.clip_norm is not None and not optimizer.clip_norm > 0:
        return "clip_norm %r is not positive" % (optimizer.clip_norm,)
    if type(loss) is not SoftmaxCrossEntropyLoss:
        return "loss %s is not SoftmaxCrossEntropyLoss" % type(loss).__name__
    for i in dense:
        leaves = params_tree[i]
        if "w" not in leaves or "b" not in leaves:
            return "Dense layer %d has no parameters yet" % i
        if leaves["w"].dtype != torch.float32:
            return "Dense layer %d holds %s parameters" % (i, leaves["w"].dtype)
    if not 1 <= n_ranks <= MAX_RANKS:
        return "%d ranks: the kernel takes 1 to %d" % (n_ranks, MAX_RANKS)
    n_floats = sum(v.numel() for i in dense for v in params_tree[i].values())
    # + grads; with ranks two planes of them (by step parity) and the mean
    state = n_floats * (2 + len(optimizer.slot_names) + (
        2 if n_ranks > 1 else 0))
    if batch_shape is not None:
        widths = sum((4 if rate else 3) * d_out
                     for _, d_out, _, rate, _ in layer_descriptor(net))
        state += batch_shape[0] * widths  # z, h, dz and a Dropout's output
    state *= n_ranks
    if 4 * state > STATE_BUDGET:
        return ("the state (%d bytes) exceeds the %d-byte budget"
                % (4 * state, STATE_BUDGET))
    return None


def supports(net, params_tree, optimizer, loss, batch_shape=None,
             n_ranks=1):
    """Can this (net, optimizer, loss) run as one whole-epoch kernel?"""
    return unsupported_reason(net, params_tree, optimizer, loss,
                              batch_shape, n_ranks) is None


def layer_descriptor(net):
    """(d_in, d_out, activation code, dropout rate, seed index) for each
    Dense layer, in order: what the wrapper packs for the C side. The rate
    is that of the Dropout after the Dense or its activation (0.0 without
    one), the seed index its position among the layers ``Net.forward``
    seeds (-1 without one)."""
    from tinynn_autograd_tpu_torch.nn.layers import Dropout

    seeded = [layer for layer in net.layers if hasattr(layer, "set_rng")]
    out = []
    for i in _dense_indices(net):
        following = net.layers[i + 1:i + 3]
        act = _activation_code(following[0]) if following else None
        after = following[1 if act is not None else 0:][:1]
        rate, seed_index = 0.0, -1
        if after and isinstance(after[0], Dropout):
            rate = float(after[0].rate)
            seed_index = seeded.index(after[0])
        d_in, d_out = (int(d) for d in net.layers[i].params["w"].shape)
        out.append((d_in, d_out, ACT_NONE if act is None else act, rate,
                    seed_index))
    return out


def epoch_spec(net, optimizer):
    code, consts = optimizer.kernel_rule()
    clip = optimizer.clip_norm
    return EpochSpec(
        tuple(layer_descriptor(net)), code,
        slot_names=tuple(optimizer.slot_names), consts=consts,
        weight_decay=float(np.float32(optimizer.weight_decay)),
        clip_norm=0.0 if clip is None else float(np.float32(clip)))


def dense_leaves(net, tree):
    """[(w, b)] for each Dense layer of a list-of-dicts tree."""
    return [(tree[i]["w"], tree[i]["b"]) for i in _dense_indices(net)]


def build_fused_epoch(net, loss_fn, optimizer, n_steps, batch_shape,
                      label_shape, n_ranks=None):
    """Returns ``epoch_fn(params, slots, t0, xb, yb) -> (t, losses)``.

    ``params`` is the model's parameter tree and ``slots`` the optimizer's
    slot trees by name; both are updated in place. ``t0`` is the step count
    before the epoch, ``t`` the count after it. ``xb`` is [n_steps,
    *batch_shape], ``yb`` [n_steps, *label_shape]; ``losses`` [n_steps].

    With ``n_ranks`` set (the data-parallel megakernel; 1 runs the ranked
    code with one rank), ``params`` and ``slots`` are lists with each
    rank's tree and slot trees, ``xb`` is
    [n_ranks, n_steps, *batch_shape] (each rank's shard; ``batch_shape`` is
    a rank's), ``yb`` likewise, and ``losses`` [n_ranks, n_steps]."""
    reason = unsupported_reason(net, net.params_tree(), optimizer, loss_fn,
                                batch_shape, n_ranks or 1)
    if reason is not None:
        raise ValueError("the whole-epoch kernel cannot run this net: "
                         + reason)
    spec = epoch_spec(net, optimizer)
    batch = int(batch_shape[0])
    features = int(np.prod(batch_shape[1:]))
    if features != spec.layers[0][0] or tuple(label_shape) != (
            batch, spec.layers[-1][1]):
        raise ValueError(
            "batches %s -> %s do not fit the net's %d inputs and %d outputs"
            % (tuple(batch_shape), tuple(label_shape), spec.layers[0][0],
               spec.layers[-1][1]))
    weight = loss_fn._weight

    def epoch_fn(params, slots, t0, xb, yb):
        ranks = () if n_ranks is None else (n_ranks,)
        xb = xb.reshape(ranks + (n_steps, batch, features))
        yb = yb.reshape(ranks + (n_steps, batch, spec.layers[-1][1]))
        with profiler.span("tinynn.k2.scalars"):
            scalars = torch.from_numpy(
                optimizer.step_scalars(t0, n_steps)).to(xb.device)
        run = (fused_epoch_reference if xb.device.type == "cpu"
               else cuda_fused_epoch if n_ranks is None
               else cuda_fused_epoch_ranks)
        # while traced, the kernel's phase clock adds into a device counter
        traced = {}
        if xb.device.type != "cpu" and profiler.enabled():
            traced["phase_ns"] = profiler.device_counter(
                "k2.phase_ns", phase_names(spec, n_ranks or 1), xb.device)
            profiler.count("k2.steps", n_steps)

        def pairs(slot_trees):
            return {name: dense_leaves(net, slot_trees[name])
                    for name in optimizer.slot_names}

        if n_ranks is None:
            leaves, slot_leaves = dense_leaves(net, params), pairs(slots)
        else:
            leaves = [dense_leaves(net, tree) for tree in params]
            slot_leaves = [pairs(s) for s in slots]
        losses = run(spec, leaves, slot_leaves, xb, yb, scalars,
                     None if weight is None else weight.to(xb.device),
                     bf16=kernels.matmul_precision() == "bf16", t0=t0,
                     **traced)
        return t0 + n_steps, losses

    return epoch_fn


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def _stages(k):
    return -(-int(k) // STAGE)


def k_slices(k, split):
    """The ``split`` K slices of a product over K = ``k``, as (k0, k1): whole
    32-deep stages, as evenly as they go (slice j takes stages j s / split
    to (j + 1) s / split of the s stages), the last cut at k. None is empty
    where ``split`` is at most the stages. ``slice_of`` in
    csrc/fused_epoch.cu."""
    stages = _stages(k)
    if not 1 <= split <= stages:
        raise ValueError("%d slices of %d stages" % (split, stages))
    return [(STAGE * (j * stages // split),
             min(k, STAGE * ((j + 1) * stages // split)))
            for j in range(split)]


def _tiles(m, n):
    return -(-m // TILE) * -(-n // TILE)


def _phase_cost(jobs, group, n_clusters, cluster):
    """Microseconds the cost model gives a phase whose products ``jobs``
    ((m, n, k) each) share clusters in groups of ``group`` blocks."""
    slots = n_clusters * (cluster // group)
    rounds = -(-sum(_tiles(m, n) for m, n, _ in jobs) // slots)
    deepest = max(-(-_stages(k) // min(group, _stages(k)))
                  for _, _, k in jobs)
    return rounds * (_PLAN_LOAD_US + deepest * _PLAN_STAGE_US
                     + (_PLAN_REDUCE_US if group > 1 else 0.0))


def _best_group(jobs, n_clusters, cluster, max_split):
    """The group (the phase's largest split) of least cost; the smaller on
    a tie. A group past every product's stages gains nothing."""
    top = min(max_split, cluster, max(_stages(k) for _, _, k in jobs))
    return min(range(1, top + 1),
               key=lambda g: (_phase_cost(jobs, g, n_clusters, cluster), g))


def _plan_at(layers, batch, n_clusters, cluster, max_split, n_ranks):
    """(the cost model's microseconds a step, the splits) of a launch of
    ``n_clusters`` clusters a rank on each of ``n_ranks`` ranks."""
    splits, cost = [], 0.0
    for l, (d_in, d_out) in enumerate((int(a), int(b)) for a, b, *_ in layers):
        fwd = [(batch, d_out, d_in)]
        g_fwd = _best_group(fwd, n_clusters, cluster, max_split)
        jobs = [(d_in + 1, d_out, batch)]
        if l > 0:
            jobs.append((batch, d_in, d_out))
        group = _best_group(jobs, n_clusters, cluster, max_split)
        cost += (_phase_cost(fwd, g_fwd, n_clusters, cluster)
                 + _phase_cost(jobs, group, n_clusters, cluster))
        splits.append((g_fwd, min(group, _stages(batch)),
                       min(group, _stages(d_out)) if l > 0 else 1))
    blocks = n_clusters * cluster
    units = grad_layout(layers)[1] // 4
    cost += _PLAN_UPDATE_US * -(-units // (2 * blocks * THREADS))
    cost += (2 * len(layers) + 2) * (
        _PLAN_BARRIER_US + _PLAN_BARRIER_BLOCK_US * n_ranks * blocks)
    return cost, tuple(splits)


def plan_epoch(layers, batch, blocks, cluster=CLUSTER, max_split=CLUSTER,
               n_ranks=1):
    """The launch of a rank that may take up to ``blocks`` co-resident
    blocks (whole clusters of ``cluster``) at ``batch`` rows a rank, one of
    ``n_ranks``, for the Dense layers ``layers`` ((d_in, d_out, ...) each,
    as ``EpochSpec.layers``): how many clusters it takes and each
    product's K-split.

    A step's phases run their products on the rank's clusters: the forward
    of layer l ([batch, d_in] @ [d_in, d_out]) alone, its backward [dW; db]
    ([d_in + 1, batch] @ [batch, d_out]) with, but for the first layer, dh
    ([batch, d_out] @ [d_out, d_in]). Each phase takes the group (its
    largest split, at most ``max_split`` and the cluster) that the cost
    model ranks first: 32x32 tiles, one a group of each cluster a round;
    a product's own split is the group cut at its K's stages. The clusters
    are those of least modelled step time: more clusters give the products
    more blocks, but every phase's barrier waits for all of them (the
    ranks' barriers share the card's L2, so the model counts every rank's
    blocks). Returns an ``EpochPlan``."""
    most = int(blocks) // cluster
    if most < 1:
        raise ValueError("%d blocks hold no cluster of %d" % (blocks, cluster))
    n_clusters = min(range(1, most + 1), key=lambda n: (_plan_at(
        layers, batch, n, cluster, max_split, n_ranks)[0], n))
    _, splits = _plan_at(layers, batch, n_clusters, cluster, max_split,
                         n_ranks)
    return EpochPlan(splits, cluster, n_clusters * cluster)


def grad_layout(layers):
    """Where each Dense layer's dW and db start in a rank's row of the
    gradients, [(w offset, b offset)], and the floats the row uses: the
    leaves in order w0, b0, w1, ..., each starting on a whole float4 (the
    kernel's optimizer loads four floats at a time)."""
    offsets, at = [], 0
    for d_in, d_out, *_ in layers:
        w_at = at
        at += -(-int(d_in) * int(d_out) // 4) * 4
        offsets.append((w_at, at))
        at += -(-int(d_out) // 4) * 4
    return offsets, at


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _activate(act, z):
    if act == ACT_RELU:
        return torch.clamp(z, min=0)
    if act == ACT_SIGMOID:
        return torch.sigmoid(z)
    if act == ACT_TANH:
        return torch.tanh(z)
    return z


def _activation_grad(act, g, z, h):
    """The tape's VJPs: ReLU's subgradient is 1 at 0; Sigmoid and Tanh take
    their derivative from the output."""
    if act == ACT_RELU:
        return g * (z >= 0)
    if act == ACT_SIGMOID:
        return g * h * (1.0 - h)
    if act == ACT_TANH:
        return g * (1.0 - h * h)
    return g


def apply_rule(spec, p, g, slots, s0, s1):
    """``csrc/optim_rules.cuh``'s rule in plain PyTorch: the optimizer's
    step from gradient ``g`` (the rules of nn/optimizer.py, from the spec's
    constants), weight decay, and ``p`` and ``slots`` (the rule's slot
    tensors, in ``spec.slot_names`` order) updated in place."""
    c0, c1, c2, c3 = spec.consts
    rule = OPTIMIZERS[spec.optimizer]
    if rule == "Momentum":
        step = s0 * slots[0].mul_(c0).add_(g)
    elif rule == "Adam":
        m, v = slots
        m.add_(c0 * (g - m))
        v.add_(c1 * (g * g - v))
        step = s0 * m / (torch.sqrt(v) * s1 + c2)
    elif rule == "Lion":
        m = slots[0]
        u = torch.sign(c0 * m + c1 * g)
        m.mul_(c2).add_(c3 * g)
        step = s0 * u
    elif rule == "RMSProp":
        ms, mom = slots
        ms.add_(c0 * (g * g - ms))
        mom.mul_(c1).add_(s0 * g * torch.rsqrt(ms + c2))
        step = -mom
    elif rule == "Adagrad":
        step = s0 * g * torch.rsqrt(slots[0].add_(g * g) + c0)
    elif rule == "Adadelta":
        eg, d = slots
        eg.add_(c0 * (g * g - eg))
        delta = g * torch.sqrt(d + c1) * torch.rsqrt(eg + c1)
        d.add_(c0 * (delta * delta - d))
        step = s0 * delta
    else:
        step = s0 * g
    if spec.weight_decay:
        step = step - spec.weight_decay * p
    p.add_(step)


def _sliced(mm, a, b, split):
    """a @ b, or with ``split`` the products of its K slices added in
    order."""
    if split is None:
        return mm(a, b)
    out = None
    for k0, k1 in k_slices(a.shape[1], split):
        part = mm(a[:, k0:k1], b[k0:k1])
        out = part if out is None else out + part
    return out


def _rank_step(spec, params, x, y, t, mm, class_weight, splits=None):
    """One rank's forward, loss and backward in the step whose Dropout seed
    step is ``t``: (the loss, [(gw, gb)] per Dense). With ``splits`` (a
    plan's, per Dense (forward, dW, dh)) each product is summed slice by
    slice."""
    batch = x.shape[0]
    acts = [layer[2] for layer in spec.layers]
    if splits is None:
        splits = [(None, None, None)] * len(params)
    ins, zs, hs, masks = [x], [], [], []
    for (_, _, act, rate, idx), (w, b), split in zip(spec.layers, params,
                                                     splits):
        zs.append(_sliced(mm, ins[-1], w, split[0]) + b)
        hs.append(_activate(act, zs[-1]))
        mask = None
        out = hs[-1]
        if rate:
            out, mask = dropout.dropout_reference(
                out, rate, dropout.layer_seed(t, idx))
        masks.append(mask)
        ins.append(out)
    # softmax cross-entropy, as nn/losses.py and its tape
    log_p = torch.log_softmax(ins[-1], dim=-1)
    nll = -(log_p * y).sum(dim=1, keepdim=True)
    g = torch.full((batch, 1), 1.0 / batch, device=x.device)
    if class_weight is not None:
        per_sample_w = (y * class_weight).sum(dim=1, keepdim=True)
        nll = nll * per_sample_w
        g = g * per_sample_w
    loss = nll.sum() / batch
    g_log_p = -g * y
    dz = g_log_p - torch.exp(log_p) * g_log_p.sum(dim=-1, keepdim=True)
    dz = _activation_grad(acts[-1], dz, zs[-1], hs[-1])
    # backward: every gradient before any weight changes
    grads = [None] * len(params)
    for l in reversed(range(len(params))):
        _, dw_split, dh_split = splits[l]
        if dw_split is None:
            gb = dz.sum(dim=0, keepdim=True)
        else:  # the kernel's row of ones: db summed with dW's slices
            gb = None
            for k0, k1 in k_slices(batch, dw_split):
                part = dz[k0:k1].sum(dim=0, keepdim=True)
                gb = part if gb is None else gb + part
        grads[l] = (_sliced(mm, ins[l].T, dz, dw_split), gb)
        if l > 0:
            g = _sliced(mm, dz, params[l][0].T, dh_split)
            if masks[l - 1] is not None:
                scale = dropout.keep_scale(spec.layers[l - 1][3])[1]
                g = torch.where(masks[l - 1], g * scale, 0.0)
            dz = _activation_grad(acts[l - 1], g, zs[l - 1], hs[l - 1])
    return loss, grads


def _ring_mean(rank_grads):
    """K6 in plain PyTorch: each gradient leaf summed over the ranks round
    the ring (``ring_all_reduce_reference``: each rank in its own order),
    then times 1/n, one f32 multiply."""
    n = len(rank_grads)
    scale = 1.0 / n
    out = [[[None, None] for _ in grads] for grads in rank_grads]
    for l in range(len(rank_grads[0])):
        for j in range(2):
            sums = ring_all_reduce_reference([g[l][j] for g in rank_grads])
            for r, summed in enumerate(sums):
                out[r][l][j] = summed * scale
    return [[tuple(pair) for pair in grads] for grads in out]


def fused_epoch_reference(spec, params, slots, xb, yb, scalars,
                          class_weight=None, bf16=False, t0=0, plan=None):
    """The kernel's function in plain PyTorch: ``params`` ([(w, b)] per
    Dense) and ``slots`` ({name: [(w, b)]} for each of the rule's slots)
    are updated in place over the ``n_steps`` steps of ``xb`` [n_steps, B,
    F] and ``yb`` [n_steps, B, C]; ``scalars`` [n_steps, 2] are the
    optimizer's per-step scalars (``step_scalars``), ``t0`` its step count
    before the epoch (the Dropout seeds' steps start there). Returns the
    losses [n_steps]. With ``bf16`` each product operand is rounded to bf16
    and the products are summed in f32. ``clip_norm`` scales the gradients
    as ``update`` does, before the rule.

    Ranks: with ``xb`` [n_ranks, n_steps, B, F] (and ``yb`` likewise),
    ``params`` and ``slots`` are lists with each rank's, and the losses
    [n_ranks, n_steps] each rank's mean over its shard. Each step every
    rank takes its gradients on its shard (Dropout seeds from ``rank_step``),
    then every leaf is summed round the ring and multiplied by 1/n (with
    more than one rank), then each rank clips and applies the rule to its
    own replica.

    ``plan`` (an ``EpochPlan``, None by default) sums each product as the
    kernel's launch of that plan does: its K slices one after another, in
    order, db with dW's slices. Without it each product is summed at
    once."""
    splits = None if plan is None else plan.splits
    if bf16:
        def mm(a, b):
            return kernels.matmul_reference(a.to(torch.bfloat16).float(),
                                            b.to(torch.bfloat16).float())
    else:
        mm = kernels.matmul_reference
    ranked = xb.ndim == 4
    if not ranked:
        params, slots, xb, yb = [params], [slots], xb[None], yb[None]
    n_ranks, n_steps = xb.shape[0], xb.shape[1]
    losses = torch.empty((n_ranks, n_steps), dtype=torch.float32,
                         device=xb.device)
    for s in range(n_steps):
        t = t0 + s
        rank_grads = []
        for r in range(n_ranks):
            losses[r, s], grads = _rank_step(
                spec, params[r], xb[r, s], yb[r, s], rank_step(t, r), mm,
                class_weight, splits)
            rank_grads.append(grads)
        if n_ranks > 1:
            rank_grads = _ring_mean(rank_grads)
        s0, s1 = scalars[s, 0], scalars[s, 1]
        for r, grads in enumerate(rank_grads):
            if spec.clip_norm:
                # as BaseOptimizer.update: the norm over every leaf, in the
                # JAX package's leaf order (b before w)
                total = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                       for gw, gb in grads
                                       for g in (gb, gw)))
                clip = torch.clamp(spec.clip_norm / (total + 1e-6), max=1.0)
                grads = [(gw * clip, gb * clip) for gw, gb in grads]
            # the optimizer, as nn/optimizer.py
            slot_pairs = [slots[r][name] for name in spec.slot_names]
            for l, (pair, grad_pair) in enumerate(zip(params[r], grads)):
                for j, (p, grad) in enumerate(zip(pair, grad_pair)):
                    apply_rule(spec, p, grad,
                               [sp[l][j] for sp in slot_pairs], s0, s1)
    return losses if ranked else losses[0]


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _bind(lib, ctypes):
    ptr, i32, u32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                               ctypes.c_float, ctypes.c_longlong)
    lib.tinynn_fused_epoch.argtypes = (
        [i32, i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32),
         ctypes.POINTER(u32), ctypes.POINTER(f32), ctypes.POINTER(ptr), ptr,
         ptr, i32] + [ptr] * 5 + [i32, ptr, i64, i64, ptr]
        + [i32, i32, u32, i32] + [f32] * 6 + [i32, i32, i64, ptr, ptr])
    lib.tinynn_fused_epoch.restype = i32
    lib.tinynn_fused_epoch_grid.argtypes = [i32] + [ctypes.POINTER(i32)] * 4
    lib.tinynn_fused_epoch_grid.restype = i32
    lib.tinynn_fused_epoch_table_bytes.argtypes = []
    lib.tinynn_fused_epoch_table_bytes.restype = i64


def kernel_grid(ranked=False):
    """The launch's grid on the current CUDA device, for the one-rank
    kernel or (``ranked``) the ranked one: a ``KernelGrid`` of the clusters
    the card holds at once, the blocks a cluster, the blocks an SM holds
    and the SMs. With n ranks each takes clusters // n clusters."""
    import ctypes

    lib = kernels.load_library("fused_epoch", _bind)
    out = [ctypes.c_int(0) for _ in range(4)]
    err = lib.tinynn_fused_epoch_grid(int(bool(ranked)),
                                      *[ctypes.byref(v) for v in out])
    if err != 0:
        raise RuntimeError("occupancy query failed: CUDA error %d" % err)
    return KernelGrid(*[v.value for v in out])


def epoch_plan(spec, batch, n_ranks=1, bf16=False):
    """The plan ``cuda_fused_epoch`` (``n_ranks`` 1) or
    ``cuda_fused_epoch_ranks`` launches for ``spec`` at ``batch`` rows a
    rank on the current CUDA device: ``plan_epoch`` within a rank's share
    of the clusters the card holds. A bf16 epoch sums each product in one K
    slice: splitting K changes the order of the f32 sums that the next
    product rounds to bf16, a flipped rounding moves an operand by 2^-8,
    and Adam's first, sign-like steps carry that into lr-sized steps, so
    the bf16 losses of two orders of sums can part past the bf16 hold's
    tolerance within the flagship's 10 pinned steps (PERF.md §6)."""
    grid = kernel_grid(n_ranks > 1)
    blocks = grid.clusters // n_ranks * grid.cluster
    if blocks < grid.cluster:
        raise RuntimeError("the card holds %d clusters of %d blocks: none "
                           "for each of %d ranks"
                           % (grid.clusters, grid.cluster, n_ranks))
    return plan_epoch(spec.layers, batch, blocks, grid.cluster,
                      max_split=1 if bf16 else grid.cluster, n_ranks=n_ranks)


def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError("%s is on %s, not %s" % (name, t.device, device))
    if t.dtype != torch.float32:
        raise TypeError("%s is %s; the kernel takes float32" % (name, t.dtype))
    if not t.is_contiguous():
        raise ValueError("%s is not contiguous" % name)
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))


def phase_names(spec, n_ranks=1):
    """The kernel's phases in the order of ``phase_ns``."""
    n = len(spec.layers)
    return (["forward %d" % l for l in range(n)] + ["loss"]
            + ["backward %d" % l for l in reversed(range(n))]
            + (["ring all-reduce"] if n_ranks > 1 else [])
            + (["clip norm"] if spec.clip_norm else []) + ["optimizer"])


def cuda_fused_epoch(spec, params, slots, xb, yb, scalars,
                     class_weight=None, bf16=False, t0=0, phase_ns=None,
                     plan=None):
    """``fused_epoch_reference``'s function through the hand-written CUDA
    kernel (K2): one cooperative launch for the whole epoch, ``params`` and
    ``slots`` updated in place. Every tensor is a contiguous float32 CUDA
    tensor on one device. ``phase_ns``, an int64 CUDA tensor with one entry
    per ``phase_names(spec)``, accumulates block 0's time in each phase,
    barrier wait included (a trace; None turns it off). ``plan`` (an
    ``EpochPlan``; None: ``epoch_plan``'s, one K slice a product with
    ``bf16``) sets the products' K-splits and the blocks. Raises on anything the kernel does not take and when the
    launch fails; never computes the epoch another way.
    ``cuda_fused_epoch.launches`` counts its launches."""
    if xb.ndim != 3 or yb.ndim != 3:
        raise ValueError("xb and yb must be [n_steps, batch, features]")
    with profiler.span("tinynn.k2.launch"):
        losses = _launch(spec, [params], [slots], xb[None], yb[None],
                         scalars, class_weight, bf16, t0, phase_ns, None,
                         plan)
    cuda_fused_epoch.launches += 1
    return losses[0]


cuda_fused_epoch.launches = 0


def cuda_fused_epoch_ranks(spec, params, slots, xb, yb, scalars,
                           class_weight=None, bf16=False, t0=0,
                           phase_ns=None, skew=None, plan=None):
    """The ranked kernel (K2 with K6, the data-parallel megakernel): one
    cooperative launch in which each of n ranks runs the epoch on its shard
    of ``xb`` [n_ranks, n_steps, batch, features] (``yb`` likewise) with its
    own ``params[r]`` and ``slots[r]``, updated in place, and with more
    than one rank sums every rank's gradients in the ring's order each
    step. Returns the losses [n_ranks, n_steps]. ``phase_ns`` (one entry a
    ``phase_names(spec, n_ranks)``) times rank 0's block 0. ``skew`` =
    (rank, microseconds) holds that rank back before each step's arrival
    (a check of the exchange's flow control). ``plan`` is a rank's, as in
    ``cuda_fused_epoch``. Raises as ``cuda_fused_epoch`` does;
    ``cuda_fused_epoch_ranks.launches`` counts its launches."""
    if xb.ndim != 4 or yb.ndim != 4:
        raise ValueError("xb and yb must be [n_ranks, n_steps, batch, "
                         "features]")
    with profiler.span("tinynn.k2.launch"):
        losses = _launch(spec, params, slots, xb, yb, scalars, class_weight,
                         bf16, t0, phase_ns, skew, plan)
    cuda_fused_epoch_ranks.launches += 1
    return losses


cuda_fused_epoch_ranks.launches = 0


def _pitch(width):
    """A row of ``width`` floats padded to whole float4s."""
    return -(-int(width) // 4) * 4


def _aligned(t):
    return t.data_ptr() % 16 == 0


def _check_plan(plan, spec, batch, grid, n_ranks):
    if len(plan.splits) != len(spec.layers) or plan.cluster != grid.cluster \
            or plan.blocks % grid.cluster or not (
                grid.cluster <= plan.blocks
                and n_ranks * plan.blocks <= grid.clusters * grid.cluster):
        raise ValueError("plan %s does not fit %d layers on %d ranks of a "
                         "card that holds %d clusters of %d"
                         % (plan, len(spec.layers), n_ranks, grid.clusters,
                            grid.cluster))
    for l, ((d_in, d_out, *_), split) in enumerate(zip(spec.layers,
                                                       plan.splits)):
        for what, s, k in zip(("forward", "dW", "dh"), split,
                              (d_in, batch, d_out)):
            if not 1 <= s <= min(grid.cluster, _stages(k)):
                raise ValueError("layer %d: a %s split of %r over K = %d"
                                 % (l, what, s, k))


def _launch(spec, params, slots, xb, yb, scalars, class_weight, bf16, t0,
            phase_ns, skew, plan):
    """Checks the ranked arguments and launches the kernel; returns the
    losses [n_ranks, n_steps]."""
    device = xb.device
    if device.type != "cuda":
        raise ValueError("cuda_fused_epoch needs CUDA tensors, got %s"
                         % device)
    n_layers, n_ranks = len(spec.layers), len(params)
    if not 1 <= n_layers <= MAX_LAYERS or any(
            len(p) != n_layers for p in params):
        raise ValueError("%d layers in the spec, %s parameter pairs (at most "
                         "%d)" % (n_layers, [len(p) for p in params],
                                  MAX_LAYERS))
    if not 1 <= n_ranks <= MAX_RANKS or len(slots) != n_ranks:
        raise ValueError("%d ranks of parameters, %d of slots (1 to %d)"
                         % (n_ranks, len(slots), MAX_RANKS))
    if not 0 <= spec.optimizer < len(OPTIMIZERS) or any(
            set(s) != set(spec.slot_names) for s in slots) or len(
            spec.slot_names) > 2:
        raise ValueError("optimizer %d with slots %s, the spec has %s"
                         % (spec.optimizer, [sorted(s) for s in slots],
                            list(spec.slot_names)))
    n_steps, batch = xb.shape[1], xb.shape[2]
    _check("xb", xb, device, (n_ranks, n_steps, batch, spec.layers[0][0]))
    _check("yb", yb, device, (n_ranks, n_steps, batch, spec.layers[-1][1]))
    _check("scalars", scalars, device, (n_steps, 2))
    if class_weight is not None:
        _check("class_weight", class_weight, device, (spec.layers[-1][1],))
    n_phases = len(phase_names(spec, n_ranks))
    if phase_ns is not None and (
            phase_ns.device != device or phase_ns.dtype != torch.int64
            or tuple(phase_ns.shape) != (n_phases,)):
        raise ValueError("phase_ns must be an int64 [%d] tensor on %s"
                         % (n_phases, device))
    if not (0 < n_steps < 2 ** 31 and 0 < batch < 2 ** 31):
        raise ValueError("epoch of %d steps of %d rows is out of range"
                         % (n_steps, batch))
    if skew is not None and not 0 <= skew[0] < n_ranks:
        raise ValueError("skew rank %d of %d ranks" % (skew[0], n_ranks))

    import ctypes

    with profiler.span("tinynn.k2.plan"):
        grid = kernel_grid(n_ranks > 1)
        if plan is None:
            plan = epoch_plan(spec, batch, n_ranks, bf16)
        _check_plan(plan, spec, batch, grid, n_ranks)
    # the kernel copies 16-byte rows: the inputs' rows padded to whole
    # float4s where they are not
    x_pitch = _pitch(spec.layers[0][0])
    if x_pitch != spec.layers[0][0] or not _aligned(xb):
        xb = torch.nn.functional.pad(xb, (0, x_pitch - spec.layers[0][0]))
    # `scratch` holds the gradients and activations until the launch is
    # queued: freed earlier, the caching allocator would hand one layer's
    # buffers to the next. After the launch it may reuse them: they were
    # allocated on the stream the kernel runs on. With ranks the gradients
    # take three planes (even steps', odd steps', each rank's mean after
    # the exchange); a rank's gw and gb point into plane 0 (grad_layout's
    # offsets), the kernel adds the plane's offset. z, h, d and dz have
    # rows of whole float4s, and so does wp, the kernel's copy of a weight
    # whose own rows are not 16-byte aligned.
    offsets, n_grad = grad_layout(spec.layers)
    grads = torch.empty((1 if n_ranks == 1 else 3, n_ranks, n_grad),
                        dtype=torch.float32, device=device)
    scratch = [grads, xb]
    dims, drops, drop_scales, ptrs, plan_ints = [], [], [], [], []
    prev_out = spec.layers[0][0]
    for l, (d_in, d_out, act, rate, idx) in enumerate(spec.layers):
        if d_in != prev_out or act not in (ACT_NONE, ACT_RELU, ACT_SIGMOID,
                                           ACT_TANH):
            raise ValueError("layer %d: (%d, %d, %d) does not chain"
                             % (l, d_in, d_out, act))
        if rate and (l == n_layers - 1 or idx < 0
                     or batch * d_out > dropout.MAX_ELEMENTS):
            raise ValueError("layer %d: a Dropout (rate %r, seed index %d) "
                             "the kernel cannot apply" % (l, rate, idx))
        prev_out = d_out
        threshold, scale = dropout.keep_scale(rate)
        dims += [d_in, d_out, act, int(bool(rate)), _pitch(d_out)]
        drops += [max(idx, 0), threshold]
        drop_scales.append(scale)
        plan_ints += [int(s) for s in plan.splits[l]]
    for r in range(n_ranks):
        for l, (d_in, d_out, act, rate, _) in enumerate(spec.layers):
            w, b = params[r][l]
            _check("rank %d w%d" % (r, l), w, device, (d_in, d_out))
            _check("rank %d b%d" % (r, l), b, device, (1, d_out))
            if not _aligned(b):
                raise ValueError("rank %d b%d is not 16-byte aligned: the "
                                 "kernel copies it 16 bytes at a time"
                                 % (r, l))
            w_at, b_at = offsets[l]
            gw = grads[0, r, w_at:w_at + d_in * d_out].view(d_in, d_out)
            gb = grads[0, r, b_at:b_at + d_out].view(1, d_out)
            leaves = [w, b, gw, gb]
            for name in list(spec.slot_names) + [None] * (
                    2 - len(spec.slot_names)):
                if name is None:
                    leaves += [None, None]
                    continue
                sw, sb = slots[r][name][l]
                _check("rank %d %s_w%d" % (r, name, l), sw, device,
                       (d_in, d_out))
                _check("rank %d %s_b%d" % (r, name, l), sb, device,
                       (1, d_out))
                leaves += [sw, sb]
            pitch = _pitch(d_out)
            z = torch.empty((batch, pitch), dtype=torch.float32,
                            device=device)
            h = z if act == ACT_NONE else torch.empty_like(z)
            wp = w if pitch == d_out and _aligned(w) else torch.empty(
                (d_in, pitch), dtype=torch.float32, device=device)
            leaves += [z, h, torch.empty_like(z) if rate else None,
                       torch.empty_like(z), wp]
            scratch.append(leaves)
            ptrs += [0 if t is None else t.data_ptr() for t in leaves]
    losses = torch.empty((n_ranks, n_steps), dtype=torch.float32,
                         device=device)
    partial = torch.empty(n_ranks * plan.blocks, dtype=torch.float32,
                          device=device)
    sync = torch.zeros(n_ranks * SYNC_WORDS, dtype=torch.int32,
                       device=device)
    skew_rank, skew_us = (-1, 0) if skew is None else skew

    lib = kernels.load_library("fused_epoch", _bind)
    tables = torch.empty(n_ranks * lib.tinynn_fused_epoch_table_bytes(),
                         dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tinynn_fused_epoch(
            n_ranks, plan.blocks, n_layers, (ctypes.c_int * len(dims))(*dims),
            (ctypes.c_int * len(plan_ints))(*plan_ints),
            (ctypes.c_uint * len(drops))(*drops),
            (ctypes.c_float * n_layers)(*drop_scales),
            (ctypes.c_void_p * len(ptrs))(*ptrs), tables.data_ptr(),
            xb.data_ptr(), x_pitch, yb.data_ptr(),
            0 if class_weight is None else class_weight.data_ptr(),
            scalars.data_ptr(), losses.data_ptr(), partial.data_ptr(),
            partial.numel(), grads.data_ptr(), n_grad, n_grad,
            sync.data_ptr(), batch, n_steps, int(t0) & 0xFFFFFFFF,
            spec.optimizer, *spec.consts, spec.weight_decay, spec.clip_norm,
            int(bool(bf16)), int(skew_rank), int(1000 * skew_us),
            0 if phase_ns is None else phase_ns.data_ptr(), stream)
    del scratch, partial, sync, tables
    if err == 801:  # cudaErrorNotSupported
        raise RuntimeError("the device cannot launch cooperative kernels")
    if err != 0:
        raise RuntimeError("fused epoch kernel launch failed: CUDA error %d"
                           % err)
    return losses
