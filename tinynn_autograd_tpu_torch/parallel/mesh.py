"""Meshes of ranks for the single-controller parallel wrappers.

PyTorch counterpart of the JAX package's parallel/mesh.py. A JAX mesh lays
devices along named axes and one program (``shard_map``) runs on each. Here
one process drives every rank of a mesh, and the ranks share ONE device:
each is a share of the card (a group of blocks in the data-parallel
megakernel, a shard of each batch in the step tier). That is the mesh the
card can run: NCCL refuses two ranks on one GPU, and kernels of separate
processes time-slice the card, so ranks that spin on each other's flags
would stall.

``make_mesh(n_devices=None, axis_name="data", devices=None)`` takes the
CUDA cards by default and raises as JAX does when ``n_devices`` exceeds
them. A simulated mesh names its device once per rank:
``devices=[torch.device("cuda")] * 4`` on the card, ``[torch.device("cpu")]
* 4`` in the tests (the counterpart of the JAX tests' virtual host
devices). A mesh over two or more distinct devices raises
``NotImplementedError``: a launch across cards over peer memory (NVLink) is
still to come (ROADMAP, queue 2).
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks laid along named axes, all on one device."""
    devices: tuple     # one torch.device a rank, row-major over ``shape``
    shape: tuple       # ranks along each axis
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError("shape %s and axis names %s differ in length"
                             % (self.shape, self.axis_names))
        n = 1
        for size in self.shape:
            n *= size
        if n != len(self.devices) or n < 1:
            raise ValueError("%d devices for a mesh of shape %s"
                             % (len(self.devices), self.shape))
        if len({_key(d) for d in self.devices}) > 1:
            raise NotImplementedError(
                "a mesh over distinct devices (%s): ranks on separate cards "
                "need a launch across cards over peer memory (NVLink), "
                "which is not built yet (ROADMAP queue 2, K6); name one "
                "device once per rank" % ", ".join(
                    sorted({str(d) for d in self.devices})))

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        """The device every rank shares."""
        return self.devices[0]


def _key(device):
    """A device's identity: ``cuda`` is the card ``cuda:0`` names."""
    device = torch.device(device)
    return device.type, device.index or 0


def same_device(a, b):
    return _key(a) == _key(b)


def _devices(devices):
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(n_devices=None, axis_name="data", devices=None):
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = _devices(devices)
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices) or n < 1:
        raise ValueError(
            "Requested %d devices, only %d available" % (n, len(devices)))
    return Mesh(tuple(devices[:n]), (n,), (axis_name,))


def make_mesh_2d(shape, axis_names=("data", "model"), devices=None):
    """2-D mesh, e.g. shape=(2, 4) for 2-way data x 4-way model
    parallelism."""
    devices = _devices(devices)
    n = shape[0] * shape[1]
    if n > len(devices):
        raise ValueError(
            "Requested %d devices, only %d available" % (n, len(devices)))
    return Mesh(tuple(devices[:n]), tuple(shape), tuple(axis_names))
