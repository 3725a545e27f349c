"""Parallel training over a mesh of ranks (see parallel/mesh.py): so far
data parallelism, with the gradient ring of the whole-epoch kernel."""

from tinynn_autograd_tpu_torch.parallel.data_parallel import DataParallel
from tinynn_autograd_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

__all__ = ["make_mesh", "make_mesh_2d", "DataParallel"]
