"""Tensor: a ``torch.Tensor`` payload with tape-based reverse-mode autodiff.

PyTorch counterpart of the JAX package's Tensor (tinynn_autograd_tpu/core/
tensor.py). The tape is the framework's own, not ``torch.autograd``: every
primitive records hand-written VJP closures on its output, and ``backward()``
is a single reverse-topological walk that visits each node exactly once. The
raw torch tensors never have ``requires_grad=True``.

Payload rules (the JAX package's, mapped onto torch):

- A float64 input becomes float32, as ``jnp.asarray`` does with 64-bit mode
  off; other dtypes are kept (integers stay int64, torch's index type).
- numpy inputs are copied, never shared, so an update of a parameter never
  writes into the caller's array.
- A constant that meets a Tensor in an operator joins it on its device. A
  scalar constant stays a CPU 0-d tensor: torch passes those to CUDA kernels
  by value, with no copy and no synchronisation.
- Gradients are float even for integer-valued tensors.
- A leaf created with ``requires_grad=True`` starts with a zero gradient, as
  in the JAX package. A primitive's output gets its gradient in
  ``backward()``, without a zero buffer first.
"""

import numpy as np
import torch

_NAMED_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "bool": torch.bool}


def torch_dtype(dtype):
    """Map a torch, numpy or named dtype to a ``torch.dtype``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None)
    if isinstance(dtype, str):
        name = dtype
    if name in _NAMED_DTYPES:
        return _NAMED_DTYPES[name]
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def to_torch(values, dtype=None, device=None):
    """Coerce ``values`` (torch tensor, numpy array, scalar, nested list) to
    a torch tensor under the payload rules above."""
    if isinstance(values, Tensor):
        values = values.data
    if not isinstance(values, torch.Tensor):
        arr = np.asarray(values)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)
        values = torch.tensor(arr)
    dtype = torch_dtype(dtype)
    if dtype is None and values.dtype == torch.float64:
        dtype = torch.float32
    if dtype is not None or device is not None:
        values = values.to(device=device, dtype=dtype)
    return values


def as_tensor(obj, device=None):
    """Coerce ``obj`` to a Tensor. A non-scalar constant is placed on
    ``device`` (the device of the Tensor it is about to meet); a scalar
    stays on the CPU."""
    if isinstance(obj, Tensor):
        return obj
    values = to_torch(obj)
    if device is not None and values.ndim > 0:
        values = values.to(device)
    return Tensor(values)


def _grad_dtype(dtype):
    """Gradients are float even for integer-valued tensors."""
    if dtype.is_floating_point:
        return dtype
    return torch.float32


def _ops():
    from tinynn_autograd_tpu_torch.ops import primitives

    return primitives


class Tensor:
    """Array + autodiff tape node.

    ``dependency`` is a list of ``{"tensor": parent, "grad_fn": vjp}`` records;
    ``grad_fn`` maps this tensor's cotangent to the parent's cotangent,
    honoring numpy broadcasting semantics.
    """

    def __init__(self, values, requires_grad=False, dependency=None,
                 dtype=None, device=None):
        self._values = to_torch(values, dtype=dtype, device=device)

        self.grad = None
        self.requires_grad = requires_grad

        if dependency is None:
            dependency = []
        # normalize to (tensor, grad_fn) tuples internally
        self._deps = [
            (d["tensor"], d["grad_fn"]) if isinstance(d, dict) else tuple(d)
            for d in dependency
        ]
        if self.requires_grad and not self._deps:
            self.zero_grad()

    # ------------------------------------------------------------------ data

    @property
    def values(self):
        return self._values

    @values.setter
    def values(self, new_values):
        device = None
        if not isinstance(new_values, (Tensor, torch.Tensor)):
            device = self._values.device
        self._values = to_torch(new_values, device=device)
        self.grad = None

    # ``data`` is an alias used throughout the op layer.
    @property
    def data(self):
        return self._values

    @property
    def dependency(self):
        return [{"tensor": t, "grad_fn": f} for t, f in self._deps]

    @dependency.setter
    def dependency(self, deps):
        self._deps = [
            (d["tensor"], d["grad_fn"]) if isinstance(d, dict) else tuple(d)
            for d in (deps or [])
        ]

    @property
    def shape(self):
        return tuple(self._values.shape)

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def device(self):
        return self._values.device

    @property
    def ndim(self):
        return self._values.ndim

    @property
    def size(self):
        return self._values.numel()

    def numpy(self):
        """Copy to a host numpy array (waits for the device value)."""
        v = self._values
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        """numpy protocol: np.argmax(tensor), np.asarray(tensor), ... work
        directly."""
        return np.asarray(self.numpy(), dtype)

    def item(self):
        return self._values.item()

    def tolist(self):
        return self._values.tolist()

    def detach(self):
        """A view of the same data with no tape history."""
        return Tensor(self._values)

    def astype(self, dtype):
        return _ops().astype_(self, dtype)

    def __repr__(self):
        return "Tensor(shape=%s, requires_grad=%s, device=%s)" % (
            self.shape, self.requires_grad, self.device)

    def __len__(self):
        return len(self._values)

    # ----------------------------------------------------- comparisons (raw)

    def __gt__(self, other):
        return self._values > as_tensor(other, self.device)._values

    def __lt__(self, other):
        return self._values < as_tensor(other, self.device)._values

    def __ge__(self, other):
        return self._values >= as_tensor(other, self.device)._values

    def __le__(self, other):
        return self._values <= as_tensor(other, self.device)._values

    # ------------------------------------------------------------ arithmetic
    # The in-place forms rebind the payload (and drop the gradient), as the
    # JAX package does; they never write into the old storage.

    def __add__(self, other):
        return _ops().add_(self, as_tensor(other, self.device))

    def __radd__(self, other):
        return _ops().add_(as_tensor(other, self.device), self)

    def __iadd__(self, other):
        self.values = self._values + as_tensor(other, self.device)._values
        return self

    def __sub__(self, other):
        return _ops().sub_(self, as_tensor(other, self.device))

    def __rsub__(self, other):
        return _ops().sub_(as_tensor(other, self.device), self)

    def __isub__(self, other):
        self.values = self._values - as_tensor(other, self.device)._values
        return self

    def __mul__(self, other):
        return _ops().mul_(self, as_tensor(other, self.device))

    def __rmul__(self, other):
        return _ops().mul_(as_tensor(other, self.device), self)

    def __imul__(self, other):
        self.values = self._values * as_tensor(other, self.device)._values
        return self

    def __truediv__(self, other):
        return _ops().div_(self, as_tensor(other, self.device))

    def __rtruediv__(self, other):
        return _ops().div_(as_tensor(other, self.device), self)

    def __itruediv__(self, other):
        self.values = self._values / as_tensor(other, self.device)._values
        return self

    def __neg__(self):
        return _ops().neg_(self)

    def __getitem__(self, key):
        return _ops().getitem_(self, key)

    def __pow__(self, other):
        return _ops().pow_(self, as_tensor(other, self.device))

    def __rpow__(self, other):
        return _ops().pow_(as_tensor(other, self.device), self)

    def __ipow__(self, other):
        self.values = self._values ** as_tensor(other, self.device)._values
        return self

    def __matmul__(self, other):
        return _ops().dot_(self, as_tensor(other, self.device))

    def __rmatmul__(self, other):
        return _ops().dot_(as_tensor(other, self.device), self)

    def __imatmul__(self, other):
        self.values = self._values @ as_tensor(other, self.device)._values
        return self

    # ------------------------------------------------------------ method ops

    def sum(self, axis=None, keepdims=False):
        return _ops().sum_(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return _ops().mean_(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None):
        return _ops().max_(self, axis=axis)

    def min(self, axis=None):
        return _ops().min_(self, axis=axis)

    def transpose(self, axes=None):
        return _ops().transpose_(self, axes=axes)

    def log(self):
        return _ops().log_(self)

    def exp(self):
        return _ops().exp_(self)

    def reshape(self, newshape):
        return _ops().reshape_(self, newshape)

    def flatten(self):
        return _ops().flatten_(self)

    def clip(self, min=None, max=None):
        return _ops().clip_(self, min, max)

    @property
    def T(self):
        return _ops().transpose_(self, axes=None)

    # -------------------------------------------------------------- autodiff

    def backward(self, grad=None):
        """Reverse-mode gradient propagation.

        Seeds this tensor's cotangent with ``grad`` (default: ones), walks the
        tape once in reverse topological order, and *accumulates* into the
        ``.grad`` of every reachable ``requires_grad`` tensor (one visit per
        node, not one per path).
        """
        if not self.requires_grad:
            raise RuntimeError("Call backward() on a non-requires-grad tensor.")
        gdtype = _grad_dtype(self.dtype)
        if grad is None:
            seed = torch.ones(self.shape, dtype=gdtype, device=self.device)
        else:
            seed = torch.broadcast_to(
                to_torch(grad).to(device=self.device, dtype=gdtype),
                self.shape)

        order = _topo_order(self)
        cotangents = {id(self): seed}
        for t in order:
            g = cotangents.pop(id(t), None)
            if g is None:
                continue
            t.grad = g if t.grad is None else t.grad + g
            for parent, grad_fn in t._deps:
                pg = grad_fn(g)
                prev = cotangents.get(id(parent))
                cotangents[id(parent)] = pg if prev is None else prev + pg

    def zero_grad(self):
        self.grad = torch.zeros(self.shape, dtype=_grad_dtype(self.dtype),
                                device=self.device)


def _topo_order(root):
    """Iterative post-order DFS over the tape; returns dependents-first order.

    The returned list starts at ``root`` and ends at the leaves: position i
    always precedes every tensor reachable from it, so a single forward pass
    over the list propagates cotangents correctly.
    """
    order = []
    visited = set()
    # stack of (tensor, child_iterator)
    stack = [(root, iter(root._deps))]
    visited.add(id(root))
    while stack:
        node, it = stack[-1]
        advanced = False
        for parent, _ in it:
            if id(parent) not in visited:
                visited.add(id(parent))
                stack.append((parent, iter(parent._deps)))
                advanced = True
                break
        if not advanced:
            order.append(node)
            stack.pop()
    order.reverse()
    return order
