"""The framework Tensor — counterpart of ``paddle_tpu/core/tensor.py``: a
thin imperative wrapper over a ``torch.Tensor`` (``_value``), as the
reference's wraps a jax array.

Paddle semantics kept:

* fresh tensors stop gradients (``stop_gradient=True``); Parameters do
  not. ``stop_gradient`` maps onto the value's ``requires_grad``: a leaf
  that does not stop gradients requires grad, and setting
  ``stop_gradient = True`` on a non-leaf detaches it;
* ``.backward()`` accumulates into ``.grad`` on leaves; ``.grad`` is a
  Tensor over the leaf's torch ``.grad`` (None on non-leaves);
* ``.shape`` is a Python list; ``.numpy()`` copies to the host (a
  bfloat16 tensor comes back as float32: numpy has no bfloat16);
* ``__setitem__`` writes out of place and rebinds the value, as the
  reference's ``_replace`` does: an in-place write into a leaf that
  requires grad would break the graph;
* every value has a canonical dtype (``core.dtype``: no int64 or
  float64, as under the reference's x64-off JAX).

``Tensor.place`` is where the storage lives (``core.place``). The
reference's guard against iterating a traced tensor has no tracing to
guard here: ``__iter__`` yields rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import autograd
from .dtype import X64_TO_32, canonical_dtype
from .place import Place, current_place, place_of

_tensor_count = [0]


def to_torch(value, device=None) -> torch.Tensor:
    """A host value (numpy array, Python scalar or nested list) as a
    canonical-dtype torch tensor on ``device`` (the current place when
    None). The numpy buffer is copied, never aliased."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        a = np.asarray(value)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            if not a.flags.writeable or any(s < 0 for s in a.strides):
                a = np.array(a)
            t = torch.from_numpy(a)
    dev = current_place().torch_device() if device is None else device
    d = X64_TO_32.get(t.dtype, t.dtype)
    return t.to(device=dev, dtype=d, copy=not isinstance(value, torch.Tensor))


def _differentiable(v: torch.Tensor) -> bool:
    return v.dtype.is_floating_point or v.dtype.is_complex


class Tensor:
    __slots__ = (
        "_value",
        "_sg",
        "name",
        "persistable",
        "_sharding_spec",
        "is_distributed",
        "__weakref__",
    )

    def __init__(
        self,
        value,
        stop_gradient: bool = True,
        name: Optional[str] = None,
        _grad_node=None,
        _out_index: int = 0,
    ):
        if _grad_node is not None:
            raise ValueError("_grad_node belongs to the JAX package's tape; "
                             "the port's graph is torch's")
        if isinstance(value, Tensor):
            value = value._value
        if not isinstance(value, torch.Tensor):
            value = to_torch(value)
        elif value.dtype in X64_TO_32:
            value = value.to(X64_TO_32[value.dtype])
        if stop_gradient:
            if value.requires_grad:
                value = value.detach()
        elif not value.requires_grad and _differentiable(value):
            value = value.detach().requires_grad_(True)
        self._value = value
        self._sg = bool(stop_gradient)
        if name is None:
            _tensor_count[0] += 1
            name = f"generated_tensor_{_tensor_count[0]}"
        self.name = name
        self.persistable = False
        self._sharding_spec = None
        self.is_distributed = False

    @classmethod
    def _wrap(cls, value: torch.Tensor, stop_gradient: bool,
              name: Optional[str] = None) -> "Tensor":
        """The dispatcher's constructor: ``value`` is an op's fresh
        output whose ``requires_grad`` already says what
        ``stop_gradient`` says."""
        t = object.__new__(cls)
        if value.dtype in X64_TO_32:
            value = value.to(X64_TO_32[value.dtype])
        if stop_gradient and value.requires_grad:
            value = value.detach()
        t._value = value
        t._sg = stop_gradient
        if name is None:
            _tensor_count[0] += 1
            name = f"generated_tensor_{_tensor_count[0]}"
        t.name = name
        t.persistable = False
        t._sharding_spec = None
        t.is_distributed = False
        return t

    # -- autograd flag ------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, stop: bool) -> None:
        stop = bool(stop)
        v = self._value
        if stop and v.requires_grad:
            if v.is_leaf:
                v.requires_grad_(False)
            else:
                self._value = v.detach()
        elif not stop and not v.requires_grad and _differentiable(v):
            v.requires_grad_(True)
        self._sg = stop

    # -- basic meta ---------------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return self._value.numel()

    @property
    def place(self) -> Place:
        return place_of(self._value.device)

    def numel(self) -> int:
        return self.size

    # -- host bridge --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy (never a view of a host tensor's storage, which a
        later in-place update such as an optimizer step would change)."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy() if v.is_cuda else v.numpy().copy()

    def item(self):
        return self._value.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self._value.detach())

    def __int__(self):
        return int(self._value.detach())

    def __bool__(self):
        return bool(self._value.detach())

    def __len__(self):
        if not self._value.dim():
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    # -- autograd -----------------------------------------------------------
    @property
    def grad(self) -> Optional["Tensor"]:
        v = self._value
        if not v.is_leaf or v.grad is None:
            return None
        return Tensor._wrap(v.grad, True, self.name + "@GRAD")

    @grad.setter
    def grad(self, g):
        if g is None:
            self._value.grad = None
        else:
            g = g._value if isinstance(g, Tensor) else torch.as_tensor(g)
            self._value.grad = g.to(dtype=self._value.dtype,
                                    device=self._value.device)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        autograd.backward(self, grad_tensor, retain_graph=retain_graph)

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._value.detach(), True,
                            self.name + "@detached")

    def detach_(self) -> "Tensor":
        self._value = self._value.detach()
        self._sg = True
        return self

    def clone(self) -> "Tensor":
        from .dispatch import apply
        return apply(lambda x: x.clone(), self, op_name="clone")

    # -- dtype/shape sugar (the full op surface is installed by math_ops) ---
    def astype(self, dtype) -> "Tensor":
        from .dispatch import apply
        dtype = canonical_dtype(dtype)
        return apply(lambda x: x.to(dtype), self, op_name="cast")

    cast = astype

    def _replace(self, new: "Tensor") -> "Tensor":
        """In-place rebind used by setitem/inplace ops: keep identity, new value."""
        self._value = new._value
        self._sg = new._sg
        return self

    def __getitem__(self, idx) -> "Tensor":
        from .dispatch import apply
        idx = _unwrap_index(idx)
        return apply(lambda x: x[idx], self, op_name="getitem")

    def __setitem__(self, idx, value):
        from .dispatch import apply
        idx = _unwrap_index(idx)

        def put(x, v):
            out = x.clone()
            out[idx] = v.to(x.dtype) if isinstance(v, torch.Tensor) else v
            return out

        if isinstance(value, Tensor):
            out = apply(put, self, value, op_name="setitem")
        else:
            out = apply(lambda x: put(x, value), self, op_name="setitem")
        self._replace(out)

    def __repr__(self):
        body = np.array2string(self.numpy(), precision=6, separator=", ")
        return (
            f"Tensor(shape={self.shape}, dtype={self.dtype}, "
            f"place={self.place}, stop_gradient={self.stop_gradient},\n"
            f"       {body})"
        )

    def __hash__(self):
        return id(self)

    # -- grad hooks ---------------------------------------------------------
    def register_hook(self, hook):
        """Call ``hook(grad)`` when this tensor's gradient is computed
        during backward; a non-None return replaces the gradient
        (reference Tensor.register_hook). Returns a removable handle."""
        if self.stop_gradient:
            raise RuntimeError(
                "cannot register a grad hook on a tensor with "
                "stop_gradient=True")

        def call(g):
            out = hook(Tensor._wrap(g, True))
            if out is None:
                return None
            return out._value if isinstance(out, Tensor) else out

        return self._value.register_hook(call)

    # -- iteration ----------------------------------------------------------
    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _unwrap_index(idx):
    if isinstance(idx, Tensor):
        v = idx._value
        return v.long() if v.dtype in (torch.int32, torch.int16, torch.int8,
                                       torch.uint8) else v
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i) for i in idx)
    return idx


def _leaf_attr(name: str, default):
    """An attribute kept on the Parameter's torch leaf, so an optimizer
    or a clip that holds the leaf (``optimizer._named``) reads it."""
    def get(self):
        return getattr(self._value, name, default)

    def set_(self, v):
        setattr(self._value, name, v)
    return property(get, set_)


class Parameter(Tensor):
    """Trainable tensor; ``stop_gradient=False`` by default. Its torch
    value is one leaf for its life (``set_value`` copies into it), and
    ``trainable``, ``optimize_attr`` and ``need_clip`` live on that leaf,
    where the optimizers and clips read them."""

    __slots__ = ("regularizer", "is_distributed_param", "expert",
                 "is_sequence_parallel", "main_grad")

    trainable = _leaf_attr("trainable", True)
    optimize_attr = _leaf_attr("optimize_attr", None)
    need_clip = _leaf_attr("need_clip", True)

    def __init__(self, value, trainable: bool = True, name: Optional[str] = None):
        if isinstance(value, Tensor):
            value = value._value
        if isinstance(value, torch.Tensor):
            value = value.detach()
        super().__init__(value, stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed_param = False
        self.expert = False
        self.is_sequence_parallel = False
        self.main_grad = None

    def set_value(self, value):
        v = value._value if isinstance(value, Tensor) else to_torch(
            value, self._value.device)
        v = v.to(dtype=self._value.dtype, device=self._value.device)
        with torch.no_grad():
            if tuple(v.shape) == tuple(self._value.shape):
                self._value.copy_(v)
                return
        leaf = v.detach().clone().requires_grad_(self._value.requires_grad)
        leaf.__dict__.update(self._value.__dict__)
        self._value = leaf


# the dispatcher loads the op surface, which installs Tensor's methods and
# operators (both import this module back; Tensor is defined by now)
from . import dispatch  # noqa: E402,F401
