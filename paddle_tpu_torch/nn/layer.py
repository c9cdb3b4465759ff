"""``Layer``, ``LayerList``, ``Sequential``, ``ParameterList`` and
``HookRemoveHelper`` — counterparts of ``paddle_tpu/nn/layer.py``
(l.49-406).

``Layer`` is a ``torch.nn.Module``. Its parameters stay torch leaves
(``nn.Parameter``) registered with torch, so autograd, the optimizers,
CUDA graphs and torch's own ``load_state_dict``, ``to`` and
``deepcopy`` keep working on every ported model. On top it has the
reference's surface:

* ``state_dict(destination=None, include_sublayers=True,
  structured_name_prefix="", use_hook=True)``: the live parameters (not
  copies), then the persistable buffers, by structured name. Torch's own
  recursion calls each child's ``state_dict(destination=, prefix=,
  keep_vars=)``: a call that gives ``prefix`` or ``keep_vars`` is torch's
  and gets torch's result;
* ``set_state_dict`` / ``set_dict`` / ``load_dict``: by structured name,
  shape checked, cast to the target's dtype and copied into it in place
  (the leaf an optimizer holds stays the same object); returns the
  missing and the unexpected keys;
* ``parameters(include_sublayers)``, ``named_parameters``,
  ``sublayers``, ``named_sublayers``, ``add_sublayer``,
  ``add_parameter``, ``create_parameter``, ``register_buffer(...,
  persistable=)``, forward pre/post hooks (torch's, whose calling
  conventions are the reference's) removed through
  :class:`HookRemoveHelper`.

Parameter order is the reference's traversal: a layer's own parameters,
then each sublayer's in turn. A layer that keeps one kind of parameter
per list (``FusedMultiTransformer``'s ``qkv_weights.<i>``; torch refuses
a dotted parameter name) declares its own order by overriding
:meth:`Layer._parameter_items`.

A ``core.tensor.Parameter`` given to ``add_parameter`` (or assigned as
an attribute) is registered through its torch leaf: the leaf becomes an
``nn.Parameter`` that the Parameter then wraps, so both see one
gradient. ``create_parameter`` returns the ``nn.Parameter``, drawn from
the framework key stream by the attribute's initializer, else the
default one, else the reference's rule (Xavier-uniform for a weight,
zeros for a bias); a :class:`ParamAttr`'s learning rate,
``trainable``, regularizer and ``need_clip`` are set on it as the
optimizers read them (a torch tensor's ``name`` is not writable, so its
name is not kept). A layer's parameter is a :class:`LayerParameter`. A layer's ``device=None`` is the current place
(``set_device``; the card unless set otherwise). ``apply`` visits the
layer before its sublayers, as the reference does; ``to``/``astype``
take Paddle's place strings and dtype names.
"""

from __future__ import annotations

import collections
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.dtype import convert_dtype, get_default_dtype
from ..core import place as _place
from ..core.tensor import Parameter as _CoreParameter
from ..core.tensor import Tensor, to_torch
from . import initializer as I


#: the device a layer builds its parameters on: ``device``, or when None
#: the place ``set_device`` set, else the card (raising without one)
layer_device = I.init_device


class ParamAttr:
    """Parity with paddle.ParamAttr."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 trainable=True, regularizer=None, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable
        self.regularizer = regularizer
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        raise TypeError(f"invalid param attr {attr!r}")


class LayerParameter(nn.Parameter):
    """A layer's parameter: an ``nn.Parameter`` with the two host-side
    methods of the reference's Parameter that user code calls on a
    layer's weights, ``set_value`` (an in-place copy, no gradient) and
    ``numpy`` (a host copy, whatever ``requires_grad`` says)."""

    def set_value(self, value):
        with torch.no_grad():
            self.copy_(as_torch(value).to(self.dtype))

    def numpy(self, *args, **kwargs):
        return self.detach().cpu().numpy().copy()


def make_parameter(value: torch.Tensor, attr: "ParamAttr") -> nn.Parameter:
    """``value`` as an ``nn.Parameter`` carrying ``attr``'s settings
    where the optimizers read them (a torch tensor's ``name`` is not
    writable: the attribute's name is not kept)."""
    p = LayerParameter(value, requires_grad=bool(attr.trainable))
    p.trainable = bool(attr.trainable)
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


def _place_device(device):
    """A torch device for a Paddle place string (``"gpu:1"``, ``"cpu"``),
    a Place or a torch device."""
    if isinstance(device, _place.Place):
        return device.torch_device()
    if isinstance(device, str):
        name, _, idx = device.partition(":")
        if name in ("gpu", "cuda"):
            return torch.device("cuda", int(idx or 0))
    return torch.device(device)


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 from JAX included) as a CPU
    tensor of its own memory."""
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def as_torch(value) -> torch.Tensor:
    """A state-dict value as a torch tensor: a Tensor's value, a torch
    tensor itself, or a host array (:func:`to_tensor`)."""
    if isinstance(value, Tensor):
        return value._value
    if isinstance(value, torch.Tensor):
        return value
    return to_tensor(np.asarray(value))


def _leaf(p):
    """The ``nn.Parameter`` to register for ``p``: itself, or a core
    Parameter's leaf made an ``nn.Parameter`` (sharing its storage and
    attributes) that the Parameter is rebound to."""
    if p is None or isinstance(p, nn.Parameter):
        return p
    if isinstance(p, _CoreParameter):
        v = p._value
        leaf = LayerParameter(v.detach(), requires_grad=v.requires_grad)
        leaf.__dict__.update(v.__dict__)
        p._value = leaf
        return leaf
    raise TypeError(f"cannot register {type(p).__name__} as a parameter")


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._name_scope = name_scope or self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, _CoreParameter):
            value = _leaf(value)
        super().__setattr__(name, value)

    # -- creation -------------------------------------------------------------

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new ``nn.Parameter`` on the current place, drawn by the
        attribute's initializer, else ``default_initializer``, else zeros
        for a bias and Xavier-uniform otherwise (the key stream)."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dt = convert_dtype(dtype) or self._dtype
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierUniform())
        shape = tuple(int(s) for s in shape)
        dev = getattr(self, "_build_device", None) or layer_device()
        if isinstance(init, I.Initializer):
            v = init(shape, dt, device=dev)
        else:
            v = to_torch(init(shape, dt), dev)
        return make_parameter(v.to(device=dev, dtype=dt), attr)

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, _leaf(parameter))
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        if isinstance(tensor, Tensor):
            tensor = tensor._value
        super().register_buffer(name, tensor, persistable)
        return tensor

    # -- traversal ------------------------------------------------------------

    def _parameter_items(self, prefix: str, include_sublayers: bool):
        """``(structured name, parameter)`` in the reference's order: this
        layer's own parameters, then each sublayer's."""
        for n, p in self._parameters.items():
            if p is not None:
                yield _join(prefix, n), p
        if not include_sublayers:
            return
        for n, m in self._modules.items():
            if m is None:
                continue
            if isinstance(m, Layer):
                yield from m._parameter_items(_join(prefix, n), True)
            else:
                yield from m.named_parameters(_join(prefix, n),
                                              remove_duplicate=False)

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, *,
                         recurse: Optional[bool] = None,
                         remove_duplicate: bool = True
                         ) -> Iterator[Tuple[str, nn.Parameter]]:
        if recurse is not None:                 # torch's spelling
            include_sublayers = recurse
        seen = set()
        for name, p in self._parameter_items(prefix, include_sublayers):
            if remove_duplicate:
                if id(p) in seen:
                    continue
                seen.add(id(p))
            yield name, p

    def parameters(self, include_sublayers: bool = True, *,
                   recurse: Optional[bool] = None) -> List[nn.Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def apply(self, fn):
        """``fn(layer)`` for this layer, then every sublayer in the
        reference's order (pre-order)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def full_name(self):
        return self._name_scope

    # -- dtype / place --------------------------------------------------------

    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """Paddle's ``to(device, dtype, blocking)``: a place string
        (``"gpu:0"``, ``"cpu"``), a Place or a torch device, and a dtype
        that floating parameters and buffers are cast to. The parameter
        objects stay the same (an optimizer holding them keeps them).
        Torch's spellings (a tensor or a dtype first, ``non_blocking=``)
        are torch's."""
        if kwargs or isinstance(device, (torch.Tensor, torch.dtype)):
            return super().to(*[a for a in (device, dtype) if a is not None],
                              **kwargs)
        dev = None if device is None else _place_device(device)
        dt = convert_dtype(dtype)
        if dev is not None or dt is not None:
            super().to(**({"device": dev} if dev is not None else {}),
                       **({"dtype": dt} if dt is not None else {}))
        if dt is not None:
            for layer in self.sublayers(include_self=True):
                layer._dtype = dt
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # -- modes ----------------------------------------------------------------

    def train(self, *mode):
        """Training mode for this layer and every sublayer. The
        reference's ``train`` takes no argument; torch's ``eval`` and its
        recursion pass ``mode`` positionally."""
        on = bool(mode[0]) if mode else True
        for m in self.modules():
            m.training = on
        return self

    # -- state ----------------------------------------------------------------

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix: Optional[str] = None,
                   keep_vars: Optional[bool] = None):
        if prefix is not None or keep_vars is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        dest = (destination if destination is not None
                else collections.OrderedDict())
        for name, p in self.named_parameters(structured_name_prefix,
                                             include_sublayers):
            dest[name] = p
        layers = (self.named_modules(prefix=structured_name_prefix)
                  if include_sublayers else [(structured_name_prefix, self)])
        for name, layer in layers:
            for bname, b in layer._buffers.items():
                if b is not None and \
                        bname not in layer._non_persistent_buffers_set:
                    dest[_join(name, bname)] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        unexpected = []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                tgt, val = own[k], as_torch(v)
                if tuple(val.shape) != tuple(tgt.shape):
                    raise ValueError(
                        f"shape mismatch for {k}: saved {tuple(val.shape)} "
                        f"vs current {tuple(tgt.shape)}")
                tgt.copy_(val)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- hooks ----------------------------------------------------------------

    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs)``; a result other than None replaces the
        inputs (a tuple, or one input)."""
        h = super().register_forward_pre_hook(hook)
        return HookRemoveHelper(self._forward_pre_hooks, h.id)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)``; a result other than None
        replaces the outputs."""
        h = super().register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, h.id)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, s in enumerate(sublayers or ()):
            self.add_sublayer(str(i), s)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx % len(self)), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def insert(self, index, layer):
        items = list(self._modules.values())
        items.insert(index, layer)
        self._modules.clear()
        for i, m in enumerate(items):
            self.add_sublayer(str(i), m)


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __len__(self):
        return len(self._parameters)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self
