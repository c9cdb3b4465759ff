"""``paddle_tpu_torch.static.nn`` — static-graph layer builders,
counterpart of ``paddle_tpu/static/nn.py``.

Parity with python/paddle/static/nn/ of the reference (fc, embedding,
conv/batch_norm/layer_norm builders + the control-flow ops cond /
while_loop / case / switch_case). The reference creates graph
Variables + persistent parameters in a scope; here the "graph" is a
compiled program, so each builder keeps its parameters in a name-keyed module
store (the scope analog). A NAMED builder re-uses its parameters on
every call/trace; an UNNAMED call creates a fresh layer each time —
exactly the reference's behaviour, where each unnamed call site makes
new parameters and the program is built ONCE (do not call unnamed
builders inside a per-step loop there either). The dynamic
``paddle_tpu_torch.nn`` Layers remain the first-class training path; these
builders serve code written against the static API.

Control flow maps onto the dy2static runtime (`jit/dy2static.py`):
``cond`` -> a converted select with concrete-predicate passthrough,
``while_loop`` -> a converted loop (a graph break on a traced predicate)
— the same converters `to_static` plants.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from ..core.tensor import Tensor
from .. import nn as _dnn
from ..jit.dy2static import convert_ifelse, convert_while

__all__ = [
    "fc", "embedding", "batch_norm", "layer_norm", "conv2d",
    "conv2d_transpose", "prelu", "cond", "while_loop", "case",
    "switch_case", "static_param_store",
]

#: name -> Layer: the scope the reference keeps graph parameters in
_STORE: dict = {}


def static_param_store():
    """The name->Layer store backing these builders (clear between
    programs the way the reference resets its scope)."""
    return _STORE


def _layer(name: Optional[str], default_prefix: str, factory: Callable):
    if name is None:
        name = f"{default_prefix}_{len(_STORE)}"
    if name not in _STORE:
        _STORE[name] = factory()
    return _STORE[name]


def fc(x, size: int, num_flatten_dims: int = 1, weight_attr=None,
       bias_attr=None, activation: Optional[str] = None, name=None):
    """Reference static.nn.fc: flatten trailing dims, affine, optional
    activation."""
    t = x if isinstance(x, Tensor) else Tensor(x)
    shape = tuple(t.shape)
    if num_flatten_dims < 0:
        num_flatten_dims = len(shape) + num_flatten_dims
    in_features = int(np.prod(shape[num_flatten_dims:]))
    lyr = _layer(name, "fc", lambda: _dnn.Linear(
        in_features, size, weight_attr=weight_attr, bias_attr=bias_attr))
    flat = t.reshape(list(shape[:num_flatten_dims]) + [in_features])
    out = lyr(flat)
    if activation:
        out = getattr(_dnn.functional, activation)(out)
    return out


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              padding_idx=None, weight_attr=None, name=None):
    lyr = _layer(name, "embedding", lambda: _dnn.Embedding(
        size[0], size[1], padding_idx=padding_idx,
        weight_attr=weight_attr))
    return lyr(input if isinstance(input, Tensor) else Tensor(input))


def batch_norm(input, momentum: float = 0.9, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test: bool = False, name=None):
    t = input if isinstance(input, Tensor) else Tensor(input)
    ch = t.shape[1] if data_layout == "NCHW" else t.shape[-1]
    lyr = _layer(name, "batch_norm", lambda: _dnn.BatchNorm2D(
        ch, momentum=momentum, epsilon=epsilon,
        data_format=data_layout))
    if is_test:
        lyr.eval()
    return lyr(t)


def layer_norm(input, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, name=None):
    t = input if isinstance(input, Tensor) else Tensor(input)
    normalized = list(t.shape[begin_norm_axis:])
    lyr = _layer(name, "layer_norm",
                 lambda: _dnn.LayerNorm(normalized, epsilon=epsilon))
    return lyr(t)


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           data_format="NCHW", name=None):
    t = input if isinstance(input, Tensor) else Tensor(input)
    in_ch = t.shape[1] if data_format == "NCHW" else t.shape[-1]
    lyr = _layer(name, "conv2d", lambda: _dnn.Conv2D(
        in_ch, num_filters, filter_size, stride=stride, padding=padding,
        dilation=dilation, groups=groups or 1, data_format=data_format))
    return lyr(t)


def conv2d_transpose(input, num_filters: int, filter_size, stride=1,
                     padding=0, groups=1, param_attr=None, bias_attr=None,
                     data_format="NCHW", name=None):
    t = input if isinstance(input, Tensor) else Tensor(input)
    in_ch = t.shape[1] if data_format == "NCHW" else t.shape[-1]
    lyr = _layer(name, "conv2d_transpose", lambda: _dnn.Conv2DTranspose(
        in_ch, num_filters, filter_size, stride=stride, padding=padding,
        groups=groups or 1, data_format=data_format))
    return lyr(t)


def prelu(x, mode: str = "all", param_attr=None, data_format="NCHW",
          name=None):
    t = x if isinstance(x, Tensor) else Tensor(x)
    if mode == "all":
        num = 1
    elif mode == "channel":
        num = t.shape[1] if data_format == "NCHW" else t.shape[-1]
    else:
        num = int(np.prod(t.shape[1:]))
    lyr = _layer(name, "prelu",
                 lambda: _dnn.PReLU(num_parameters=num))
    if mode == "channel" and data_format == "NCHW" and len(t.shape) > 2:
        # per-channel weight must broadcast over the trailing spatial
        # dims, not the last axis
        w = lyr.weight.reshape([num] + [1] * (len(t.shape) - 2))
        return _dnn.functional.prelu(t, w)
    return lyr(t)


# -- control flow (the static-graph ops, on the dy2static runtime) ---------

def cond(pred, true_fn: Callable, false_fn: Callable, name=None):
    """Reference static.nn.cond: a converted select on traced
    predicates, plain Python dispatch on concrete ones."""
    return convert_ifelse(pred, true_fn, false_fn, loc="static.nn.cond")


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars, name=None):
    """Reference static.nn.while_loop: carry must keep stable
    shapes/dtypes; body returns the new loop_vars."""
    out = convert_while(
        lambda c: cond_fn(*c), lambda c: tuple(body_fn(*c)),
        tuple(loop_vars), loc="static.nn.while_loop")
    return list(out)


def case(pred_fn_pairs, default: Optional[Callable] = None, name=None):
    """First predicate that holds wins; lowers to nested cond."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")

    def build(pairs):
        (p, fn), rest = pairs[0], pairs[1:]
        if not rest:
            if default is None:
                return fn()
            return cond(p, fn, default)
        return cond(p, fn, lambda: build(rest))

    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name=None):
    """Dispatch on an integer index (reference switch_case)."""
    items = sorted(branch_fns.items()) if isinstance(branch_fns, dict) \
        else list(enumerate(branch_fns))
    pairs = [(branch_index == idx, fn) for idx, fn in items]
    return case(pairs, default=default)
