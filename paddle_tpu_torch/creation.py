"""Tensor creation ops (``paddle.to_tensor``, ``zeros``, ``rand`` …) —
counterpart of ``paddle_tpu/creation.py``.

Tensors are made on the current place (``core.place``: the card unless
``set_device("cpu")``), with the JAX package's result dtypes (a Python
float list or a float64 array gives float32, a Python int list or an
int64 array int32). Random ops draw from the framework key stream
(:mod:`paddle_tpu_torch.random`), so a seed gives the JAX package's
draws.
"""

from __future__ import annotations

import numpy as np
import torch

from . import random as _random
from .core.dispatch import apply, unwrap
from .core.dtype import canonical_dtype, get_default_dtype
from .core.place import current_place
from .core.tensor import Parameter, Tensor, to_torch


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dtype(dtype):
    return canonical_dtype(dtype) or canonical_dtype(get_default_dtype())


def _dev(place=None):
    return (place or current_place()).torch_device()


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    d = canonical_dtype(dtype)
    if isinstance(data, Tensor):
        v = data._value.detach()
        v = v.to(device=_dev(place) if place is not None else v.device,
                 dtype=d or v.dtype, copy=True)
    else:
        if d is None and isinstance(data, (list, tuple, int, float)):
            if np.asarray(data).dtype == np.float64:
                d = _dtype(None)
        v = to_torch(data, _dev(place))
        if d is not None and v.dtype != d:
            v = v.to(d)
    return Tensor(v, stop_gradient=stop_gradient)


def zeros(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.zeros(_shape(shape), dtype=_dtype(dtype), device=_dev()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.ones(_shape(shape), dtype=_dtype(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    fill_value = unwrap(fill_value) if isinstance(fill_value, Tensor) else fill_value
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_dtype(dtype),
                             device=_dev()))


def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None) -> Tensor:
    return apply(lambda v: torch.zeros_like(v, dtype=canonical_dtype(dtype)), x,
                 op_name="zeros_like")


def ones_like(x, dtype=None, name=None) -> Tensor:
    return apply(lambda v: torch.ones_like(v, dtype=canonical_dtype(dtype)), x,
                 op_name="ones_like")


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    return apply(lambda v: torch.full_like(v, fill_value, dtype=canonical_dtype(dtype)), x,
                 op_name="full_like")


empty_like = zeros_like


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    start = unwrap(start).item() if isinstance(start, Tensor) else start
    end = unwrap(end).item() if isinstance(end, Tensor) else end
    step = unwrap(step).item() if isinstance(step, Tensor) else step
    if end is None:
        start, end = 0, start
    d = canonical_dtype(dtype)
    if d is None:
        d = torch.int32 if builtins_all_int(start, end, step) else _dtype(None)
    return Tensor(torch.arange(start, end, step, dtype=d, device=_dev()))


def builtins_all_int(*xs) -> bool:
    return all(isinstance(x, (int, np.integer)) for x in xs)


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    return Tensor(torch.linspace(start, stop, int(num), dtype=_dtype(dtype),
                                 device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None) -> Tensor:
    return Tensor(torch.logspace(start, stop, int(num), base=base,
                                 dtype=_dtype(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    n = int(num_rows)
    m = int(num_columns) if num_columns else n
    return Tensor(torch.eye(n, m, dtype=_dtype(dtype), device=_dev()))


def meshgrid(*args, **kwargs):
    tensors = [x if isinstance(x, Tensor) else Tensor(x) for x in
               (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args)]
    outs = apply(lambda *vs: tuple(torch.meshgrid(*vs, indexing="ij")), *tensors,
                 op_name="meshgrid")
    return list(outs)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """The main diagonal over the last two axes, whatever ``offset``,
    ``dim1`` and ``dim2`` say (the JAX package ignores them too)."""
    return apply(lambda v: torch.diag_embed(v), x, op_name="diag_embed")


# ---------------------------------------------------------------------------
# random creation
# ---------------------------------------------------------------------------
def _float_draw(draw, dtype):
    d = _dtype(dtype)
    return draw if d == torch.float32 else draw.to(d)


def rand(shape, dtype=None, name=None) -> Tensor:
    k = _random.next_key()
    return Tensor(_float_draw(_random.uniform_draw(k, _shape(shape), device=_dev()),
                              dtype))


def randn(shape, dtype=None, name=None) -> Tensor:
    k = _random.next_key()
    return Tensor(_float_draw(_random.normal_draw(k, _shape(shape), device=_dev()),
                              dtype))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None) -> Tensor:
    from .inference import prng
    k = _random.next_key() if seed == 0 else prng.prng_key(seed)
    return Tensor(_float_draw(_random.uniform_draw(k, _shape(shape), min, max,
                                                   device=_dev()), dtype))


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = unwrap(mean) if isinstance(mean, Tensor) else mean
        s = unwrap(std) if isinstance(std, Tensor) else std
        shp = torch.broadcast_shapes(tuple(np.shape(m)), tuple(np.shape(s)))
        dev = (m if isinstance(m, torch.Tensor) else s).device
        k = _random.next_key()
        return Tensor(_random.normal_draw(k, shp, device=dev) * s + m)
    k = _random.next_key()
    return Tensor(_random.normal_draw(k, _shape(shape), device=_dev()) * std + mean)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    k = _random.next_key()
    out = _random.randint_draw(k, _shape(shape), low, high, device=_dev())
    return Tensor(out.to(canonical_dtype(dtype)))


def randperm(n, dtype="int64", name=None) -> Tensor:
    k = _random.next_key()
    return Tensor(_random.permutation_draw(k, int(n), device=_dev()).to(
        canonical_dtype(dtype)))


def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    k = _random.next_key()

    def fn(v):
        logits = torch.log(torch.clamp_min(v, 1e-30))
        if replacement or num_samples == 1:
            return _random.categorical_draw(
                k, logits, tuple(v.shape[:-1]) + (num_samples,)).to(torch.int32)
        # without replacement: the Gumbel top-k trick
        g = _random.gumbel_draw(k, v.shape, v.device)
        return torch.topk(logits + g, num_samples, dim=-1).indices.to(torch.int32)

    return apply(fn, x, op_name="multinomial")


def bernoulli(x, name=None) -> Tensor:
    k = _random.next_key()
    return apply(lambda v: _random.bernoulli_draw(k, v, v.shape, v.device).to(v.dtype),
                 x, op_name="bernoulli")


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle layout [out_c, in_c, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def create_parameter(shape, dtype=None, default_initializer=None, is_bias=False,
                     attr=None, name=None) -> Parameter:
    """A Parameter of ``shape``: zeros for a bias, else the
    ``default_initializer`` (a callable ``(shape, dtype) -> value``), by
    default Xavier-normal drawn from the key stream (the JAX package's
    ``nn.initializer.XavierNormal``: the same draw for the same seed)."""
    d = _dtype(dtype)
    shp = _shape(shape)
    if default_initializer is not None:
        value = default_initializer(shp, d)
    elif is_bias:
        value = torch.zeros(shp, dtype=d, device=_dev())
    else:
        fi, fo = _fans(shp)
        std = float(np.sqrt(2.0 / (fi + fo)))
        value = (_random.normal_draw(_random.next_key(), shp, device=_dev())
                 * std).to(d)
    return Parameter(value, name=name)
