"""``nn.functional`` — counterpart of ``paddle_tpu/nn/functional.py``:
the activations, dropouts, convolutions and pools, norms, padding and
resizing, losses and attention of the reference, with its signatures.

Each takes ``core.tensor.Tensor``s, as the reference's do: they go
through ``core.dispatch.apply`` under the reference's op name (which the
AMP lists key on) and a Tensor comes out; a numpy array is made a Tensor
first, as the reference's ``_t`` does. Given torch tensors, each runs
directly on them (the ported models call them so).

Random functions take their key from the framework stream
(``random.next_key()``) exactly where the reference takes it, so the two
packages stay in step: ``dropout`` and its relatives only when they
drop, ``gumbel_softmax`` and training ``rrelu`` on every call, and
``scaled_dot_product_attention`` whenever a mask or dropout is given.
Their masks are the reference's bits (``random.bernoulli_draw``).

Only LayerNorm, RMSNorm and the unmasked attention reach hand-written
kernels (rows 8, 1-2 and 5-6). Everything else here is plain PyTorch on
either device, as the reference computes it outside any Pallas kernel:
torch's convolutions and pools stand for XLA's. A masked or dropout
attention is the reference's XLA path ``_sdpa_masked``: fp32 scores, the
mask, softmax, the dropout mask on P, then ``P·V``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dispatch import any_tensor, apply, unwrap
from ..core.dtype import canonical_dtype, convert_dtype
from ..core.tensor import Tensor
from ..ops import flash_attention as fa
from ..ops import rms_norm as rn
from ..ops.fused_transformer_block import layer_norm_array

_NEG_INF = -1e30        # the reference's masked-score fill (flash_attention.py)


def _run(fn, *args, op_name, n_outputs=None):
    """``fn`` over the torch values of ``args``: through the dispatcher
    when any is a Tensor (a numpy array becomes one), else directly."""
    args = tuple(Tensor(a) if isinstance(a, np.ndarray) else a for a in args)
    if any_tensor(*args):
        return apply(fn, *args, op_name=op_name, n_outputs=n_outputs)
    return fn(*args)


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _where0(cond, v):
    return torch.where(cond, v, torch.zeros((), dtype=v.dtype,
                                            device=v.device))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def relu(x, name=None):
    return _run(F.relu, x, op_name="relu")


def relu6(x, name=None):
    return _run(F.relu6, x, op_name="relu6")


def leaky_relu(x, negative_slope=0.01, name=None):
    return _run(lambda v: F.leaky_relu(v, negative_slope), x,
                op_name="leaky_relu")


def prelu(x, weight, name=None):
    return _run(lambda v, w: torch.where(v >= 0, v, w * v), x, weight,
                op_name="prelu")


def elu(x, alpha=1.0, name=None):
    return _run(lambda v: F.elu(v, alpha), x, op_name="elu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _run(lambda v: scale * torch.where(v > 0, v, alpha * torch.expm1(v)),
                x, op_name="selu")


def celu(x, alpha=1.0, name=None):
    return _run(lambda v: F.celu(v, alpha), x, op_name="celu")


def gelu(x, approximate=False, name=None):
    """``jax.nn.gelu(x, approximate=approximate)``: the exact erf form
    by default here (l.61-62), unlike ``jax.nn.gelu``'s own default."""
    return _run(lambda v: F.gelu(v, approximate="tanh" if approximate
                                 else "none"), x, op_name="gelu")


def silu(x, name=None):
    return _run(F.silu, x, op_name="silu")


swish = silu


def _softplus0(v):
    """``jax.nn.softplus``: ``log(1 + exp(v))`` as ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


def mish(x, name=None):
    return _run(lambda v: v * torch.tanh(_softplus0(v)), x, op_name="mish")


def hardswish(x, name=None):
    return _run(lambda v: v * torch.clamp(v + 3, 0, 6) / 6, x,
                op_name="hardswish")


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    return _run(lambda v: torch.clamp(v * slope + offset, 0, 1), x,
                op_name="hardsigmoid")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _run(lambda v: torch.clamp(v, min, max), x, op_name="hardtanh")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _run(lambda v: torch.where(v * beta > threshold, v,
                                      torch.log1p(torch.exp(beta * v)) / beta),
                x, op_name="softplus")


def softsign(x, name=None):
    return _run(lambda v: v / (1 + torch.abs(v)), x, op_name="softsign")


def tanhshrink(x, name=None):
    return _run(lambda v: v - torch.tanh(v), x, op_name="tanhshrink")


def hardshrink(x, threshold=0.5, name=None):
    return _run(lambda v: _where0(torch.abs(v) > threshold, v), x,
                op_name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    def fn(v):
        z = torch.zeros((), dtype=v.dtype, device=v.device)
        return torch.where(v > threshold, v - threshold,
                           torch.where(v < -threshold, v + threshold, z))
    return _run(fn, x, op_name="softshrink")


def sigmoid(x, name=None):
    return _run(torch.sigmoid, x, op_name="sigmoid")


def tanh(x, name=None):
    return _run(torch.tanh, x, op_name="tanh")


def softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)

    def fn(v):
        if d is not None:
            v = v.to(d)
        return torch.softmax(v, dim=axis)
    return _run(fn, x, op_name="softmax")


def log_softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)

    def fn(v):
        if d is not None:
            v = v.to(d)
        return torch.log_softmax(v, dim=axis)
    return _run(fn, x, op_name="log_softmax")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    k = _random.next_key()

    def fn(v):
        g = _random.gumbel_draw(k, tuple(v.shape), v.device).to(v.dtype)
        y = torch.softmax((v + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            y = y_hard + (-y).detach() + y        # straight-through
        return y
    return _run(fn, x, op_name="gumbel_softmax")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return _run(lambda v: v / torch.clamp_min(torch.linalg.vector_norm(
        v, ord=p, dim=axis, keepdim=True), epsilon), x, op_name="normalize")


def log_sigmoid(x, name=None):
    return _run(F.logsigmoid, x, op_name="log_sigmoid")


def glu(x, axis=-1, name=None):
    return _run(lambda v: F.glu(v, dim=axis), x, op_name="glu")


def maxout(x, groups, axis=1, name=None):
    def fn(v):
        ax = axis % v.dim()
        c = v.shape[ax]
        shape = tuple(v.shape[:ax]) + (c // groups, groups) + tuple(
            v.shape[ax + 1:])
        return v.reshape(shape).amax(dim=ax + 1)
    return _run(fn, x, op_name="maxout")


def thresholded_relu(x, threshold=1.0, name=None):
    return _run(lambda v: _where0(v > threshold, v), x,
                op_name="thresholded_relu")


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True, name=None):
    """Randomized leaky ReLU: a slope drawn in ``[lower, upper]`` when
    training, the mean slope otherwise."""
    if not training:
        slope = (lower + upper) / 2.0
        return _run(lambda v: torch.where(v >= 0, v, slope * v), x,
                    op_name="rrelu")
    key = _random.next_key()

    def fn(v):
        a = _random.uniform_draw(key, tuple(v.shape), lower, upper, v.device)
        return torch.where(v >= 0, v, (a * v.float()).to(v.dtype))
    return _run(fn, x, op_name="rrelu")


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------
def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)`` with the reference's ``(in, out)`` weight
    (l.170)."""
    if any_tensor(x, weight, bias):
        args = (x, weight) if bias is None else (x, weight, bias)
        return apply(linear, *args, op_name="linear")
    y = x @ weight
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by id (l.178); rows of id ``padding_idx`` are
    zeros. ``sparse`` changes nothing, as in the reference."""
    if any_tensor(x, weight):
        return apply(lambda i, w: embedding(i, w, padding_idx), x, weight,
                     op_name="embedding")
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def _one_hot(v, num_classes, dtype=torch.float32):
    """``jax.nn.one_hot``: an id outside ``[0, num_classes)`` is a row of
    zeros."""
    ar = torch.arange(num_classes, device=v.device)
    return (v.long()[..., None] == ar).to(dtype)


def one_hot(x, num_classes, name=None):
    return _run(lambda v: _one_hot(v, num_classes), x, op_name="one_hot")


def bilinear(x1, x2, weight, bias=None, name=None):
    def fn(a, b, w, bv):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out if bv is None else out + bv
    return _run(fn, x1, x2, weight, bias, op_name="bilinear")


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """The key is drawn only when training with ``p > 0`` (l.208-225)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return _run(lambda v: v * (1.0 - p), x, op_name="dropout_infer")
        return x
    key = _random.next_key()

    def fn(v):
        shape = list(v.shape)
        if axis is not None:
            axes = [axis] if isinstance(axis, int) else list(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = _random.bernoulli_draw(key, 1.0 - p, shape, v.device)
        if mode == "upscale_in_train":
            return _where0(keep, v / (1.0 - p)).to(v.dtype)
        return _where0(keep, v).to(v.dtype)
    return _run(fn, x, op_name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Channel-wise dropout for 5-D inputs."""
    if not training or p == 0.0:
        return x
    key = _random.next_key()

    def fn(v):
        if data_format == "NDHWC":
            mask_shape = (v.shape[0], 1, 1, 1, v.shape[-1])
        else:
            mask_shape = tuple(v.shape[:2]) + (1, 1, 1)
        keep = _random.bernoulli_draw(key, 1.0 - p, mask_shape, v.device)
        return _where0(keep, v / (1.0 - p))
    return _run(fn, x, op_name="dropout3d")


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    key = _random.next_key()
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale

    def fn(v):
        keep = _random.bernoulli_draw(key, 1.0 - p, tuple(v.shape), v.device)
        a = (1.0 / math.sqrt((1 - p) * (1 + p * alpha_p ** 2))) if p < 1 else 0.0
        b = -a * alpha_p * p
        return (a * torch.where(keep, v, alpha_p) + b).to(v.dtype)
    return _run(fn, x, op_name="alpha_dropout")


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, nd):
    if isinstance(padding, str):
        return padding.upper()  # SAME / VALID
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and not isinstance(padding[0], (list, tuple)):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1])) for i in range(nd)]
    return [tuple(int(q) for q in p) for p in padding]


def _explicit_pads(pad, spatial, k, s, d):
    """XLA's ``SAME`` / ``VALID`` as explicit ``(lo, hi)`` pairs."""
    if pad == "VALID":
        return [(0, 0)] * len(spatial)
    if pad == "SAME":
        out = []
        for n, kk, ss, dd in zip(spatial, k, s, d):
            total = max((-(-n // ss) - 1) * ss + (kk - 1) * dd + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    return pad


def _torch_pad(pairs):
    """``(lo, hi)`` pairs over the leading spatial dims as ``F.pad``'s
    last-dim-first list."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _channel_first(v, channel_last):
    return torch.movedim(v, -1, 1) if channel_last else v


def _channel_back(v, channel_last):
    return torch.movedim(v, 1, -1) if channel_last else v


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             channel_last, op_name):
    stride = _pair(stride, nd)
    dilation = _pair(dilation, nd)
    pad = _conv_padding(padding, nd)

    def fn(v, w, b):
        v = _channel_first(v, channel_last)
        pads = _explicit_pads(pad, v.shape[2:], w.shape[2:], stride, dilation)
        if any(lo or hi for lo, hi in pads):
            v = F.pad(v, _torch_pad(pads))
        out = _CONV[nd](v, w, None, stride, 0, dilation, groups).to(v.dtype)
        if b is not None:
            out = out + b.reshape((1, -1) + (1,) * nd)
        return _channel_back(out, channel_last)
    return _run(fn, x, weight, bias, op_name=op_name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format == "NLC", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format == "NHWC", "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format == "NDHWC", "conv3d")


def _conv_transpose_impl(x, weight, bias, stride, padding, output_padding,
                         dilation, groups, nd, op_name,
                         _channel_last=False, output_size=None):
    """Transpose convolution with the reference's weight layout
    ``[in_c, out_c/groups, *k]`` (torch's own) and output size per dim
    ``(H-1)*s - p_lo - p_hi + d*(k-1) + 1 + out_pad``: torch's transpose
    convolution without padding, zero-extended by ``out_pad`` and
    cropped by the pads."""
    s = _pair(stride, nd)
    d = _pair(dilation, nd)
    pad = _conv_padding(padding, nd)
    if isinstance(pad, str):
        raise NotImplementedError("string padding for conv_transpose")
    op = _pair(output_padding, nd)
    if output_size is not None:
        if any(o != 0 for o in op):
            raise ValueError(
                f"{op_name}: output_padding and output_size are mutually "
                "exclusive")
        osz = _pair(output_size, nd)
        in_sp = x.shape[1:1 + nd] if _channel_last else x.shape[2:2 + nd]
        ksp = weight.shape[2:2 + nd]
        op = []
        for i in range(nd):
            base = ((in_sp[i] - 1) * s[i] - pad[i][0] - pad[i][1]
                    + d[i] * (ksp[i] - 1) + 1)
            o = osz[i] - base
            if not 0 <= o < max(s[i], d[i]):
                raise ValueError(
                    f"{op_name}: output_size[{i}]={osz[i]} unreachable "
                    f"(base size {base}, stride {s[i]})")
            op.append(o)
        op = tuple(op)

    def fn(v, w, b):
        v = _channel_first(v, _channel_last)
        full = _CONV_T[nd](v, w, None, s, 0, 0, groups, d)
        full = F.pad(full, _torch_pad([(0, o) for o in op]))
        idx = (slice(None), slice(None)) + tuple(
            slice(pad[i][0], full.shape[2 + i] - pad[i][1]) for i in range(nd))
        out = full[idx].to(v.dtype)
        if b is not None:
            out = out + b.reshape((1, -1) + (1,) * nd)
        return _channel_back(out, _channel_last)
    return _run(fn, x, weight, bias, op_name=op_name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 1,
                                "conv1d_transpose",
                                _channel_last=data_format == "NLC",
                                output_size=output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 2,
                                "conv2d_transpose",
                                _channel_last=data_format == "NHWC",
                                output_size=output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_impl(x, weight, bias, stride, padding,
                                output_padding, dilation, groups, 3,
                                "conv3d_transpose",
                                _channel_last=data_format == "NDHWC",
                                output_size=output_size)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
def _ceil_extra(sp, k, s, pad):
    """Per-dim extra high padding so the last partial window is included
    (paddle ceil_mode)."""
    extra = []
    for i in range(len(k)):
        span = sp[i] + pad[i][0] + pad[i][1] - k[i]
        extra.append((s[i] - span % s[i]) % s[i] if span % s[i] else 0)
    return extra


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(v, k, s):
    """Sums over every ``k`` window at stride ``s`` of an already padded
    (N, C, *sp) tensor (a depthwise convolution with ones)."""
    n, c = v.shape[:2]
    nd = len(k)
    ones = torch.ones((1, 1) + tuple(k), dtype=v.dtype, device=v.device)
    out = _CONV[nd](v.reshape((n * c, 1) + tuple(v.shape[2:])), ones,
                    stride=s)
    return out.reshape((n, c) + tuple(out.shape[2:]))


def _pool_nd(x, nd, kernel_size, stride, padding, reduce_op, op_name,
             exclusive=True, ceil_mode=False, return_mask=False,
             channel_last=False):
    k = _pair(kernel_size, nd)
    s = _pair(stride, nd) if stride is not None else k
    pad = _conv_padding(padding, nd)
    if isinstance(pad, str):
        raise NotImplementedError("string padding for pooling")
    pad = list(pad)

    def fn(v):
        v = _channel_first(v, channel_last)
        sp = tuple(v.shape[2:])
        extra = _ceil_extra(sp, k, s, pad) if ceil_mode else [0] * nd
        pads = [(pad[i][0], pad[i][1] + extra[i]) for i in range(nd)]
        if reduce_op == "max":
            low = (-math.inf if v.dtype.is_floating_point
                   else torch.iinfo(v.dtype).min)
            vp = F.pad(v, _torch_pad(pads), value=low)
            if not return_mask:
                return _channel_back(_MAX_POOL[nd](vp, k, s), channel_last)
            out, idx = _MAX_POOL[nd](vp, k, s, return_indices=True)
            # padded flat positions back to the input's own
            psp = vp.shape[2:]
            flat = torch.zeros_like(idx)
            for i in range(nd):
                inner = int(np.prod(psp[i + 1:]))
                coord = (idx // inner) % psp[i] - pads[i][0]
                flat = flat * sp[i] + coord
            return (_channel_back(out, channel_last),
                    _channel_back(flat.to(torch.int32), channel_last))
        vf = F.pad(v.float(), _torch_pad(pads))
        summed = _window_sum(vf, k, s)
        if exclusive:
            ones = F.pad(torch.ones_like(v, dtype=torch.float32),
                         _torch_pad(pads))
            out = (summed / _window_sum(ones, k, s)).to(v.dtype)
        else:
            out = (summed / float(np.prod(k))).to(v.dtype)
        return _channel_back(out, channel_last)

    n_outputs = 2 if (reduce_op == "max" and return_mask) else None
    return _run(fn, x, op_name=op_name, n_outputs=n_outputs)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _pool_nd(x, 1, kernel_size, stride, padding, "max", "max_pool1d",
                    ceil_mode=ceil_mode, return_mask=return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"max_pool2d: unknown data_format {data_format!r}")
    return _pool_nd(x, 2, kernel_size, stride, padding, "max", "max_pool2d",
                    ceil_mode=ceil_mode, return_mask=return_mask,
                    channel_last=data_format == "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if data_format not in ("NCDHW", "NDHWC"):
        raise ValueError(f"max_pool3d: unknown data_format {data_format!r}")
    return _pool_nd(x, 3, kernel_size, stride, padding, "max", "max_pool3d",
                    ceil_mode=ceil_mode, return_mask=return_mask,
                    channel_last=data_format == "NDHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_nd(x, 1, kernel_size, stride, padding, "avg", "avg_pool1d",
                    exclusive, ceil_mode=ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """The reference's own 2-D average (l.429): sums in the input's
    dtype, ``divisor_override`` first, then the count of real elements
    when ``exclusive`` (unless the padding is ``VALID``); ``ceil_mode``
    is not read."""
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    pad = _conv_padding(padding, 2)

    def fn(v):
        v = _channel_first(v, data_format != "NCHW")
        pads = _explicit_pads(pad, v.shape[2:], k, s, (1, 1))
        summed = _window_sum(F.pad(v, _torch_pad(pads)), k, s)
        if divisor_override:
            out = summed / divisor_override
        elif exclusive and pad != "VALID":
            ones = F.pad(torch.ones_like(v), _torch_pad(pads))
            out = summed / _window_sum(ones, k, s)
        else:
            out = summed / float(np.prod(k))
        return _channel_back(out, data_format != "NCHW")
    return _run(fn, x, op_name="avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(x, 3, kernel_size, stride, padding, "avg", "avg_pool3d",
                    exclusive, ceil_mode=ceil_mode)


def _adaptive_pool_nd(x, nd, output_size, reduce_op, op_name,
                      channel_last=False):
    outs = _pair(output_size, nd)

    def fn(v):
        v = _channel_first(v, channel_last)
        spatial = tuple(v.shape[2:])
        assert all(s % o == 0 for s, o in zip(spatial, outs)), \
            "adaptive pool requires divisible sizes"
        shape = tuple(v.shape[:2])
        for s, o in zip(spatial, outs):
            shape = shape + (o, s // o)
        v2 = v.reshape(shape)
        axes = tuple(3 + 2 * i for i in range(nd))
        out = v2.amax(dim=axes) if reduce_op == "max" else v2.mean(dim=axes)
        return _channel_back(out, channel_last)
    return _run(fn, x, op_name=op_name)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool_nd(x, 1, output_size, "avg", "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool_nd(x, 2, output_size, "avg", "adaptive_avg_pool2d",
                             data_format != "NCHW")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool_nd(x, 3, output_size, "avg", "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool_nd(x, 1, output_size, "max", "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool_nd(x, 2, output_size, "max", "adaptive_max_pool2d")


def _max_unpool_nd(x, indices, nd, kernel_size, stride, padding, output_size,
                   op_name):
    k = _pair(kernel_size, nd)
    s = _pair(stride, nd) if stride is not None else k
    p = _pair(padding, nd)

    def fn(v, idx):
        n, c = v.shape[:2]
        if output_size is not None:
            osp = tuple(output_size[-nd:])
        else:
            osp = tuple((v.shape[2 + i] - 1) * s[i] - 2 * p[i] + k[i]
                        for i in range(nd))
        total = int(np.prod(osp))
        flatv = v.reshape(n, c, -1)
        flati = idx.reshape(n, c, -1).long()
        if flati.numel():
            hi, lo = int(flati.max()), int(flati.min())
            if hi >= total or lo < 0:
                raise ValueError(
                    f"{op_name}: index {hi} out of range for output spatial "
                    f"size {osp} ({total} positions); pass the matching "
                    "output_size")
        out = torch.zeros((n, c, total), dtype=v.dtype, device=v.device)
        out = out.scatter(2, flati, flatv)
        return out.reshape((n, c) + osp)
    return _run(fn, x, indices, op_name=op_name)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    if data_format != "NCL":
        raise NotImplementedError("max_unpool1d: only NCL")
    return _max_unpool_nd(x, indices, 1, kernel_size, stride, padding,
                          output_size, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    if data_format != "NCHW":
        raise NotImplementedError("max_unpool2d: only NCHW")
    return _max_unpool_nd(x, indices, 2, kernel_size, stride, padding,
                          output_size, "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    if data_format != "NCDHW":
        raise NotImplementedError("max_unpool3d: only NCDHW")
    return _max_unpool_nd(x, indices, 3, kernel_size, stride, padding,
                          output_size, "max_unpool3d")


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes, fp32 math,
    output in ``x.dtype`` (l.495-518). With weight and bias it is the
    fused op (the Triton kernels for CUDA tensors)."""
    if any_tensor(x, weight, bias):
        args = [x] + [t for t in (weight, bias) if t is not None]
        has = (weight is not None, bias is not None)

        def fn(v, *rest):
            it = iter(rest)
            w = next(it) if has[0] else None
            b = next(it) if has[1] else None
            return layer_norm(v, normalized_shape, w, b, epsilon)
        return apply(fn, *args, op_name="layer_norm")
    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    lead = x.shape[:x.dim() - len(shape)]

    def flat(t):
        return None if t is None else t.reshape(-1)

    y = layer_norm_array(x.reshape(*lead, -1), flat(weight), flat(bias),
                         epsilon)
    return y.reshape(x.shape)


def rms_norm(x, weight, epsilon=1e-6, name=None):
    """RMSNorm over the last axis (l.521): the Triton kernels for CUDA
    tensors, the plain version for CPU ones."""
    return rn.rms_norm(x, weight, epsilon)


def _affine_c(out, w, b, shape):
    if w is not None:
        out = out * w.float().reshape(shape)
    if b is not None:
        out = out + b.float().reshape(shape)
    return out


def _stats(v, axes, keepdim):
    vf = v.float()
    return (vf.mean(dim=axes, keepdim=keepdim),
            vf.var(dim=axes, unbiased=False, keepdim=keepdim))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch statistics when training (``running = running·momentum +
    batch·(1 − momentum)``, the reference's convention, written in place
    into the running buffers with the biased variance); the running
    statistics otherwise."""
    c_axis = 1 if data_format in ("NCHW", "NCL", "NCDHW", "NC") else -1

    def shape_of(v):
        shape = [1] * v.dim()
        shape[c_axis % v.dim()] = -1
        return shape

    if training and not use_global_stats:
        def fn(v, w, b):
            axes = tuple(i for i in range(v.dim()) if i != (c_axis % v.dim()))
            mean, var = _stats(v, axes, False)
            shape = shape_of(v)
            out = (v.float() - mean.reshape(shape)) * torch.rsqrt(
                var.reshape(shape) + epsilon)
            return _affine_c(out, w, b, shape).to(v.dtype), mean, var

        out, mean, var = _run(fn, x, weight, bias, op_name="batch_norm",
                              n_outputs=3)
        if running_mean is not None:
            with torch.no_grad():
                for run, new in ((running_mean, mean), (running_var, var)):
                    r = unwrap(run)
                    r.copy_((r * momentum + unwrap(new).detach()
                             * (1 - momentum)).to(r.dtype))
        return out

    def fn_eval(v, m, s, w, b):
        shape = shape_of(v)
        out = (v.float() - m.float().reshape(shape)) * torch.rsqrt(
            s.float().reshape(shape) + epsilon)
        return _affine_c(out, w, b, shape).to(v.dtype)
    return _run(fn_eval, x, running_mean, running_var, weight, bias,
                op_name="batch_norm_eval")


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-05,
               data_format="NCHW", name=None):
    def fn(v, w, b):
        n, c = v.shape[0], v.shape[1]
        rest = tuple(v.shape[2:])
        vg = v.reshape((n, num_groups, c // num_groups) + rest).float()
        axes = tuple(range(2, vg.dim()))
        mean, var = _stats(vg, axes, True)
        out = ((vg - mean) * torch.rsqrt(var + epsilon)).reshape(v.shape)
        return _affine_c(out, w, b, (1, c) + (1,) * len(rest)).to(v.dtype)
    return _run(fn, x, weight, bias, op_name="group_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    def fn(v, w, b):
        mean, var = _stats(v, tuple(range(2, v.dim())), True)
        out = (v.float() - mean) * torch.rsqrt(var + eps)
        return _affine_c(out, w, b, (1, -1) + (1,) * (v.dim() - 2)
                         ).to(v.dtype)
    return _run(fn, x, weight, bias, op_name="instance_norm")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """AlexNet-style LRN across channels."""
    def fn(v):
        sq = (v * v).float()
        half = size // 2
        # a window sum over the channel axis, as a 1-wide pool
        flat = sq.reshape((sq.shape[0], 1, sq.shape[1], -1))
        flat = F.pad(flat, (0, 0, half, size - 1 - half))
        acc = _window_sum(flat, (size, 1), (1, 1)).reshape(sq.shape)
        div = (k + alpha * acc / size) ** beta
        return v / div.to(v.dtype)
    return _run(fn, x, op_name="local_response_norm")


# ---------------------------------------------------------------------------
# padding / resize / patches
# ---------------------------------------------------------------------------
def _pad_index(n, lo, hi, mode, device):
    """Source indices of one axis padded by ``(lo, hi)`` in numpy's
    ``reflect`` / ``edge`` / ``wrap`` modes."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    def fn(v):
        if len(pad) == v.dim() * 2:
            widths = [(int(pad[2 * i]), int(pad[2 * i + 1]))
                      for i in range(v.dim())]
        else:
            # paddle convention: pad pairs run innermost-dim first
            # ([left, right, top, bottom, ...] — W before H), over the
            # spatial dims of the given data_format.
            nd = len(pad) // 2
            if data_format in ("NHWC", "NLC", "NDHWC"):
                spatial = list(range(1, v.dim() - 1))
            else:
                spatial = list(range(2, v.dim()))
            widths = [(0, 0)] * v.dim()
            for i in range(nd):
                dim = spatial[len(spatial) - 1 - i]
                widths[dim] = (int(pad[2 * i]), int(pad[2 * i + 1]))
        nmode = {"constant": "constant", "reflect": "reflect",
                 "replicate": "edge", "circular": "wrap"}[mode]
        if nmode == "constant":
            return F.pad(v, _torch_pad(widths), value=value)
        for dim, (lo, hi) in enumerate(widths):
            if lo or hi:
                v = v.index_select(dim, _pad_index(v.shape[dim], lo, hi,
                                                   nmode, v.device))
        return v
    return _run(fn, x, op_name="pad")


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """``pad`` with zeros, ``padding = [left, right, top, bottom]``."""
    return pad(x, list(padding), mode="constant", value=0.0,
               data_format=data_format)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image``'s ``compute_weight_mat`` (antialiased, half-pixel
    centres) as an (in, out) fp32 matrix."""
    scale = n_out / n_in
    inv = 1.0 / scale
    ks = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    xs = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                         device=device)[:, None]).abs() / ks
    w = kernel(xs)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _jax_resize(v, out_hw, method):
    """``jax.image.resize`` of an NCHW tensor over H and W."""
    for axis, n_out in zip((2, 3), out_hw):
        n_in = v.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32)
                               + 0.5) * n_in / n_out).long().to(v.device)
            v = v.index_select(axis, idx)
            continue
        kern = _triangle if method == "linear" else _keys_cubic
        w = _resize_weights(n_in, n_out, kern, v.device).to(v.dtype)
        v = torch.movedim(torch.movedim(v, axis, -1) @ w, -1, axis)
    return v


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW", name=None):
    """``jax.image.resize`` as the reference calls it (l.665): half-pixel
    centres, antialiased when shrinking, Keys cubic; ``align_corners``
    is not read and "area" is linear."""
    def fn(v):
        if data_format != "NCHW":
            raise NotImplementedError(data_format)
        h, w = v.shape[2], v.shape[3]
        if size is not None:
            oh, ow = _pair(size)
        else:
            sf = _pair(scale_factor) if not isinstance(
                scale_factor, (int, float)) else (scale_factor, scale_factor)
            oh, ow = int(h * sf[0]), int(w * sf[1])
        method = {"nearest": "nearest", "bilinear": "linear",
                  "bicubic": "cubic", "area": "linear"}[mode]
        return _jax_resize(v, (oh, ow), method).to(v.dtype)
    return _run(fn, x, op_name="interpolate")


upsample = interpolate


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    k, s, p, d = (_pair(kernel_sizes), _pair(strides), _pair(paddings),
                  _pair(dilations))
    return _run(lambda v: F.unfold(v, k, d, p, s), x, op_name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """Inverse of unfold (col2im): (N, C·kh·kw, L) -> (N, C, H, W), the
    overlapping patch contributions summed."""
    o, k, s, p, d = (_pair(output_sizes), _pair(kernel_sizes),
                     _pair(strides), _pair(paddings), _pair(dilations))
    return _run(lambda v: F.fold(v, o, k, d, p, s), x, op_name="fold")


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta (N, 2, 3) → sampling grid (N, H, W, 2) in [-1, 1]."""
    n, _, h, w = [int(v) for v in out_shape]

    def base(steps, device):
        if align_corners:
            return torch.linspace(-1.0, 1.0, steps, device=device)
        half = 1.0 - 1.0 / steps
        return torch.linspace(-half, half, steps, device=device)

    def fn(th):
        gy, gx = torch.meshgrid(base(h, th.device), base(w, th.device),
                                indexing="ij")
        coords = torch.stack([gx, gy, torch.ones_like(gx)], -1)
        return torch.einsum("hwk,njk->nhwj", coords, th.float()).to(th.dtype)
    return _run(fn, theta, op_name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at ``grid`` locations in [-1, 1]: gathers and
    lerps, as the reference computes them."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample: unknown mode {mode!r}")
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sample: padding_mode {padding_mode!r} not supported "
            "(use 'zeros' or 'border')")

    def fn(v, g):
        nb, c, h, w = v.shape
        gx, gy = g[..., 0].float(), g[..., 1].float()
        if align_corners:
            fx = (gx + 1.0) * (w - 1) / 2.0
            fy = (gy + 1.0) * (h - 1) / 2.0
        else:
            fx = ((gx + 1.0) * w - 1.0) / 2.0
            fy = ((gy + 1.0) * h - 1.0) / 2.0
        bi = torch.arange(nb, device=v.device)[:, None, None]

        def gather(ix, iy):
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            if padding_mode == "border":
                inside = torch.ones_like(inside)
            vals = v.permute(0, 2, 3, 1)[bi, iy.clamp(0, h - 1),
                                         ix.clamp(0, w - 1)]
            vals = torch.movedim(vals, -1, 1)
            return vals * inside[:, None].to(v.dtype)

        if mode == "nearest":
            return gather(torch.round(fx).long(), torch.round(fy).long())
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        x1, y1 = x0 + 1, y0 + 1
        wx = (fx - x0).to(v.dtype)[:, None]
        wy = (fy - y0).to(v.dtype)[:, None]
        top = gather(x0, y0) * (1 - wx) + gather(x1, y0) * wx
        bot = gather(x0, y1) * (1 - wx) + gather(x1, y1) * wx
        return top * (1 - wy) + bot * wy
    return _run(fn, x, grid, op_name="grid_sample")


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def fn(v):
        n, c, h, w = v.shape
        v6 = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v6.reshape(n, c // (r * r), h * r, w * r)
    return _run(fn, x, op_name="pixel_shuffle")


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    def fn(v):
        nt, c, h, w = v.shape
        v5 = v.reshape(nt // seg_num, seg_num, c, h, w)
        fold_ = int(c * shift_ratio)
        left = torch.roll(v5[:, :, :fold_], -1, dims=1)
        left[:, -1] = 0.0
        right = torch.roll(v5[:, :, fold_:2 * fold_], 1, dims=1)
        right[:, 0] = 0.0
        return torch.cat([left, right, v5[:, :, 2 * fold_:]],
                         dim=2).reshape(nt, c, h, w)
    return _run(fn, x, op_name="temporal_shift")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` (the longest length when ``maxlen``
    is None)."""
    xv = x._value if isinstance(x, Tensor) else torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    ml = int(xv.max()) if maxlen is None else int(maxlen)
    out = torch.arange(ml, device=xv.device) < xv[..., None]
    return Tensor(out.to(canonical_dtype(dtype)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy in fp32 over ``axis`` (l.854-889). Hard
    labels: positions labelled ``ignore_index`` score 0 and the mean is
    ``Σ loss / max(count, 1)``; class ``weight``s scale each position;
    ``label_smoothing`` mixes in the uniform target. Soft labels:
    ``−Σ target·log p`` (times ``Σ weight·target``), reduced plainly.
    Without ``use_softmax`` the input is taken as probabilities."""
    def fn(logits, lab, w):
        lg = logits.float()
        logp = (torch.log_softmax(lg, dim=axis) if use_softmax
                else torch.log(torch.clamp_min(lg, 1e-30)))
        if soft_label:
            tgt = lab.float()
            loss = -(tgt * logp).sum(dim=axis)
            if w is not None:
                loss = loss * (w * tgt).sum(dim=axis)
            return _reduce_loss(loss, reduction)
        li = lab.long()
        if li.dim() == logp.dim():
            li = li.squeeze(axis)
        mask = li != ignore_index
        safe = torch.where(mask, li, 0)
        ax = axis % logp.dim()
        nclass = logp.shape[ax]
        if label_smoothing > 0.0:
            onehot = torch.movedim(_one_hot(safe, nclass), -1, ax)
            tgt = onehot * (1 - label_smoothing) + label_smoothing / nclass
            loss = -(tgt * logp).sum(dim=ax)
        else:
            loss = -torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
        if w is not None:
            loss = loss * w[safe]
        loss = _where0(mask, loss)
        if reduction == "mean":
            return loss.sum() / mask.sum().clamp(min=1)
        return _reduce_loss(loss, reduction)
    return _run(fn, input, label, weight, op_name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    def fn(logp, lab, w):
        li = lab.long()
        mask = li != ignore_index
        safe = torch.where(mask, li, 0)
        loss = -torch.gather(logp, -1, safe[..., None])[..., 0]
        if w is not None:
            loss = loss * w[safe]
        loss = _where0(mask, loss)
        if reduction == "mean":
            return loss.sum() / mask.sum().clamp(min=1)
        return _reduce_loss(loss, reduction)
    return _run(fn, input, label, weight, op_name="nll_loss")


def mse_loss(input, label, reduction="mean", name=None):
    return _run(lambda a, b: _reduce_loss(torch.square(a - b), reduction),
                input, label, op_name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return _run(lambda a, b: _reduce_loss(torch.abs(a - b), reduction),
                input, label, op_name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def fn(a, b):
        d = torch.abs(a - b)
        return _reduce_loss(torch.where(d < delta, 0.5 * d * d / delta,
                                        d - 0.5 * delta), reduction)
    return _run(fn, input, label, op_name="smooth_l1_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def fn(p, y, w):
        p32 = torch.clamp(p.float(), 1e-12, 1 - 1e-12)
        loss = -(y * torch.log(p32) + (1 - y) * torch.log1p(-p32))
        if w is not None:
            loss = loss * w
        return _reduce_loss(loss, reduction)
    return _run(fn, input, label, weight, op_name="bce")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def fn(z, y, pw, w):
        z32, y32 = z.float(), y.float()
        base = (torch.clamp_min(z32, 0) - z32 * y32
                + torch.log1p(torch.exp(-torch.abs(z32))))
        if pw is not None:
            base = -(pw * y32 * F.logsigmoid(z32)
                     + (1 - y32) * F.logsigmoid(-z32))
        if w is not None:
            base = base * w
        return _reduce_loss(base, reduction)
    return _run(fn, logit, label, pos_weight, weight,
                op_name="bce_with_logits")


def kl_div(input, label, reduction="mean", name=None):
    def fn(logp, tgt):
        loss = tgt * (torch.log(torch.clamp_min(tgt, 1e-30)) - logp)
        if reduction == "batchmean":
            return loss.sum() / logp.shape[0]
        return _reduce_loss(loss, reduction)
    return _run(fn, input, label, op_name="kl_div")


def square_error_cost(input, label):
    return _run(lambda a, b: torch.square(a - b), input, label,
                op_name="square_error_cost")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _run(lambda a, b, y: _reduce_loss(
        torch.clamp_min(-y * (a - b) + margin, 0.0), reduction),
        input, other, label, op_name="margin_ranking_loss")


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    def fn(a, b):
        num = (a * b).sum(dim=axis)
        den = (torch.linalg.vector_norm(a, dim=axis)
               * torch.linalg.vector_norm(b, dim=axis))
        return num / torch.clamp_min(den, eps)
    return _run(fn, x1, x2, op_name="cosine_similarity")


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    def fn(a, b):
        d = torch.abs(a - b).float() + epsilon
        out = (d ** p).sum(dim=-1) ** (1.0 / p)
        return out[..., None] if keepdim else out
    return _run(fn, x, y, op_name="pairwise_distance")


def log_loss(input, label, epsilon=1e-4, name=None):
    def fn(p, y):
        p = p.float()
        return -(y * torch.log(p + epsilon)
                 + (1 - y) * torch.log(1 - p + epsilon))
    return _run(fn, input, label, op_name="log_loss")


def dice_loss(input, label, epsilon=1e-5, name=None):
    """input (N, ..., C) probabilities, label (N, ..., 1) int."""
    def fn(p, y):
        n, c = p.shape[0], p.shape[-1]
        pf = p.reshape(n, -1, c).float()
        oh = _one_hot(y.reshape(n, -1), c)
        inter = (pf * oh).sum(dim=(1, 2))
        union = pf.sum(dim=(1, 2)) + oh.sum(dim=(1, 2))
        return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()
    return _run(fn, input, label, op_name="dice_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _run(lambda x, y: _reduce_loss(
        torch.log1p(torch.exp(-y * x.float())), reduction),
        input, label, op_name="soft_margin_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    def fn(x, y):
        xf = x.float()
        return _reduce_loss(torch.where(y == 1.0, xf,
                                        torch.clamp_min(margin - xf, 0.0)),
                            reduction)
    return _run(fn, input, label, op_name="hinge_embedding_loss")


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    def fn(x, y):
        xf, yf = x.float(), y.float()
        if log_input:
            out = torch.exp(xf) - yf * xf
        else:
            out = xf - yf * torch.log(xf + epsilon)
        if full:
            stirling = (yf * torch.log(yf + epsilon) - yf
                        + 0.5 * torch.log(2 * math.pi * (yf + epsilon)))
            out = out + _where0(yf > 1, stirling)
        return _reduce_loss(out, reduction)
    return _run(fn, input, label, op_name="poisson_nll_loss")


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def fn(mu, y, var):
        var = torch.clamp_min(var.float(), epsilon)
        out = 0.5 * (torch.log(var) + (y.float() - mu.float()) ** 2 / var)
        if full:
            out = out + 0.5 * math.log(2 * math.pi)
        return _reduce_loss(out, reduction)
    return _run(fn, input, label, variance, op_name="gaussian_nll_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def fn(x, y, nrm):
        xf = x.float()
        p = torch.sigmoid(xf)
        ce = (torch.clamp_min(xf, 0) - xf * y
              + torch.log1p(torch.exp(-torch.abs(xf))))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        out = a_t * ((1 - p_t) ** gamma) * ce
        if nrm is not None:
            out = out / nrm
        return _reduce_loss(out, reduction)
    return _run(fn, logit, label, normalizer, op_name="sigmoid_focal_loss")


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    def fn(x, y, w):
        xf = x.float()
        out = -(y * F.logsigmoid(xf) + (1 - y) * F.logsigmoid(-xf))
        if w is not None:
            out = out * w
        return _reduce_loss(out.mean(dim=-1), reduction)
    return _run(fn, input, label, weight,
                op_name="multi_label_soft_margin_loss")


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def fn(a, b, y):
        af, bf = a.float(), b.float()
        cos = (af * bf).sum(-1) / (torch.linalg.vector_norm(af, dim=-1)
                                   * torch.linalg.vector_norm(bf, dim=-1)
                                   + 1e-12)
        out = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0))
        return _reduce_loss(out, reduction)
    return _run(fn, input1, input2, label, op_name="cosine_embedding_loss")


def _p_dist(u, v, p, epsilon):
    d = torch.abs(u - v).float() + epsilon
    return (d ** p).sum(dim=-1) ** (1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def fn(a, pos, neg):
        dp = _p_dist(a, pos, p, epsilon)
        dn = _p_dist(a, neg, p, epsilon)
        if swap:
            dn = torch.minimum(dn, _p_dist(pos, neg, p, epsilon))
        return _reduce_loss(torch.clamp_min(dp - dn + margin, 0.0), reduction)
    return _run(fn, input, positive, negative, op_name="triplet_margin_loss")


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dpn = distance_function(positive, negative)
        dn = _run(torch.minimum, dn, dpn, op_name="triplet_swap")
    return _run(lambda a, b: _reduce_loss(
        torch.clamp_min(a.float() - b.float() + margin, 0.0), reduction),
        dp, dn, op_name="triplet_margin_with_distance_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    def fn(a, pos, y):
        af, pf = a.float(), pos.float()
        sim = af @ pf.T
        same = (y[:, None] == y[None, :]).float()
        tgt = same / same.sum(dim=1, keepdim=True)
        xent = (-tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
        reg = l2_reg * ((af * af).sum(-1).mean()
                        + (pf * pf).sum(-1).mean()) * 0.25
        return xent + reg
    return _run(fn, anchor, positive, labels, op_name="npair_loss")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace/CosFace-style margin softmax over cosine logits."""
    def fn(lg, y):
        lf = torch.clamp(lg.float(), -1.0, 1.0)
        theta = torch.arccos(lf)
        yi = y.long()
        oh = _one_hot(yi, lg.shape[-1])
        adj = torch.cos(margin1 * theta + margin2) - margin3
        lf = torch.where(oh > 0, adj, lf) * scale
        logp = torch.log_softmax(lf, dim=-1)
        loss = -torch.gather(logp, -1, yi[:, None])[:, 0]
        loss = _reduce_loss(loss, reduction)
        return (loss, torch.exp(logp)) if return_softmax else loss
    return _run(fn, logits, label, op_name="margin_cross_entropy",
                n_outputs=2 if return_softmax else None)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Connectionist temporal classification: the alpha recursion in log
    space, a loop over time. log_probs (T, B, C) log-softmaxed; labels
    (B, L) padded; lengths (B,)."""
    def fn(lp, lab, ilen, llen):
        T, B, _ = lp.shape
        S = 2 * lab.shape[1] + 1
        dev = lp.device
        lab = lab.long()
        ilen, llen = ilen.long(), llen.long()
        ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = lab
        ext_prev2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                          device=dev), ext[:, :-2]], dim=1)
        can_skip = (ext != blank) & (ext != ext_prev2)
        neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
        s_idx = torch.arange(S, device=dev)[None, :]
        valid_s = s_idx < (2 * llen[:, None] + 1)
        alpha = torch.where(s_idx < 2, torch.gather(lp[0], -1, ext), neg)
        alpha = torch.where(valid_s, alpha, neg)
        alphas = [alpha]
        for t in range(1, T):
            a1 = torch.cat([neg.expand(B, 1), alpha[:, :-1]], dim=1)
            a2 = torch.cat([neg.expand(B, 2), alpha[:, :-2]], dim=1)
            a2 = torch.where(can_skip, a2, neg)
            m = torch.maximum(alpha, torch.maximum(a1, a2))
            tot = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                                + torch.exp(a2 - m) + 1e-35)
            alpha = torch.where(valid_s, tot + torch.gather(lp[t], -1, ext),
                                neg)
            alphas.append(alpha)
        alphas = torch.stack(alphas)                           # (T, B, S)
        t_idx = torch.clamp(ilen - 1, 0, T - 1)
        final = alphas[t_idx, torch.arange(B, device=dev)]     # (B, S)
        sl = 2 * llen
        a_last = torch.gather(final, 1, sl[:, None])[:, 0]
        a_prev = torch.gather(final, 1, torch.clamp_min(sl - 1, 0)[:, None])[:, 0]
        m = torch.maximum(a_last, a_prev)
        loss = -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)
                               + 1e-35))
        if norm_by_times:
            loss = loss / torch.clamp_min(ilen.float(), 1.0)
        if reduction == "mean":
            return (loss / torch.clamp_min(llen.float(), 1.0)).mean()
        return _reduce_loss(loss, reduction)
    return _run(fn, log_probs, labels, input_lengths, label_lengths,
                op_name="ctc_loss")


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """Multi-class hinge loss."""
    def fn(x, y, w):
        n, c = x.shape
        y = y.long()
        x_y = torch.gather(x, 1, y[:, None])
        diff = torch.clamp_min(margin - x_y + x, 0.0) ** p
        if w is not None:
            diff = diff * w[y][:, None]
        mask = torch.arange(c, device=x.device)[None, :] != y[:, None]
        per = (diff * mask).sum(dim=1) / c
        return _reduce_loss(per, reduction)
    return _run(fn, input, label, weight, op_name="multi_margin_loss")


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _run(lambda lab: lab * (1 - epsilon) + epsilon / lab.shape[-1],
                label, op_name="label_smooth")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _kernel_head_dim(d: int) -> bool:
    """The reference's head-dim rule for its flash kernel (``_pallas_ok``:
    a multiple of 128, or 64); any other head dim takes its plain
    path."""
    return d % 128 == 0 or d == 64


def _sdpa_masked(q, k, v, mask, scale, dropout_p, dropout_key, causal):
    """``_sdpa_masked`` of the reference (B, S, H, D): fp32 scores, the
    causal and the given mask (boolean selects, float adds), softmax,
    then the dropout mask on P and ``P·V``."""
    hq, hk = q.shape[2], k.shape[2]
    if hk != hq:
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=s.device)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=s.device).tril(sk - sq)
        s = torch.where(cm, s, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            s = torch.where(mask, s, neg)
        else:
            s = s + mask.float()
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0:
        keep = _random.bernoulli_draw(dropout_key, 1.0 - dropout_p,
                                      tuple(p.shape), p.device)
        p = _where0(keep, p / (1.0 - dropout_p))
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *, scale=None):
    """(B, S, H, D) attention (l.1009, ``ops/flash_attention.py:739``).
    Without a mask or dropout it is the flash kernels (rows 5 and 6),
    fewer KV heads (GQA) shared by their query heads without repeating
    K/V, at the head dims the reference's kernel takes (64 or a multiple
    of 128; others take the plain path, as there). A mask or dropout is
    the reference's XLA path :func:`_sdpa_masked`, which takes a key
    from the stream whenever it runs, even at ``dropout_p`` 0."""
    d = query.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    drop = dropout_p if training else 0.0
    if attn_mask is None and drop == 0.0:
        def fn(q, k, v):
            if _kernel_head_dim(q.shape[-1]):
                return fa.sdpa_array(q, k, v, scale=sc, causal=is_causal)
            return _sdpa_masked(q, k, v, None, sc, 0.0, None, is_causal)
        return _run(fn, query, key, value, op_name="flash_attention")
    dkey = _random.next_key()
    if isinstance(attn_mask, np.ndarray):
        attn_mask = Tensor(attn_mask)
    op_name = "attention_masked" if attn_mask is not None \
        else "attention_dropout"
    return _run(lambda q, k, v, m: _sdpa_masked(q, k, v, m, sc, drop, dkey,
                                                is_causal),
                query, key, value, attn_mask, op_name=op_name)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True, name=None):
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        training=True, name=None):
    """Packed (varlen) flash attention: q/k/v (total, H, D), sequences
    contiguous, ``cu_seqlens_*`` (B+1,) cumulative lengths — the
    segment-masked flash kernels. Dropout is not supported, as in the
    reference."""
    if dropout > 0.0 and training:
        raise NotImplementedError(
            "flash_attn_unpadded: attention dropout is not supported in the "
            "varlen kernel; use dropout=0.0 or the padded flash_attention")
    out = _run(lambda q, k, v, cq, ck: fa.flash_attention_varlen(
        q, k, v, cq, ck, scale=scale, causal=causal),
        query, key, value, cu_seqlens_q, cu_seqlens_k,
        op_name="flash_attn_unpadded")
    return out, None


# the reference exposes these two through its op schema as well
from ..core import op_schema as _op_schema  # noqa: E402

pixel_unshuffle = _op_schema.make_public(_op_schema.OPS["pixel_unshuffle"])
channel_shuffle = _op_schema.make_public(_op_schema.OPS["channel_shuffle"])

# imported last: the key stream's module loads ``inference``, whose
# models import the layers, which read this module's functions
from .. import random as _random  # noqa: E402
from .decode import gather_tree  # noqa: E402,F401
