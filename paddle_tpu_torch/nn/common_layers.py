"""The standard ``nn.*`` layers of ``paddle_tpu/nn/common_layers.py``
(linear and embedding, dropouts, convolutions, norms, pools,
activations, losses, padding) on the :class:`~.layer.Layer` base, with
the reference's parameter names, its ``(in, out)`` weight layout
(``y = x @ W + b``) and its initializers.

As in the reference, a layer's weights are drawn when it is built, from
the framework key stream in construction order (``create_parameter``
with the reference's default initializers), so ``seed(s)`` gives the
reference's weights. ``Linear``, ``LayerNorm`` and ``RMSNorm`` take a
keyword-only ``dtype`` and ``device`` (the ported models build with
them); every layer builds on the current place otherwise, the card
unless ``set_device`` says otherwise (:func:`.layer.layer_device`).
``reset_parameters(gen)`` redraws a layer from a ``torch.Generator``:
the port's own ``init_layers(model, seed)`` helper."""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer import Layer, layer_device, to_tensor  # noqa: F401


class _Placed(Layer):
    """A layer built on an explicit ``dtype`` / ``device``."""

    def __init__(self, dtype=None, device=None):
        super().__init__(dtype=dtype)
        self._build_device = layer_device(device)


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------
class Linear(_Placed):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=None, device=None):
        super().__init__(dtype, device)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierUniform())
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.xavier_uniform_(self.weight, gen)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, out_features={self._out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))

    def reset_parameters(self, gen=None):
        I.normal_(self.weight, gen)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Identity(Layer):
    def forward(self, x):
        return x


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             data_format=self.data_format)


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
class _ConvNd(Layer):
    def __init__(self, nd, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        k = (kernel_size,) * nd if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = k
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * int(np.prod(k))
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + k, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        if bias_attr is not False:
            bound = 1 / math.sqrt(fan_in)
            self.bias = self.create_parameter(
                (out_channels,), attr=bias_attr, is_bias=True,
                default_initializer=I.Uniform(-bound, bound))
        else:
            self.bias = None

    def _conv(self, fn, x):
        return fn(x, self.weight, self.bias, stride=self._stride,
                  padding=self._padding, dilation=self._dilation,
                  groups=self._groups, data_format=self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv2d, x)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv1d, x)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv3d, x)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups, self._data_format = groups, data_format
        self._output_padding = output_padding
        self.weight = self.create_parameter(
            (in_channels, out_channels // groups) + k, attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, dilation=self._dilation,
            groups=self._groups, data_format=self._data_format,
            output_padding=self._output_padding)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
class LayerNorm(_Placed):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=None, device=None):
        super().__init__(dtype, device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.constant_(self.weight, 1.0)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)


class RMSNorm(_Placed):
    """Llama's RMSNorm (l.236): a scale initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, dtype=None, device=None):
        super().__init__(dtype, device)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def reset_parameters(self, gen=None):
        if self.weight is not None:
            I.constant_(self.weight, 1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), attr=bias_attr, is_bias=True)
        dev = layer_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


BatchNorm = BatchNorm2D


class SyncBatchNorm(_BatchNormBase):
    """One card's batch statistics (one process holds the whole batch
    here, as the reference's one program does)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            (num_channels,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = None if weight_attr is False else self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.data_format = ceil_mode, data_format
        self.return_mask = return_mask

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            return_mask=self.return_mask,
                            data_format=self.data_format)


class MaxUnPool2D(Layer):
    """Scatter pooled values back through the argmax mask of
    ``MaxPool2D(return_mask=True)``."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.data_format, self.output_size = data_format, output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.k, self.s, self.p,
                              data_format=self.data_format,
                              output_size=self.output_size)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.data_format = exclusive, data_format
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p,
                            exclusive=self.exclusive,
                            divisor_override=self.divisor_override,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def _act_layer(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = {**defaults, **{k: v for k, v in kwargs.items()
                                           if k != "name"}}

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu)
SiLU = _act_layer("SiLU", F.silu)
Swish = _act_layer("Swish", F.silu)
Mish = _act_layer("Mish", F.mish)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardtanh = _act_layer("Hardtanh", F.hardtanh)
ELU = _act_layer("ELU", F.elu)
SELU = _act_layer("SELU", F.selu)
CELU = _act_layer("CELU", F.celu)
Softplus = _act_layer("Softplus", F.softplus)
Softsign = _act_layer("Softsign", F.softsign)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
Hardshrink = _act_layer("Hardshrink", F.hardshrink)
Softshrink = _act_layer("Softshrink", F.softshrink)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, label_smoothing=0.0, name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction
        self._soft_label = soft_label
        self._axis = axis
        self._label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self._weight,
                               ignore_index=self._ignore_index,
                               reduction=self._reduction,
                               soft_label=self._soft_label, axis=self._axis,
                               label_smoothing=self._label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, reduction=self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, reduction=self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self._weight,
                          ignore_index=self._ignore_index,
                          reduction=self._reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, weight=self._weight,
                                      reduction=self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction
        self._pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, weight=self._weight, reduction=self._reduction,
            pos_weight=self._pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, reduction=self._reduction,
                                delta=self._delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, reduction=self._reduction)


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------
class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._padding = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        self._mode = mode
        self._value = value
        self._data_format = data_format

    def forward(self, x):
        return F.pad(x, self._padding, mode=self._mode, value=self._value,
                     data_format=self._data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._r = upscale_factor
        self._data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._r, data_format=self._data_format)


# ---------------------------------------------------------------------------
# the port's own helpers
# ---------------------------------------------------------------------------
def init_layers(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of ``model`` in place, seeded: each layer's
    ``reset_parameters`` draws from the reference initialisers'
    distributions with one ``torch.Generator`` on the parameters'
    device. Returns ``model``."""
    dev = next(iter(model.parameters())).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def load_layer_state(model: nn.Module, np_state: Dict[str, Any]) -> None:
    """Copy weights into ``model`` by name: ``np_state`` maps the JAX
    model's ``named_parameters()`` names to arrays (e.g. ``np.asarray``
    of each ``p._value``). Every parameter must be given, with its
    shape, and no other name; values are cast to the parameter's
    dtype."""
    own = dict(model.named_parameters())
    if set(own) != set(np_state):
        raise ValueError(
            f"names differ: missing {sorted(set(own) - set(np_state))}, "
            f"unknown {sorted(set(np_state) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            t = to_tensor(np.asarray(np_state[name]))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
