"""The layer batch of ``paddle_tpu/nn/layers_extra.py``: thin wrappers
over ``functional`` (1-D/3-D pools and pads, upsampling, activations,
distances, patches, the loss zoo) and the layers with math of their own
(``AlphaDropout``, ``InstanceNorm1D``, ``Bilinear``, ``HuberLoss``,
``SpectralNorm``, ``AdaptiveLogSoftmaxWithLoss``), with the reference's
parameters drawn from the key stream in its order."""

from __future__ import annotations

import numpy as np
import torch

from . import functional as F
from . import initializer as I
from .. import random as _random
from .layer import Layer, layer_device


# -- pooling / padding / upsampling ------------------------------------------
class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p,
                            return_mask=self.return_mask,
                            ceil_mode=self.ceil_mode)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.ceil_mode = exclusive, ceil_mode

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.exclusive,
                            ceil_mode=self.ceil_mode)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self._padding = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 2
        self._mode, self._value = mode, value
        self._data_format = data_format

    def forward(self, x):
        return F.pad(x, self._padding, mode=self._mode, value=self._value,
                     data_format=self._data_format)


class Pad3D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__()
        self._padding = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 6
        self._mode, self._value = mode, value
        self._data_format = data_format

    def forward(self, x):
        return F.pad(x, self._padding, mode=self._mode, value=self._value,
                     data_format=self._data_format)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._padding = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        self._data_format = data_format

    def forward(self, x):
        return F.pad(x, self._padding, mode="constant", value=0.0,
                     data_format=self._data_format)


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale = size, scale_factor

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale,
                             mode="bilinear", align_corners=True)


# -- activations / misc -------------------------------------------------------
class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, axis=self.axis)


class AlphaDropout(Layer):
    """SELU-preserving dropout (paddle.nn.AlphaDropout): its key is drawn
    only when training with ``p > 0``."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        key = _random.next_key()
        p = self.p
        neg_sat = -1.6732632423543772 * 1.0507009873554805

        def fn(v):
            keep = _random.bernoulli_draw(key, 1.0 - p, tuple(v.shape),
                                          v.device)
            a = 1.0 / np.sqrt((1 - p) * (1 + p * neg_sat ** 2))
            b = -a * p * neg_sat
            return a * torch.where(keep, v, neg_sat) + b

        return F._run(fn, x, op_name="alpha_dropout")


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self.eps = epsilon
        self.weight = self.create_parameter(
            (num_features,), default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            (num_features,), default_initializer=I.Constant(0.0),
            is_bias=True)

    def forward(self, x):
        def fn(v, w, b):
            vf = v.float()
            mu = vf.mean(dim=-1, keepdim=True)
            var = vf.var(dim=-1, unbiased=False, keepdim=True)
            out = (vf - mu) * torch.rsqrt(var + self.eps)
            return (out * w[None, :, None] + b[None, :, None]).to(v.dtype)
        return F._run(fn, x, self.weight, self.bias,
                      op_name="instance_norm1d")


class Bilinear(Layer):
    """out[b, o] = x1[b] @ W[o] @ x2[b] + bias (paddle.nn.Bilinear)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features),
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter(
            (out_features,), default_initializer=I.Constant(0.0),
            is_bias=True)

    def forward(self, x1, x2):
        return F._run(lambda a, b, w, bias: torch.einsum(
            "bi,oij,bj->bo", a, w, b) + bias, x1, x2, self.weight,
            self.bias, op_name="bilinear")


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.eps, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.eps, self.keepdim)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.k, self.s, self.p, self.d = kernel_sizes, strides, paddings, \
            dilations

    def forward(self, x):
        return F.unfold(x, self.k, self.s, self.p, self.d)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.o, self.k, self.s, self.p, self.d = output_sizes, \
            kernel_sizes, strides, paddings, dilations

    def forward(self, x):
        return F.fold(x, self.o, self.k, self.s, self.p, self.d)


# -- losses -------------------------------------------------------------------
class HuberLoss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        def fn(x, y):
            d = (x - y).float()
            ad = torch.abs(d)
            out = torch.where(ad <= self.delta, 0.5 * d * d,
                              self.delta * (ad - 0.5 * self.delta))
            return F._reduce_loss(out, self.reduction)
        return F._run(fn, input, label, op_name="huber_loss")


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label,
                                     margin=self.margin,
                                     reduction=self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p, self.eps = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative,
                                     margin=self.margin, p=self.p,
                                     epsilon=self.eps, swap=self.swap,
                                     reduction=self.reduction)


# -- reparameterizations ------------------------------------------------------
class SpectralNorm(Layer):
    """paddle.nn.SpectralNorm: an input weight tensor divided by its
    largest singular value, estimated by power iteration (differentiable
    through the iteration, as the reference's); the buffers ``weight_u``
    and ``weight_v`` keep the iterates across calls."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = epsilon
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        rng = np.random.RandomState(0)
        dev = layer_device()
        self.register_buffer("weight_u", torch.as_tensor(
            rng.randn(h).astype(np.float32), device=dev))
        self.register_buffer("weight_v", torch.as_tensor(
            rng.randn(w).astype(np.float32), device=dev))

    def forward(self, weight):
        dim, iters, eps = self.dim, self.power_iters, self.eps

        def fn(wt, u, v):
            wmat = torch.movedim(wt, dim, 0)
            shape = wmat.shape
            wmat = wmat.reshape(shape[0], -1)

            def norm(x):
                return x / (torch.linalg.vector_norm(x) + eps)

            for _ in range(iters):
                v = norm(wmat.T @ u)
                u = norm(wmat @ v)
            sigma = u @ wmat @ v
            out = wmat / sigma
            return torch.movedim(out.reshape(shape), 0, dim), u, v

        out, u, v = F._run(fn, weight, self.weight_u, self.weight_v,
                           op_name="spectral_norm", n_outputs=3)
        # rebound, not written in place: the backward reads the old iterates
        self.weight_u = (u._value if hasattr(u, "_value") else u).detach()
        self.weight_v = (v._value if hasattr(v, "_value") else v).detach()
        return out





# -- round-5 API-audit layer batch (sweep 4): thin wrappers + the adaptive
# softmax (reference: python/paddle/nn/layer/loss.py, activation.py,
# vision.py:§0) ---------------------------------------------------------------
class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Softmax2D(Layer):
    """Softmax over the channel dim of (N, C, H, W)."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label,
                                       margin=self.margin,
                                       reduction=self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, full=self.full,
                                   epsilon=self.epsilon,
                                   reduction=self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, margin=self.margin,
                                      reduction=self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label,
                                              weight=self.weight,
                                              reduction=self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, p=self.p,
                                   margin=self.margin, weight=self.weight,
                                   reduction=self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.log_input, self.full = log_input, full
        self.epsilon, self.reduction = epsilon, reduction

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, log_input=self.log_input,
                                  full=self.full, epsilon=self.epsilon,
                                  reduction=self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, reduction=self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax (Grave et al.): frequent "head" classes score
    directly; rare classes live in tail clusters entered through a
    cluster logit, each tail projected to in_features/div_value^i dims.
    Every (sample, cluster) pair is computed densely, as the reference
    does."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (not cutoffs or sorted(set(cutoffs)) != cutoffs
                or cutoffs[-1] > n_classes - 1):
            raise ValueError("cutoffs must be unique, increasing, and "
                             "< n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.shortlist_size = cutoffs[0]
        self.n_clusters = len(self.cutoffs) - 1
        head_out = self.shortlist_size + self.n_clusters
        self.head_weight = self.create_parameter(
            (in_features, head_out), default_initializer=I.XavierNormal())
        self.head_bias = self.create_parameter(
            (head_out,), is_bias=True,
            default_initializer=I.Constant(0.0)) if head_bias else None
        self._tails = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter((in_features, hsz),
                                       default_initializer=I.XavierNormal())
            w2 = self.create_parameter((hsz, osz),
                                       default_initializer=I.XavierNormal())
            self.add_parameter(f"tail_{i}_proj", w1)
            self.add_parameter(f"tail_{i}_out", w2)
            self._tails.append((f"tail_{i}_proj", f"tail_{i}_out"))

    @property
    def tail_weights(self):
        return [(getattr(self, a), getattr(self, b)) for a, b in self._tails]

    def log_prob(self, input):
        """Full (N, n_classes) log probabilities."""
        def fn(x, hw, hb, *ws):
            h = x @ hw
            if hb is not None:
                h = h + hb
            head_lp = torch.log_softmax(h, dim=-1)
            outs = [head_lp[:, :self.shortlist_size]]
            for i in range(self.n_clusters):
                tail_lp = torch.log_softmax((x @ ws[2 * i]) @ ws[2 * i + 1],
                                            dim=-1)
                outs.append(tail_lp
                            + head_lp[:, self.shortlist_size + i][:, None])
            return torch.cat(outs, dim=-1)

        flat = [w for pair in self.tail_weights for w in pair]
        return F._run(fn, input, self.head_weight, self.head_bias, *flat,
                      op_name="adaptive_log_softmax")

    def predict(self, input):
        return F._run(lambda v: torch.argmax(v, dim=-1).to(torch.int32),
                      self.log_prob(input), op_name="adaptive_predict")

    def forward(self, input, label):
        """Returns (output, loss): output is each sample's target
        log-probability, loss = -mean(output)."""
        def fn(v, y):
            out = torch.gather(v, 1, y.long()[:, None])[:, 0]
            return out, -out.mean()
        return F._run(fn, self.log_prob(input), label,
                      op_name="adaptive_softmax_loss", n_outputs=2)

