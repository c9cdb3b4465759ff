"""The case table of the ``nn.functional`` parity tests
(``CASES`` in ``test_torch_nn_functional.py``, ``LOSS_CASES`` in
``test_torch_nn_losses.py``): the
same numpy inputs for both packages, made Tensors in each, and the run
of one case (forward outputs, and the gradients of ``Σ out·c`` with
respect to the float inputs)."""

import numpy as np
import torch


def _np(t):
    if hasattr(t, "_value"):
        t = t._value
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


R = np.random.RandomState(0)


def f(*shape):
    return R.randn(*shape).astype(np.float32)


def pos(*shape):
    return R.uniform(0.1, 0.9, size=shape).astype(np.float32)


def ints(hi, *shape):
    return R.randint(0, hi, size=shape).astype(np.int32)


def softmaxed(*shape):
    a = f(*shape)
    e = np.exp(a - a.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def log_softmaxed(*shape):
    return np.log(softmaxed(*shape)).astype(np.float32)


def C(fn_name, arrays, n_grad=1, exact=False, **kw):
    """A case calling ``F.<fn_name>(*tensors, **kw)``."""
    return (fn_name, lambda F, xs, pkg: getattr(F, fn_name)(*xs, **kw),
            arrays, n_grad, exact)


def X(name, call, arrays, n_grad=1, exact=False):
    """A case with its own call ``call(F, tensors, package)``."""
    return (name, call, arrays, n_grad, exact)


ACT = ["relu", "relu6", "selu", "gelu", "silu", "swish", "mish", "hardswish",
       "hardsigmoid", "hardtanh", "softplus", "softsign", "tanhshrink",
       "hardshrink", "softshrink", "sigmoid", "tanh", "softmax",
       "log_softmax", "log_sigmoid", "thresholded_relu"]

CASES = [C(n, [f(3, 6) * 2]) for n in ACT] + [
    C("leaky_relu", [f(3, 6)], negative_slope=0.2),
    C("prelu", [f(3, 6), pos(1)], n_grad=2),
    C("elu", [f(3, 6)], alpha=0.7),
    C("celu", [f(3, 6)], alpha=1.3),
    X("gelu_tanh", lambda F, xs, p: F.gelu(xs[0], approximate=True),
      [f(3, 6)]),
    X("softmax_axis0_dtype", lambda F, xs, p: F.softmax(
        xs[0], axis=0, dtype="float32"), [f(3, 6)]),
    C("normalize", [f(3, 6)], p=1, axis=0),
    C("glu", [f(3, 6)], axis=-1),
    C("maxout", [f(2, 6, 3)], groups=3, axis=1),
    X("rrelu_eval", lambda F, xs, p: F.rrelu(xs[0], training=False),
      [f(3, 6)]),
    C("rrelu", [f(4, 6)], exact=True),
    X("gumbel_softmax", lambda F, xs, p: F.gumbel_softmax(
        xs[0], temperature=0.7), [f(3, 6)], n_grad=0),
    X("gumbel_softmax_hard", lambda F, xs, p: F.gumbel_softmax(
        xs[0], hard=True), [f(3, 6)], n_grad=0),
    # linear family
    C("linear", [f(3, 4), f(4, 5), f(5)], n_grad=3),
    C("embedding", [ints(6, 2, 5), f(6, 3)], n_grad=0, padding_idx=2),
    C("one_hot", [ints(5, 2, 3)], n_grad=0, num_classes=5),
    C("bilinear", [f(3, 4), f(3, 2), f(5, 4, 2), f(5)], n_grad=4),
    # dropout family: the same masks bit for bit
    C("dropout", [f(5, 7)], exact=True, p=0.3),
    C("dropout", [f(5, 7)], exact=True, p=0.4, axis=[0]),
    C("dropout", [f(5, 7)], exact=True, p=0.4, mode="downscale_in_infer"),
    X("dropout_infer", lambda F, xs, p: F.dropout(
        xs[0], 0.4, training=False, mode="downscale_in_infer"), [f(5, 7)]),
    C("dropout2d", [f(2, 3, 4, 4)], exact=True, p=0.5),
    C("dropout3d", [f(2, 3, 2, 2, 2)], exact=True, p=0.5),
    C("alpha_dropout", [f(5, 7)], exact=True, p=0.2),
    # convolutions
    C("conv1d", [f(2, 3, 9), f(4, 3, 3), f(4)], n_grad=3, stride=2,
      padding=[1, 2], dilation=1),
    C("conv2d", [f(2, 4, 7, 6), f(6, 2, 3, 2), f(6)], n_grad=3, stride=2,
      padding=1, dilation=(1, 2), groups=2),
    X("conv2d_same_nhwc", lambda F, xs, p: F.conv2d(
        xs[0], xs[1], stride=2, padding="SAME", data_format="NHWC"),
      [f(1, 7, 5, 3), f(4, 3, 3, 3)], n_grad=2),
    C("conv3d", [f(1, 2, 5, 5, 4), f(3, 2, 2, 3, 2), f(3)], n_grad=3,
      padding=[1, 0, 1]),
    C("conv1d_transpose", [f(1, 4, 5), f(4, 3, 3), f(3)], n_grad=3,
      stride=2, padding=1, output_padding=1),
    C("conv2d_transpose", [f(1, 4, 4, 3), f(4, 1, 3, 3), f(2)], n_grad=3,
      stride=2, padding=[1, 0], groups=2, output_size=(8, 7)),
    C("conv3d_transpose", [f(1, 2, 3, 3, 2), f(2, 2, 2, 2, 2)], n_grad=2,
      stride=2),
    # pools
    C("max_pool1d", [f(2, 3, 9)], kernel_size=3, stride=2, padding=1),
    X("max_pool2d_nhwc", lambda F, xs, p: F.max_pool2d(
        xs[0], 2, data_format="NHWC"), [f(2, 6, 4, 3)]),
    X("max_pool2d_mask", lambda F, xs, p: F.max_pool2d(
        xs[0], 2, 2, return_mask=True), [f(1, 2, 6, 4)]),
    C("max_pool3d", [f(1, 2, 4, 4, 4)], kernel_size=2),
    C("avg_pool1d", [f(2, 3, 9)], kernel_size=3, stride=2, padding=1,
      ceil_mode=True),
    C("avg_pool2d", [f(2, 3, 7, 7)], kernel_size=3, stride=2, padding=1),
    X("avg_pool2d_divisor", lambda F, xs, p: F.avg_pool2d(
        xs[0], 2, divisor_override=3), [f(1, 2, 4, 4)]),
    C("avg_pool3d", [f(1, 2, 4, 4, 4)], kernel_size=2, exclusive=False),
    C("adaptive_avg_pool1d", [f(2, 3, 8)], output_size=4),
    C("adaptive_avg_pool2d", [f(2, 3, 4, 6)], output_size=2),
    C("adaptive_avg_pool3d", [f(1, 2, 4, 4, 4)], output_size=2),
    C("adaptive_max_pool1d", [f(2, 3, 8)], output_size=2),
    C("adaptive_max_pool2d", [f(2, 3, 4, 6)], output_size=(2, 3)),
    X("max_unpool1d", lambda F, xs, p: F.max_unpool1d(
        *F.max_pool1d(xs[0], 2, return_mask=True), 2), [f(1, 2, 8)]),
    X("max_unpool2d", lambda F, xs, p: F.max_unpool2d(
        *F.max_pool2d(xs[0], 2, return_mask=True), 2), [f(1, 2, 4, 6)]),
    X("max_unpool3d", lambda F, xs, p: F.max_unpool3d(
        *F.max_pool3d(xs[0], 2, return_mask=True), 2), [f(1, 1, 4, 4, 2)]),
    # norms
    X("layer_norm", lambda F, xs, p: F.layer_norm(xs[0], (4, 6), *xs[1:]),
      [f(3, 4, 6), pos(4, 6), f(4, 6)], n_grad=3),
    C("rms_norm", [f(3, 6), pos(6)], n_grad=2),
    X("batch_norm_train", lambda F, xs, p: F.batch_norm(
        xs[0], p.zeros([3]), p.ones([3]), xs[1], xs[2], training=True,
        momentum=0.8), [f(4, 3, 2, 2), pos(3), f(3)], n_grad=3),
    X("batch_norm_eval", lambda F, xs, p: F.batch_norm(
        xs[0], xs[1], xs[2], data_format="NHWC"),
      [f(4, 2, 2, 3), f(3), pos(3)], n_grad=1),
    X("group_norm", lambda F, xs, p: F.group_norm(xs[0], 2, *xs[1:]),
      [f(2, 4, 3, 3), pos(4), f(4)], n_grad=3),
    C("instance_norm", [f(2, 3, 4, 4)]),
    C("local_response_norm", [f(2, 6, 3, 3)], size=3),
]

LOSS_CASES = [
    # padding, resizing, patches
    C("pad", [f(1, 2, 4, 5)], pad=[1, 2, 0, 1], mode="constant", value=0.5),
    C("pad", [f(1, 2, 4, 5)], pad=[2, 1, 1, 3], mode="reflect"),
    C("pad", [f(1, 2, 4, 5)], pad=[1, 1, 2, 0], mode="replicate"),
    C("pad", [f(1, 4, 5, 2)], pad=[2, 1, 1, 2], mode="circular",
      data_format="NHWC"),
    C("pad", [f(2, 3)], pad=[1, 0, 0, 2]),
    C("zeropad2d", [f(1, 2, 3, 3)], padding=[1, 0, 2, 1]),
    C("interpolate", [f(1, 2, 3, 4)], scale_factor=2),
    C("interpolate", [f(1, 2, 5, 7)], size=(3, 4), mode="nearest"),
    C("interpolate", [f(1, 2, 3, 4)], size=(5, 9), mode="bilinear"),
    C("interpolate", [f(1, 2, 7, 6)], size=(3, 4), mode="bilinear"),
    C("interpolate", [f(1, 2, 4, 4)], size=(7, 3), mode="bicubic"),
    C("upsample", [f(1, 2, 3, 3)], scale_factor=(2, 1), mode="area"),
    C("unfold", [f(2, 3, 5, 6)], kernel_sizes=[2, 3], strides=1,
      paddings=1, dilations=[1, 2]),
    C("fold", [f(2, 12, 12)], output_sizes=(4, 5), kernel_sizes=2,
      strides=1),
    X("affine_grid", lambda F, xs, p: F.affine_grid(
        xs[0], [2, 1, 3, 4], align_corners=False), [f(2, 2, 3)]),
    X("grid_sample", lambda F, xs, p: F.grid_sample(xs[0], xs[1]),
      [f(2, 3, 4, 5), f(2, 3, 2, 2)], n_grad=1),
    X("grid_sample_nearest_border", lambda F, xs, p: F.grid_sample(
        xs[0], xs[1], mode="nearest", padding_mode="border",
        align_corners=False), [f(1, 2, 4, 4), f(1, 3, 3, 2)], n_grad=1),
    C("pixel_shuffle", [f(1, 8, 2, 3)], upscale_factor=2),
    C("pixel_unshuffle", [f(1, 2, 4, 6)], downscale_factor=2),
    C("channel_shuffle", [f(1, 6, 2, 2)], groups=3),
    C("temporal_shift", [f(4, 8, 2, 2)], seg_num=2),
    X("sequence_mask", lambda F, xs, p: F.sequence_mask(
        xs[0], maxlen=6, dtype="int32"), [ints(6, 2, 3)], n_grad=0),
    # losses
    C("cross_entropy", [f(4, 5), ints(5, 4)]),
    C("cross_entropy", [f(4, 5), np.array([1, -100, 3, 0], np.int32)],
      weight=pos(5)),
    C("cross_entropy", [f(4, 5), ints(5, 4, 1)], reduction="none",
      label_smoothing=0.2, ignore_index=2),
    C("cross_entropy", [f(3, 4, 2), softmaxed(3, 2, 4).transpose(0, 2, 1)
                        .copy()], n_grad=2, soft_label=True, axis=1,
      reduction="sum"),
    C("cross_entropy", [softmaxed(4, 5), ints(5, 4)], use_softmax=False),
    X("softmax_with_cross_entropy", lambda F, xs, p:
      F.softmax_with_cross_entropy(xs[0], xs[1], return_softmax=True),
      [f(4, 5), ints(5, 4)]),
    C("nll_loss", [log_softmaxed(4, 5), ints(5, 4)], weight=pos(5),
      ignore_index=1),
    C("mse_loss", [f(3, 4), f(3, 4)], n_grad=2),
    C("l1_loss", [f(3, 4), f(3, 4)], n_grad=2, reduction="none"),
    C("smooth_l1_loss", [f(3, 4), f(3, 4)], n_grad=2, delta=0.6),
    C("binary_cross_entropy", [pos(3, 4), pos(3, 4).round()],
      weight=pos(3, 4), reduction="sum"),
    C("binary_cross_entropy_with_logits", [f(3, 4), pos(3, 4).round()],
      pos_weight=pos(4), weight=pos(3, 4)),
    C("kl_div", [log_softmaxed(3, 4), softmaxed(3, 4)], reduction="batchmean"),
    C("square_error_cost", [f(3, 4), f(3, 4)], n_grad=2),
    C("margin_ranking_loss", [f(5), f(5), np.sign(f(5))], n_grad=2,
      margin=0.3),
    C("cosine_similarity", [f(3, 5), f(3, 5)], n_grad=2, axis=1),
    C("pairwise_distance", [f(3, 5), f(3, 5)], n_grad=2, p=3.0, keepdim=True),
    C("log_loss", [pos(4, 1), pos(4, 1).round()]),
    C("dice_loss", [softmaxed(2, 3, 4), ints(4, 2, 3, 1)]),
    C("soft_margin_loss", [f(3, 4), np.sign(f(3, 4))]),
    C("hinge_embedding_loss", [f(3, 4), np.sign(f(3, 4))], margin=0.5),
    C("poisson_nll_loss", [f(3, 4), pos(3, 4) * 4], full=True),
    C("poisson_nll_loss", [pos(3, 4), pos(3, 4)], log_input=False),
    C("gaussian_nll_loss", [f(3, 4), f(3, 4), pos(3, 4)], n_grad=3,
      full=True),
    C("sigmoid_focal_loss", [f(3, 4), pos(3, 4).round(), pos(1)],
      alpha=0.3),
    C("multi_label_soft_margin_loss", [f(3, 4), pos(3, 4).round()],
      weight=pos(4)),
    C("cosine_embedding_loss", [f(3, 5), f(3, 5), np.sign(f(3))],
      n_grad=2, margin=0.1),
    C("triplet_margin_loss", [f(3, 5), f(3, 5), f(3, 5)], n_grad=3,
      swap=True),
    X("triplet_margin_with_distance_loss", lambda F, xs, p:
      F.triplet_margin_with_distance_loss(
          xs[0], xs[1], xs[2], swap=True,
          distance_function=lambda a, b: F.pairwise_distance(a, b, p=1.0)),
      [f(3, 5), f(3, 5), f(3, 5)], n_grad=3),
    C("npair_loss", [f(4, 5), f(4, 5), ints(2, 4)], n_grad=2),
    X("margin_cross_entropy", lambda F, xs, p: F.margin_cross_entropy(
        xs[0], xs[1], return_softmax=True),
      [np.tanh(f(4, 6)), ints(6, 4)]),
    C("ctc_loss", [log_softmaxed(6, 2, 4), 1 + ints(3, 2, 3),
                   np.array([6, 5], np.int32), np.array([3, 2], np.int32)]),
    C("multi_margin_loss", [f(4, 5), ints(5, 4)], p=2, weight=pos(5)),
    C("label_smooth", [pos(3, 5).round()], epsilon=0.2),
    # attention
    X("sdpa_causal", lambda F, xs, p: F.scaled_dot_product_attention(
        *xs, is_causal=True), [f(2, 5, 2, 8), f(2, 5, 2, 8), f(2, 5, 2, 8)],
      n_grad=3),
    X("sdpa_bool_mask", lambda F, xs, p: F.scaled_dot_product_attention(
        *xs[:3], attn_mask=xs[3]),
      [f(2, 4, 2, 8), f(2, 5, 2, 8), f(2, 5, 2, 8),
       ints(2, 2, 1, 4, 5).astype(bool) | np.eye(4, 5, dtype=bool)],
      n_grad=3),
    X("sdpa_float_mask_dropout", lambda F, xs, p:
      F.scaled_dot_product_attention(*xs, dropout_p=0.3),
      [f(2, 3, 2, 8), f(2, 4, 2, 8), f(2, 4, 2, 8), f(3, 4) * 2], n_grad=3),
    X("sdpa_dropout_eval_keeps_the_key", lambda F, xs, p: (
        F.scaled_dot_product_attention(*xs, training=False),
        p.get_rng_state()[0] * p.ones([1])),
      [f(1, 3, 2, 8), f(1, 3, 2, 8), f(1, 3, 2, 8), f(3, 3)], n_grad=3),
    X("flash_attention", lambda F, xs, p: F.flash_attention(
        *xs, causal=True)[0], [f(1, 6, 2, 8)] * 3, n_grad=3),
    X("flash_attn_unpadded", lambda F, xs, p: F.flash_attn_unpadded(
        *xs, p.to_tensor(np.array([0, 2, 5], np.int32)),
        p.to_tensor(np.array([0, 2, 5], np.int32)), scale=0.3,
        causal=True)[0], [f(5, 2, 8), f(5, 2, 8), f(5, 2, 8)], n_grad=3),
    X("gather_tree", lambda F, xs, p: F.gather_tree(xs[0], xs[1]),
      [ints(7, 4, 2, 3), ints(3, 4, 2, 3)], n_grad=0),
]




def run_case(pkg, F, call, arrays, n_grad):
    xs = [pkg.to_tensor(a, stop_gradient=not (i < n_grad))
          for i, a in enumerate(arrays)]
    pkg.seed(17)
    out = call(F, xs, pkg)
    outs = list(out) if isinstance(out, tuple) else [out]
    grads = []
    first = outs[0]
    if n_grad and str(first.dtype).endswith("float32"):
        cot = np.asarray(np.random.RandomState(3).randn(*first.shape),
                         np.float32)
        (first * pkg.to_tensor(cot)).sum().backward()
        grads = [_np(x.grad) if x.grad is not None else None
                 for x in xs[:n_grad]]
    return [_np(o) for o in outs], grads




def check_case(J, JF, TP, TF, name, call, arrays, n_grad, exact, tol):
    """One case through both packages: outputs (bitwise where ``exact``
    or integral) and gradients within ``tol``."""
    r_out, r_grad = run_case(J, JF, call, arrays, n_grad)
    p_out, p_grad = run_case(TP, TF, call, arrays, n_grad)
    assert len(p_out) == len(r_out)
    for r, p in zip(r_out, p_out):
        assert p.shape == r.shape, name
        if exact or not np.issubdtype(r.dtype, np.floating):
            np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=name)
        else:
            np.testing.assert_allclose(p, r, err_msg=name, **tol)
    assert len(p_grad) == len(r_grad)
    for r, p in zip(r_grad, p_grad):
        assert (p is None) == (r is None)
        if r is not None:
            np.testing.assert_allclose(p, r, err_msg=name, **tol)
