"""The Vision Transformer — counterpart of
``paddle_tpu/vision/models/vit.py``: the pre-LN encoder over the fused
attention and FFN blocks (``incubate.nn``), a strided ``Conv2D`` patch
embedding, the class token and learned positions, and the functional
stacked path (:func:`stacked_params_from_module`,
:func:`vit_forward_stacked`, :func:`build_vit_train_step`).

Attention goes through ``ops.fused_transformer_block._prefill_attention``
with ``causal=False``: the flash kernels (Queue B rows 5 and 6) on the
card. A sequence of 197 tokens is not a multiple of their tiles; the
kernels bound-check the sequence, so nothing is padded. Every LayerNorm
is ``ftb.layer_norm_array``, the fused LayerNorm (row 8). The patch
embedding is ``F.conv2d`` (XLA's convolution in the reference, cuDNN's
here).

The module takes ``Tensor``s (run as one op through the dispatcher) or
torch tensors. The stacked path's train step updates the params and the
AdamW state IN PLACE and returns them (the reference donates them to its
jitted step); on the card it is one CUDA graph per input signature
(``jit.ProgramCache``), forward, backward and update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from ...core.dispatch import apply
from ...core.tensor import Tensor
from ...incubate.nn.layer.fused_transformer import (
    FusedFeedForward, FusedMultiHeadAttention)
from ...nn import initializer as I
from ...nn.common_layers import Conv2D, LayerNorm, Linear
from ...nn.layer import Layer, LayerList, layer_device
from ...ops import fused_transformer_block as ftb


class PatchEmbed(Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3, embed_dim=768):
        super().__init__()
        if img_size % patch_size:
            raise ValueError("img_size must divide by patch_size")
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                           stride=patch_size)

    def forward(self, x):
        x = self.proj(x)                       # (B, E, H/p, W/p)
        b, e = x.shape[0], x.shape[1]
        return x.reshape(b, e, -1).transpose(1, 2)        # (B, N, E)


class ViTEncoderLayer(Layer):
    def __init__(self, embed_dim, num_heads, mlp_ratio=4.0, epsilon=1e-6):
        super().__init__()
        dev = layer_device()
        self.attn = FusedMultiHeadAttention(
            embed_dim, num_heads, normalize_before=True, epsilon=epsilon,
            device=dev)
        self.ffn = FusedFeedForward(
            embed_dim, int(embed_dim * mlp_ratio), activation="gelu",
            normalize_before=True, epsilon=epsilon, device=dev)

    def forward(self, x):
        return self.ffn(self.attn(x, causal=False))


class VisionTransformer(Layer):
    """ViT backbone and classification head (``class_num=0``: the
    features only)."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 class_num=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, epsilon=1e-6, representation_size=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim)
        n = self.patch_embed.num_patches
        self.cls_token = self.create_parameter(
            (1, 1, embed_dim), default_initializer=I.Normal(0.0, 0.02))
        self.pos_embed = self.create_parameter(
            (1, n + 1, embed_dim), default_initializer=I.Normal(0.0, 0.02))
        self.blocks = LayerList([
            ViTEncoderLayer(embed_dim, num_heads, mlp_ratio, epsilon)
            for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, epsilon=epsilon)
        self.head = (Linear(embed_dim, class_num) if class_num > 0 else None)

    def _features(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def _forward(self, x):
        cls = self._features(x)[:, 0]
        return self.head(cls) if self.head is not None else cls

    def _op(self, fn, x, op_name):
        """``fn`` over a Tensor as one op; the parameters are its inputs
        too, so the output carries their gradients."""
        return apply(lambda v, *params: fn(v), x, *self.parameters(),
                     op_name=op_name)

    def forward_features(self, x):
        if isinstance(x, Tensor):
            return self._op(self._features, x, "vit_features")
        return self._features(x)

    def forward(self, x):
        if isinstance(x, Tensor):
            return self._op(self._forward, x, "vit")
        return self._forward(x)


def vit_base_patch16_224(**kwargs):
    return VisionTransformer(img_size=224, patch_size=16, embed_dim=768,
                             depth=12, num_heads=12, **kwargs)


def vit_large_patch16_224(**kwargs):
    return VisionTransformer(img_size=224, patch_size=16, embed_dim=1024,
                             depth=24, num_heads=16, **kwargs)


def vit_tiny_test(**kwargs):
    """The small configuration of the tests."""
    base = dict(img_size=16, patch_size=4, in_chans=3, class_num=10,
                embed_dim=32, depth=2, num_heads=4)
    base.update(kwargs)
    return VisionTransformer(**base)


# ---------------------------------------------------------------------------
# The functional stacked path (l.142-266): per-layer weights stacked on a
# leading L axis, one AdamW over a few stacked arrays
# ---------------------------------------------------------------------------

VIT_LAYER_KEYS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
                  "ln2_s", "ln2_b", "f1_w", "f1_b", "f2_w", "f2_b")


def stacked_params_from_module(net: "VisionTransformer") -> dict:
    """A ``VisionTransformer``'s weights in the stacked layout (copies:
    the train step updates them in place)."""
    def g(p):
        return p.detach().clone()

    out = {
        "patch_w": g(net.patch_embed.proj.weight),
        "patch_b": g(net.patch_embed.proj.bias),
        "cls": g(net.cls_token),
        "pos": g(net.pos_embed),
        "ln_f_s": g(net.norm.weight),
        "ln_f_b": g(net.norm.bias),
    }
    if net.head is not None:
        out["head_w"] = g(net.head.weight)
        out["head_b"] = g(net.head.bias)
    per = {k: [] for k in VIT_LAYER_KEYS}
    for blk in net.blocks:
        a, f = blk.attn, blk.ffn
        for key, p in (("ln1_s", a.pre_ln_scale), ("ln1_b", a.pre_ln_bias),
                       ("qkv_w", a.qkv_weight), ("qkv_b", a.qkv_bias),
                       ("out_w", a.linear_weight), ("out_b", a.linear_bias),
                       ("ln2_s", f.ln_scale), ("ln2_b", f.ln_bias),
                       ("f1_w", f.w1), ("f1_b", f.b1), ("f2_w", f.w2),
                       ("f2_b", f.b2)):
            per[key].append(p.detach())
    for k, vs in per.items():
        out[k] = torch.stack(vs)
    return out


def _gelu(x):
    return TF.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def _encoder_layer(xc, lp, num_heads: int, eps: float):
    """One pre-LN encoder layer over the stacked layout (the reference's
    scan body): LayerNorm, QKV, non-causal flash attention, the out
    projection and residual, LayerNorm, the GELU FFN and residual; the
    weights cast to the activations' dtype."""
    def w(k, t):
        return lp[k].to(t.dtype)

    xn = ftb.layer_norm_array(xc, lp["ln1_s"], lp["ln1_b"], eps)
    qkv = xn @ w("qkv_w", xn) + w("qkv_b", xn)
    q, k, v = ftb._split_heads(qkv, num_heads)
    attn = ftb._prefill_attention(q, k, v, None, causal=False)
    bb, s, _ = xc.shape
    attn = attn.transpose(1, 2).reshape(bb, s, -1)
    xc = xc + (attn @ w("out_w", attn) + w("out_b", attn)).to(xc.dtype)
    xn = ftb.layer_norm_array(xc, lp["ln2_s"], lp["ln2_b"], eps)
    f = _gelu(xn @ w("f1_w", xn) + w("f1_b", xn))
    return xc + (f @ w("f2_w", f) + w("f2_b", f)).to(xc.dtype)


def vit_forward_stacked(params, x, num_heads: int, patch: int = 16,
                        eps: float = 1e-6, remat: str = "dots"):
    """(B, C, H, W) -> logits (or the class features without a head),
    :class:`VisionTransformer`'s math over the stacked layout.
    ``remat="dots"`` recomputes each layer in the backward keeping the
    matmuls' outputs (``models.llama``'s ``dots`` policy, the
    reference's ``dots_saveable``); ``"off"`` keeps everything."""
    from ...models.llama import _policy_contexts

    b = x.shape[0]
    p = TF.conv2d(x, params["patch_w"].to(x.dtype), stride=patch)
    p = p + params["patch_b"].to(x.dtype)[None, :, None, None]
    e = p.shape[1]
    tok = p.reshape(b, e, -1).transpose(1, 2)              # (B, N, E)
    cls = params["cls"].to(x.dtype).expand(b, 1, e)
    h = torch.cat([cls, tok], dim=1) + params["pos"].to(x.dtype)
    n_layers = params["qkv_w"].shape[0]
    for l in range(n_layers):
        lp = {k: params[k][l] for k in VIT_LAYER_KEYS}
        if remat == "dots" and torch.is_grad_enabled():
            h = checkpoint(_encoder_layer, h, lp, num_heads, eps,
                           use_reentrant=False,
                           context_fn=_policy_contexts("dots"))
        else:
            h = _encoder_layer(h, lp, num_heads, eps)
    h = ftb.layer_norm_array(h, params["ln_f_s"], params["ln_f_b"], eps)
    cls_feat = h[:, 0]
    if "head_w" in params:
        return (cls_feat @ params["head_w"].to(cls_feat.dtype)
                + params["head_b"].to(cls_feat.dtype))
    return cls_feat


def build_vit_train_step(num_heads: int, patch: int = 16, eps: float = 1e-6,
                         learning_rate: float = 1e-4, dtype=torch.bfloat16,
                         remat: str = "dots"):
    """The single-device ViT train step over stacked params (l.228-266).
    Returns ``(step, init_opt)``.

    ``step(params, opt_state, x, y) -> (loss, params, opt_state)``: the
    mean cross-entropy of :func:`vit_forward_stacked` on ``x`` cast to
    ``dtype`` (fp32 logits), its gradients, and one AdamW step (b1 0.9,
    b2 0.999, eps 1e-8, decay 0.01, fp32 moments, the reference's
    arithmetic: ``optimizer.adamw.adamw_update_``), written into
    ``params`` and ``opt_state`` in place. ``init_opt(params)`` gives
    step 0 and zero fp32 moments. On the card each ``(x, y)`` signature
    is captured once as a CUDA graph; the params and state it captured
    are the ones it updates, so a step takes the same dicts each call."""
    from ...jit import ProgramCache
    from ...optimizer.adamw import adamw_update_

    b1, b2, adam_eps, wd = 0.9, 0.999, 1e-8, 0.01
    lr = float(learning_rate)
    programs = ProgramCache("vit_train_step")

    def init_opt(params):
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": {k: torch.zeros_like(v, dtype=torch.float32)
                      for k, v in params.items()},
                "v": {k: torch.zeros_like(v, dtype=torch.float32)
                      for k, v in params.items()}}

    def body(params, opt_state, x, y):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            logits = vit_forward_stacked(leaves, x.to(dtype), num_heads,
                                         patch, eps, remat=remat).float()
            lse = torch.log_softmax(logits, dim=-1)
            loss = -lse.gather(1, y.long()[:, None])[:, 0].mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            t = opt_state["step"] + 1
            tf = t.float()
            one = torch.ones((), dtype=torch.float32, device=tf.device)
            bc1 = 1 - torch.pow(one * b1, tf)
            bc2 = 1 - torch.pow(one * b2, tf)
            keys = list(params)
            adamw_update_([params[k] for k in keys], list(grads),
                          [opt_state["m"][k] for k in keys],
                          [opt_state["v"][k] for k in keys], lr=lr,
                          beta1=b1, beta2=b2, eps=adam_eps,
                          weight_decay=wd, bc1=bc1, bc2=bc2)
            opt_state["step"].copy_(t)
        return loss.detach()

    def step(params, opt_state, x, y):
        key = (tuple(x.shape), x.dtype, tuple(y.shape),
               tuple(params), id(params))
        loss = programs.run(key, lambda xv, yv: body(params, opt_state, xv,
                                                     yv), [x, y], x.device)
        return loss, params, opt_state

    step.programs = programs
    return step, init_opt
