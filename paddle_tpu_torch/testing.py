"""The bounds the card's checks hold the port to, in one place so that
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` apply the same ones:
each kernel against its plain version, per tensor and scaled by the
tensor's own rms, and weights trained on the card against the same
training on the CPU. The functions raise ``AssertionError`` on a
miss. The port's CPU tests also set their thread count here
(``one_cpu_thread``)."""

from __future__ import annotations

import re
from typing import Dict

import torch

# Flash attention, per tensor (out, dq, dk, dv), as (rtol, atol as a share
# of the plain tensor's rms, most ||kernel - plain|| / ||plain||): each
# follows the tensor's own scale, so a typical |out| of 0.02 on a long
# causal row is held as tightly as a |dv| of 5. fp32 differs in summation
# order and the online (kernel) vs one-pass (plain) softmax. In bf16 each
# output is one rounding of an fp32 value (rtol: two bf16 steps); P
# (forward) and dS (backward) are rounded to bf16 on both sides from fp32
# values that differ in their last bits, so now and then one of them
# rounds the other way and moves its outputs by one bf16 step of that P·V
# or dS·K term, which on a small output can be several of its own steps
# (atol: 2^-4 of the rms). Those flips and the output rounding leave a
# relative L2 error of a few 1e-3; a dropped or doubled key tile moves the
# long rows by ~10 % (L2 bound 2^-7).
FLASH_TOL = {torch.bfloat16: (2 ** -6, 2 ** -4, 2 ** -7),
             torch.float32: (1e-4, 1e-3, 1e-5)}
#: (rtol, atol) of the flash forward's lse, fp32 on both sides
LSE_TOL = (1e-5, 1e-5)

# Ring attention (ops/ring_attention.py: every rank's hops of one ring)
# against rows 5 and 6 over the whole sequence and against the plain
# version, per tensor, as FLASH_TOL's (rtol, atol as a share of the rms,
# most relative L2 error). Each block's output and gradients come out of
# the kernels in the input dtype and are merged or summed in fp32, so a
# bf16 ring rounds each tensor once more than the whole-sequence kernel
# (out: a block's output, then the merge; dQ: up to P block terms, then
# the sum): one more bf16 step at most, inside FLASH_TOL's two. A block
# attended twice or skipped moves a row by a whole share of its
# softmax.
RING_TOL = FLASH_TOL

# GPT-MoE trained through the compiled step (jit.TrainStep, a CUDA graph)
# against the same steps run eagerly from the same weights and key
# stream, fp32, as (rtol, atol) on each step's loss. Step 1 is the same
# kernels on the same inputs; later steps differ by the compiled AdamW's
# device scalars against the eager one's host numbers (low bits of the
# weights), and a routing decision that flips on such a bit (a random-
# routing draw against 2·p, a capacity edge) moves one token's FFN. A
# lost expert, a wrong capacity or a gradient of the wrong scale moves
# the loss by far more.
MOE_LOSS_TOL = (1e-4, 1e-5)

# LayerNorm, as (rtol, atol as a share of the plain tensor's rms): y and
# dx are one rounding of an fp32 value (bf16: 8 mantissa bits); dw and db
# sum thousands of rows in another order (blocks, then the blocks) before
# their one rounding.
LN_TOL = {torch.bfloat16: dict(y=(1.6e-2, 1e-5), dx=(1.6e-2, 1e-4),
                               sums=(1.6e-2, 1e-2)),
          torch.float32: dict(y=(1e-5, 1e-5), dx=(1e-4, 1e-5),
                              sums=(1e-5, 1e-4))}


# A tiny fp32 model on the card (kernels, cuBLAS, TF32 off) against the
# same model on the CPU (plain versions), as (rtol, atol): outputs
# (logits, a decoder stack's output and KV cache) and losses differ by
# sums in other orders and the online against the one-pass softmax, a
# few fp32 steps; a lost key tile or a wrong LayerNorm row moves them by
# orders of magnitude more.
CARD_CPU_TOL = dict(out=(1e-4, 1e-5), loss=(1e-5, 1e-6))


# An A8W8 stack (ops.fused_transformer_block._int8_mm: the int8 fused
# stack, an int8 Llama) in fp32 on the card against the CPU. The int32
# products are exact on both sides, but each activation is first rounded
# onto its token's 255-level grid: an input that differs in its last bits
# between a kernel and its plain version (the flash attention's sum
# order, the RMSNorm's) lands on the neighbouring level now and then,
# which moves the product by that one step times a weight. Held by
# l2_close's (rtol, atol as a share of the rms, most relative L2 error):
# each element within 2^-3 of the output's rms, the whole within a
# relative L2 of 1e-3; a wrong scale or a lost tile moves both by orders
# of magnitude more.
INT8_CARD_CPU_TOL = (0.0, 2 ** -3, 1e-3)


# A vision model trained in fp32 on the card (cuDNN, TF32 off) against
# the CPU, one step from the same weights and batch: (rtol of the loss,
# most relative L2 error of each parameter's gradient). Training-mode
# BatchNorms over small maps divide by a spread of few values, which
# magnifies the two sides' convolution sums: the CPU port against the
# JAX package measured a loss 4e-5 apart and gradient relative L2 errors
# up to 2.7e-4 for ResNet-18 (tests/test_torch_vision.py). A lost
# channel or a wrong running statistic moves both by far more.
VISION_CARD_CPU_TOL = dict(loss=1e-4, grad_rel_l2=1e-3)


# The hybrid step (models.llama.build_hybrid_train_step) over a one-rank
# mesh against the one-device step (build_train_step) from the same
# weights and batch, on the card, as (rtol, atol) on each step's loss.
# Not bitwise by design: the hybrid step takes the cross-entropy's mean
# over all microbatches at once (the reference's ``head_ce`` over the
# stacked outputs) where the one-device step averages each microbatch's
# mean, and its AdamW moves the weights from gradients of that loss; in
# bf16 a reordered fp32 sum flips a gradient's rounding now and then and
# the weights drift apart by a bf16 step. A wrong collective, a scaled
# gradient (1/R, 1/mp) or a lost layer moves the loss by far more.
HYBRID_LOSS_TOL = (1e-3, 1e-4)


# The ragged kernels (row 3) on one chip's head slab of a serving mesh,
# as (rtol, atol) by dtype, against the whole-heads kernel's slice of the
# same call and against the plain version on the slab. Against the plain
# version: the tolerance of phase 3 (the plain version rounds P to bf16
# before P·V, the key split keeps it fp32). Against the whole call: a
# slab of fewer heads may take another key split (ops.paged_attention.
# ragged_split picks it from nh and nkv), so a decoded token's parts are
# merged in another grouping: fp32 sums in another order, then one bf16
# rounding that may go the other way (one bf16 step). Where the split
# is the same, the slab's output is the whole call's slice bitwise.
RAGGED_SLAB_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-5)}


# Llama-2-7B served over a serving mesh of 4 chips against the same
# weights on one chip (chip_smoke phase 38 against phase 7). The
# row-parallel products (wo, w_down) sum four fp32 partials before their
# one rounding where one GEMM rounds its own fp32 sum. In fp32 that is a
# sum order: the first step's logits over 2 layers at 7B widths differ
# by a relative L2 of 3.3e-6, as the one-chip step's own against a
# repacked batch (3.8e-6; fp32_rel_l2). In bf16 each such rounding may
# go the other way by one bf16 step and the residual stream carries it:
# the first step's logits differ by a relative L2 of 2.7e-3 after one
# layer, 0.011 after 4, 0.028 after 16 and 0.044 after 32 (the same at
# mp 2 and 4), the largest |difference| 0.21 of the logits' rms
# (measured on an H100 by scripts/tp_logits_by_depth.py; rel_l2, and
# max_abs as a share of the rms). Past the first step a greedy token may
# leave the one-chip stream only at a near-tie: the one-chip top-2 there
# must hold the mesh's token, with a margin under `margin` of the rms
# (twice max_abs: two logits each moved by up to max_abs). A lost chip's
# partial or a slab attended with another chip's pool moves the logits
# by their own size.
TP_SERVE_TOL = dict(rel_l2=2 ** -4, max_abs=0.375, margin=0.75,
                    fp32_rel_l2=2 ** -16)


# The eager Tensor path (scripts/eager_llama_step.py at tiny widths) on
# the card against the CPU, by precision. "loss" is (rtol, atol); "grads"
# is l2_close's (rtol, atol as a share of the CPU gradient's rms, most
# relative L2 error) for every parameter's gradient. fp32 (TF32 off):
# sums in other orders and the online against the one-pass softmax, as
# CARD_CPU_TOL, through two layers' backward. O1 bf16: every matmul and
# attention output is one bf16 rounding (2^-9 relative) of fp32 sums that
# differ in their last bits between cuBLAS and the CPU, so now and then
# an element rounds the other way by one bf16 step (2^-8) and carries it
# through the layers; a wrong cast (an fp32 matmul, a bf16 norm) or a
# lost tile moves the loss by orders of magnitude more.
EAGER_CARD_CPU_TOL = {
    "fp32": dict(loss=(1e-5, 1e-6), grads=(1e-3, 1e-3, 1e-4)),
    "bf16": dict(loss=(2 ** -8, 1e-4), grads=(2 ** -4, 2 ** -4, 2 ** -5)),
}

# Step 1's loss of the eager O1 path at Llama-2-7B widths (fp32 weights,
# residual stream and norms; bf16 matmul and attention inputs) against
# forward_stacked on the bf16 cast of the same weights (everything bf16),
# as (rtol, atol): the two round different tensors to bf16, which moves a
# ~10.4 loss over a 2048-token mean by a few 1e-3; a missed cast or a
# wrong layer moves it by 0.1 or more.
EAGER_BF16_LOSS_TOL = (2 ** -8, 1e-3)


# The weight-gradient accumulation kernel against its plain version, by
# the accumulator's dtype, as (rtol, atol as a share of the plain output's
# rms). fp32: both sum the same products (exact in fp32 for bf16/fp16
# inputs, one rounding each for fp32 ones) in fp32, in another order; a
# running sum over n rows gathers ~sqrt(n)·2^-24 of its own size in
# rounding, so two orders over 4096 rows differ by up to ~2e-5 of the
# output's rms in the tails (a lost 32-row step moves it by ~9 %). A
# bf16/fp16 accumulator: both round the fp32 product to it, add and round
# again; the product's last fp32 bits decide now and then which way a
# rounding goes, one step of the product (2^-8 relative in bf16, 2^-11 in
# fp16) on an output that may be smaller than the product.
GRAD_ADD_TOL = {torch.float32: (1e-5, 1e-4),
                torch.bfloat16: (2 ** -7, 2 ** -5),
                torch.float16: (2 ** -10, 2 ** -8)}

# An fp32 accumulator of k micro-batches' weight gradients summed by the
# kernel in fp32 against the main_grad that MixPrecisionLayer folds from
# autograd's bf16 gradients, as (rtol, atol as a share of main_grad's rms,
# most relative L2 error): each fold adds one bf16 rounding (2^-9
# relative) of that micro-batch's gradient, which may be larger than the
# sum (k = 4: up to ~2 % of the rms in the tails, ~0.1 % in L2); a
# micro-batch or a tile lost moves the sum by a quarter or more.
MAIN_GRAD_TOL = (2 ** -6, 2 ** -4, 2 ** -7)

# main_grad after the same fp32 main-grad training on two devices, as
# (rtol, atol as a share of the CPU main_grad's rms, most relative L2
# error): sums in other orders, and after an update the weights differ
# by AdamW's noisy steps (up to 2·lr on a 1e-4 share of the elements,
# see trained_weights_close), which moves the gradients those weights
# touch by up to ~1e-3 of the tensor's rms (1.5e-3 on 3 of 65536 o_proj
# elements on an H100) while the relative L2 error stays ~1e-5; a
# micro-batch lost or not averaged moves it to 0.5.
MAIN_GRAD_PARITY_TOL = (1e-3, 1e-2, 1e-4)


# A distribution's continuous draws (``distribution``, ``random``'s
# ``*_draw``) against ``jax.random``'s on the same key, as (rtol, atol);
# the atol is for draws of order 1, where ``loc + scale·x`` cancels.
# ``normal``: normal, uniform, exponential, Laplace, Gumbel, Cauchy and
# log-normal draws: XLA's erfinv, log and tan against torch's, an ulp or
# three of the result (measured: 3 ulps; |Δ| ≤ 3e-7·(1 + |x|)), inside
# ``random.normal_draw``'s stated 1e-6. ``gamma``: the Marsaglia-Tsang
# family (gamma, chi2, beta, Dirichlet, Student's t): each sample is
# d·(1 + c·x)³ with c = 1/3·rsqrt(d), and XLA's CPU rsqrt is a refined
# approximation that differs from the correctly rounded one by an ulp
# in ~1 of 10 elements; near the cancellation of 1 + c·x that ulp and
# the normal's grow to ~25 ulps of the sample (measured 2.5e-6 relative
# over 20000 draws). Accept decisions are not loosened: a flipped one
# gives an unrelated value and is counted as such.
DRAW_TOL = dict(normal=(1e-6, 1e-6), gamma=(4e-6, 1e-6))

# The long tail's card checks (chip_smoke phase 40 (b), the gpu tests),
# fp32 with TF32 off, measured on an H100. ``linalg`` (cuSOLVER and
# cuBLAS on the card, LAPACK on the host) at n = 4096 on well-conditioned
# inputs (3·I plus a normalised random matrix, and its Gram matrix; svd
# and lstsq on random (2048, 2048) and (4096, 2048) ones): ``residual``
# the relative Frobenius error of what a call promises (||A x - b|| /
# ||b||, ||L Lᵀ - S|| / ||S||, ||U S Vᵀ - A|| / ||A||, the normal
# equations' ||Aᵀ(A x - b)|| / ||Aᵀ b||), measured 2e-7 to 8.7e-6 (the
# svd); ``orthogonality`` the largest entry of QᵀQ - I (and of A·A⁻¹ -
# I), measured 3.9e-6 to 5.5e-5 (the svd's U); ``card_cpu`` the relative
# L2 distance of the card's result to the CPU's, measured 1.1e-7 to
# 3.2e-6. Backward-stable fp32 algorithms leave a few ulps times √n; a
# wrong pivot, a lost block or the Jacobi SVD stopping short (6.4e-4,
# 1.0e-3: why ``linalg`` asks cuSOLVER for gesvd) is over.
LINALG_CARD_TOL = dict(residual=1e-4, orthogonality=1e-3, card_cpu=1e-4)

# ``signal``/``audio`` over 32 clips of 10 s (relative L2): the stft →
# istft round trip (a hann window of 400 at hop 160 meets the envelope
# division everywhere past the padding; measured 1.8e-7), and the card's
# stft, mel spectrogram and MFCC against the CPU's (cuFFT against
# pocketfft, an fp32 rounding of each bin apart, then the mel product
# and the log; measured 1.8e-7, 3.5e-6, 8.2e-7).
SIGNAL_CARD_TOL = dict(round_trip=1e-5, card_cpu=1e-5)

# The share of a family's draws that may differ card against CPU under
# the same key beyond ``DRAW_TOL`` (discrete: at all): a rejection
# sampler's accept test on the card and the host can fall on opposite
# sides by an ulp of log, lgamma or pow, which gives an unrelated value.
# Measured at 2^20 draws: 5 (4.8e-6 of them) for Hörmann's Poisson
# sampler at λ 40, none elsewhere; each one is counted.
DRAW_CARD_FLIPS = 1e-4

# ``geometric``/``sparse`` sums (``index_add`` with atomics on the card,
# in order on the host) and Viterbi scores, card against CPU, relative
# L2: a sum of up to ~30 fp32 messages a row in another order (measured
# 2.0e-8 at ogbn-arxiv's size; the Viterbi scores equal). max is equal.
GRAPH_CARD_TOL = dict(sum=1e-5)

def close(got, want, rtol, atol, msg) -> float:
    """``got`` finite and within (rtol, atol) of ``want``, both taken in
    fp32. Returns max |got − want|."""
    gf, wf = got.float(), want.float()
    if not torch.isfinite(gf).all():
        raise AssertionError(f"{msg}: non-finite kernel output")
    torch.testing.assert_close(gf, wf, rtol=rtol, atol=atol,
                               msg=lambda m: f"{msg}: {m}")
    return (gf - wf).abs().max().item()


def rms_close(got, want, rtol, rel_atol, msg) -> float:
    """:func:`close` with an atol of ``rel_atol`` times ``want``'s rms,
    so that a sum over thousands of rows (dw, db) or a small output is
    held to its own scale."""
    rms = want.float().pow(2).mean().sqrt().item()
    return close(got, want, rtol, rel_atol * rms, msg)


def grad_add_close(got, want, msg) -> float:
    """The accumulation kernel's output against its plain version under
    ``GRAD_ADD_TOL`` of the output's dtype. Returns max |got − want|."""
    return rms_close(got, want, *GRAD_ADD_TOL[want.dtype], msg)


def flash_close(got, want, dtype, msg):
    """One flash tensor against its plain version under ``FLASH_TOL``.
    Returns (max |got − want|, relative L2 error)."""
    return l2_close(got, want, FLASH_TOL[dtype], msg)


def main_grad_close(got, want, msg):
    """An fp32 accumulator against ``main_grad`` under
    ``MAIN_GRAD_TOL``. Returns (max |got − want|, relative L2 error)."""
    return l2_close(got, want, MAIN_GRAD_TOL, msg)


def l2_close(got, want, tol, msg):
    """:func:`rms_close` under ``tol = (rtol, rel_atol, l2_tol)``, and a
    relative L2 error of at most ``l2_tol``."""
    rtol, rel_atol, l2_tol = tol
    err = rms_close(got, want, rtol, rel_atol, msg)
    wf = want.float()
    l2 = ((got.float() - wf).norm() / wf.norm()).item()
    if not l2 <= l2_tol:
        raise AssertionError(f"{msg}: relative L2 error {l2} > {l2_tol}")
    return err, l2

# scripts/transformer_mt.py at its tiny widths (chip_smoke phase 33 (a),
# tests/test_torch_transformer_mt.py): the losses of three Model.fit
# steps with dropout 0.1, and the weights after them, from the same
# weights, data and dropout masks on two sides (the two packages on the
# CPU, or the card and the CPU), as (rtol, atol). fp32 sums in other
# orders move the ~4.9 loss by a few 1e-6 relative (1.6e-6 measured
# between the packages); NoamDecay's first steps at d_model 64 are
# ~1e-6, so Adam moves a weight by about that much a step whatever the
# two sides' rounding, and a key bias (a gradient that is zero up to
# rounding, see key_bias_split) by that much in a noisy direction. A lost
# dropout mask or attention mask moves the loss by 1e-2 or more.
MT_FIT = dict(rtol=1e-5, atol=1e-5)


def key_bias_split(name, t, hidden: int):
    """``(key part, the rest)`` of a fused attention's QKV bias (ERNIE's
    ``self_attn.qkv_bias``, a ``FusedMultiTransformer``'s
    ``qkv_biases.<i>``, GPT-MoE's ``attn.qkv.bias``, the stacked ViT's
    ``qkv_b`` of shape (L, 3h)): ``t[..., h:2h]`` and the query and value
    parts; ``(None, t)`` for any other parameter. The key bias's true
    gradient is 0 (a softmax does not see a constant added to a row's
    scores), so what each side computes there is rounding noise, which
    AdamW scales to steps of up to ±lr: it is held to 2·lr·steps
    only."""
    if not (name.endswith("self_attn.qkv_bias") or name == "qkv_b"
            or re.search(r"(^|\.)qkv_biases\.\d+$", name)
            or re.search(r"(^|\.)attn\.qkv\.bias$", name)):
        return None, t
    h = hidden
    return t[..., h:2 * h], torch.cat([t[..., :h], t[..., 2 * h:]], dim=-1)


def trained_weights_close(got: Dict[str, torch.Tensor],
                          want: Dict[str, torch.Tensor], lr: float,
                          steps: int, hidden: int = 0,
                          msg: str = "weights") -> dict:
    """Weights after ``steps`` AdamW steps at ``lr`` from the same start
    on two devices (fp32, sums in other orders): every element within
    2·lr·steps, and all but a 1e-4 share within (rtol 1e-4, atol 1e-5).
    AdamW divides each gradient element by its own running rms, so an
    element whose gradient sits within the two devices' rounding noise
    takes a noisy direction and may move up to 2·lr a step apart. With
    ``hidden``, each key bias is held to the first bound only
    (:func:`key_bias_split`). Returns the largest difference and the
    count outside the tight bound."""
    err, outside, total = 0.0, 0, 0
    for name, w in want.items():
        diff = (got[name].float() - w.float()).abs()
        err = max(err, diff.max().item())
        if diff.max().item() > 2 * lr * steps:
            raise AssertionError(f"{msg} {name}: max |diff| "
                                 f"{diff.max().item()} > 2·lr·steps")
        if hidden:
            _, diff = key_bias_split(name, diff, hidden)
            _, w = key_bias_split(name, w, hidden)
        outside += int((diff > 1e-5 + 1e-4 * w.float().abs()).sum())
        total += diff.numel()
    if outside > 1e-4 * total:
        raise AssertionError(f"{msg}: {outside} of {total} elements outside "
                             "(rtol 1e-4, atol 1e-5)")
    return dict(max_abs_param_err=err, weights_outside_tight_tol=outside,
                weights=total)


def one_cpu_thread() -> None:
    """Run PyTorch's CPU ops in this process on one thread. The tests run
    in several processes at once, at sizes where a pool of one thread
    per core gains nothing: each process's pool then spins on the cores
    the others need, which doubled the CPU time of the test suite and
    slowed its timed tests."""
    torch.set_num_threads(1)
