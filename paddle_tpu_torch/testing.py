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
    ``qkv_biases.<i>``): ``t[h:2h]`` and the query and value parts;
    ``(None, t)`` for any other parameter. The key bias's true gradient
    is 0 (a softmax does not see a constant added to a row's scores), so
    what each side computes there is rounding noise, which AdamW scales
    to steps of up to ±lr: it is held to 2·lr·steps only."""
    if not (name.endswith("self_attn.qkv_bias")
            or re.search(r"(^|\.)qkv_biases\.\d+$", name)):
        return None, t
    h = hidden
    return t[h:2 * h], torch.cat([t[:h], t[2 * h:]])


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
