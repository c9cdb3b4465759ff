"""The bounds the card's checks hold the port to, in one place so that
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` apply the same ones:
each kernel against its plain version, per tensor and scaled by the
tensor's own rms, and weights trained on the card against the same
training on the CPU. The functions raise ``AssertionError`` on a
miss."""

from __future__ import annotations

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


def flash_close(got, want, dtype, msg):
    """One flash tensor against its plain version under ``FLASH_TOL``.
    Returns (max |got − want|, relative L2 error)."""
    rtol, rel_atol, l2_tol = FLASH_TOL[dtype]
    err = rms_close(got, want, rtol, rel_atol, msg)
    wf = want.float()
    l2 = ((got.float() - wf).norm() / wf.norm()).item()
    if not l2 <= l2_tol:
        raise AssertionError(f"{msg}: relative L2 error {l2} > {l2_tol}")
    return err, l2


def key_bias_split(name, t, hidden: int):
    """``(key part, the rest)`` of a fused attention's ``qkv_bias``
    (``t[h:2h]`` and the query and value parts), ``(None, t)`` for any
    other parameter. The key bias's true gradient is 0 (a softmax does
    not see a constant added to a row's scores), so what each side
    computes there is rounding noise, which AdamW scales to steps of up
    to ±lr: it is held to 2·lr·steps only."""
    if not name.endswith("self_attn.qkv_bias"):
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
