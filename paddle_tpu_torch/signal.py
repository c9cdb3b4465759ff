"""``paddle.signal``: frame, overlap_add, stft, istft — counterpart of
``paddle_tpu/signal.py``.

Framing is a strided view of the window starts (``unfold``) and
overlap-add an ``index_add`` over the same starts; ``stft`` and
``istft`` frame and transform explicitly over ``torch.fft`` with the
reference's conventions (its centre padding, the window centred in
``n_fft``, its ``normalized`` and ``onesided`` handling and the
window-envelope division of ``istft``), not through ``torch.stft``,
whose defaults differ.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .core.dispatch import apply
from .core.tensor import Tensor

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _frame_gather(v, frame_length: int, hop: int):
    """(..., N) -> (..., num_frames, frame_length), the frames starting
    every ``hop`` samples (a view)."""
    return v.unfold(-1, frame_length, hop)


def _starts(num: int, fl: int, hop: int, device):
    return ((torch.arange(num, device=device) * hop)[:, None]
            + torch.arange(fl, device=device)[None, :]).reshape(-1)


def _ola_scatter(frames, hop: int):
    """(..., num_frames, frame_length) -> (..., N) overlap-add, N =
    (num - 1)·hop + frame_length; also the flat sample index of each
    frame element."""
    num, fl = frames.shape[-2], frames.shape[-1]
    n = (num - 1) * hop + fl
    idx = _starts(num, fl, hop, frames.device)
    out = frames.new_zeros(frames.shape[:-2] + (n,))
    return out.index_add(-1, idx, frames.reshape(frames.shape[:-2] + (-1,))), idx


def _pad_last(v, pad: int, mode: str):
    """``jnp.pad`` of the last axis by ``pad`` on both sides in numpy's
    ``mode`` (an index map, so any rank and any pad length)."""
    if mode == "constant":
        return F.pad(v, (pad, pad))
    n = v.shape[-1]
    i = torch.arange(-pad, n + pad, device=v.device)
    if mode == "reflect":
        if n == 1:
            i = torch.zeros_like(i)
        else:
            i = torch.remainder(i, 2 * n - 2)
            i = torch.where(i >= n, 2 * n - 2 - i, i)
    elif mode == "symmetric":
        i = torch.remainder(i, 2 * n)
        i = torch.where(i >= n, 2 * n - 1 - i, i)
    elif mode == "edge":
        i = i.clamp(0, n - 1)
    elif mode == "wrap":
        i = torch.remainder(i, n)
    else:
        raise ValueError(f"unsupported pad_mode {mode!r}")
    return v[..., i]


def frame(x, frame_length: int, hop_length: int, axis: int = -1, name=None):
    """Slice overlapping frames (Paddle's layout; axis 0 or -1):
    axis=-1: (..., N) -> (..., frame_length, num_frames);
    axis=0:  (N, ...) -> (num_frames, frame_length, ...)."""
    if frame_length <= 0 or hop_length <= 0:
        raise ValueError("frame_length and hop_length must be positive")
    if axis not in (0, -1):
        raise ValueError("frame: axis must be 0 or -1 (paddle semantics)")

    def fn(v):
        # by the chosen layout: for 1-D input axis 0 and -1 name the
        # same dimension, but Paddle's output layouts differ
        sig_ax = 0 if axis == 0 else v.dim() - 1
        n = v.shape[sig_ax]
        if frame_length > n:
            raise ValueError(
                f"frame_length {frame_length} > signal length {n}")
        vm = torch.movedim(v, sig_ax, -1)
        frames = _frame_gather(vm, frame_length, hop_length)
        if axis == 0:
            return torch.movedim(torch.movedim(frames, -2, 0), -1, 1)
        return frames.transpose(-1, -2)

    return apply(fn, _t(x), op_name="frame")


def overlap_add(x, hop_length: int, axis: int = -1, name=None):
    """Inverse of :func:`frame` (axis 0 or -1): axis=-1 takes
    (..., frame_length, num_frames), axis=0 (num_frames, frame_length,
    ...); N = (num - 1)·hop + frame_length."""
    if hop_length <= 0:
        raise ValueError("hop_length must be positive")
    if axis not in (0, -1):
        raise ValueError("overlap_add: axis must be 0 or -1")

    def fn(v):
        if axis == 0:
            fr = torch.movedim(torch.movedim(v, 1, -1), 0, -2)
        else:
            fr = v.transpose(-1, -2)                 # (..., num, fl)
        out, _ = _ola_scatter(fr, hop_length)
        if axis == 0:
            out = torch.movedim(out, -1, 0)
        return out

    return apply(fn, _t(x), op_name="overlap_add")


def _padded_window(rest, wl: int, n_fft: int, device):
    w = rest[0].float() if rest else torch.ones(wl, device=device)
    lp = (n_fft - wl) // 2
    return F.pad(w, (lp, n_fft - wl - lp))


def stft(x, n_fft: int, hop_length: Optional[int] = None,
         win_length: Optional[int] = None, window=None, center: bool = True,
         pad_mode: str = "reflect", normalized: bool = False,
         onesided: bool = True, name=None):
    """paddle.signal.stft: (B?, N) real or complex -> (B?, F,
    num_frames) complex spectrogram."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft
    if wl > n_fft:
        raise ValueError("win_length must be <= n_fft")

    def fn(v, *rest):
        if onesided and v.is_complex():
            raise ValueError("onesided is not supported for complex inputs")
        w = _padded_window(rest, wl, n_fft, v.device)
        if center:
            v = _pad_last(v, n_fft // 2, pad_mode)
        if v.shape[-1] < n_fft:
            raise ValueError(
                f"stft: signal length {v.shape[-1]} "
                f"{'(after center padding) ' if center else ''}is shorter "
                f"than n_fft {n_fft}")
        frames = _frame_gather(v, n_fft, hop) * w     # (..., num, n_fft)
        spec = (torch.fft.rfft(frames, dim=-1) if onesided
                else torch.fft.fft(frames, dim=-1))
        if normalized:
            spec = spec / math.sqrt(n_fft)
        return spec.transpose(-1, -2)                 # (..., F, num)

    args = [_t(x)] + ([_t(window)] if window is not None else [])
    return apply(fn, *args, op_name="stft")


def istft(x, n_fft: int, hop_length: Optional[int] = None,
          win_length: Optional[int] = None, window=None, center: bool = True,
          normalized: bool = False, onesided: bool = True,
          length: Optional[int] = None, return_complex: bool = False,
          name=None):
    """paddle.signal.istft: the inverse, divided by the window envelope
    (the COLA division)."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft
    if return_complex and onesided:
        raise ValueError(
            "istft: return_complex=True requires onesided=False "
            "(a onesided spectrum reconstructs a real signal)")

    def fn(v, *rest):
        w = _padded_window(rest, wl, n_fft, v.device)
        spec = v.transpose(-1, -2)                   # (..., num, F)
        if normalized:
            spec = spec * math.sqrt(n_fft)
        if onesided:
            frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
        else:
            frames = torch.fft.ifft(spec, dim=-1)
            if not return_complex:
                frames = frames.real
        frames = frames * w
        num = frames.shape[-2]
        out, idx = _ola_scatter(frames, hop)
        n = out.shape[-1]
        env = torch.zeros(n, device=v.device).index_add(
            0, idx, (w * w).repeat(num))
        out = out / torch.clamp_min(env, 1e-11)
        if center:
            out = out[..., n_fft // 2: n - n_fft // 2]
        if length is not None:
            out = out[..., :length]
        return out

    args = [_t(x)] + ([_t(window)] if window is not None else [])
    return apply(fn, *args, op_name="istft")
