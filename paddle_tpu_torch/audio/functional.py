"""Mel, DCT and window helpers — counterpart of
``paddle_tpu/audio/functional.py``, the reference's HTK and Slaney
formulas in torch on the current place (or the input's device)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from ..core.tensor import Tensor

__all__ = [
    "hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
    "compute_fbank_matrix", "power_to_db", "create_dct", "get_window",
]


def _dev():
    from ..core.place import current_place
    return current_place().torch_device()


def _t(x):
    return x._value if isinstance(x, Tensor) else x


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(x, dtype=torch.float32, device=_dev())


def _dtype(dtype):
    from ..core.dtype import convert_dtype
    return convert_dtype(dtype)


def hz_to_mel(freq, htk: bool = False):
    """Hz → mel: Slaney (the default) is linear below 1 kHz and
    logarithmic above; ``htk`` is 2595·log10(1 + f/700)."""
    f = _t(freq)
    scalar = not isinstance(f, torch.Tensor) or f.dim() == 0
    f = _f32(f)
    if htk:
        out = 2595.0 * torch.log10(1.0 + f / 700.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        mels = (f - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        out = torch.where(f >= min_log_hz,
                          min_log_mel + torch.log(f / min_log_hz) / logstep,
                          mels)
    return float(out) if scalar and not isinstance(freq, Tensor) \
        else Tensor(out)


def mel_to_hz(mel, htk: bool = False):
    """mel → Hz (the inverse of :func:`hz_to_mel`)."""
    m = _t(mel)
    scalar = not isinstance(m, torch.Tensor) or m.dim() == 0
    m = _f32(m)
    if htk:
        out = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        freqs = f_min + f_sp * m
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        out = torch.where(m >= min_log_mel,
                          min_log_hz * torch.exp(logstep * (m - min_log_mel)),
                          freqs)
    return float(out) if scalar and not isinstance(mel, Tensor) \
        else Tensor(out)


def mel_frequencies(n_mels: int = 64, f_min: float = 0.0,
                    f_max: float = 11025.0, htk: bool = False,
                    dtype: str = "float32"):
    """``n_mels`` mel-spaced frequencies in [f_min, f_max] (Hz)."""
    lo = float(_t(hz_to_mel(f_min, htk=htk)))
    hi = float(_t(hz_to_mel(f_max, htk=htk)))
    mels = torch.linspace(lo, hi, n_mels, dtype=torch.float32, device=_dev())
    return Tensor(_t(mel_to_hz(Tensor(mels), htk=htk)).to(_dtype(dtype)))


def fft_frequencies(sr: int, n_fft: int, dtype: str = "float32"):
    """The rfft bins' centre frequencies: linspace(0, sr/2, 1 + n_fft//2)."""
    return Tensor(torch.linspace(0, sr / 2.0, 1 + n_fft // 2,
                                 dtype=torch.float32, device=_dev())
                  .to(_dtype(dtype)))


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 0.0, f_max: Optional[float] = None,
                         htk: bool = False, norm: Union[str, float] = "slaney",
                         dtype: str = "float32"):
    """The mel filterbank (n_mels, 1 + n_fft//2): triangular filters
    between successive mel frequencies."""
    if f_max is None:
        f_max = float(sr) / 2
    fftfreqs = _t(fft_frequencies(sr, n_fft))
    mel_f = _t(mel_frequencies(n_mels + 2, f_min=f_min, f_max=f_max,
                               htk=htk))
    fdiff = torch.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]    # (n_mels+2, n_bins)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.clamp_min(torch.minimum(lower, upper), 0.0)
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    elif isinstance(norm, (int, float)):
        norms = torch.linalg.vector_norm(weights, ord=norm, dim=-1,
                                         keepdim=True)
        weights = weights / torch.clamp_min(norms, 1e-10)
    return Tensor(weights.to(_dtype(dtype)))


def power_to_db(spect, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0):
    """Power → decibels, floored at ``amin`` and clamped ``top_db`` below
    the maximum."""
    if amin <= 0:
        raise ValueError("amin must be strictly positive")
    if ref_value <= 0:
        raise ValueError("ref_value must be strictly positive")
    x = _f32(_t(spect))
    log_spec = 10.0 * torch.log10(torch.clamp_min(x, amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be non-negative")
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return Tensor(log_spec)


def create_dct(n_mfcc: int, n_mels: int, norm: Optional[str] = "ortho",
               dtype: str = "float32"):
    """The DCT-II matrix (n_mels, n_mfcc) of the MFCC."""
    n = torch.arange(n_mels, dtype=torch.float32, device=_dev())
    k = torch.arange(n_mfcc, dtype=torch.float32, device=_dev())
    dct = torch.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    if norm is None:
        dct = dct * 2.0
    elif norm == "ortho":
        scale = torch.full((n_mfcc,), math.sqrt(2.0 / n_mels), device=_dev())
        scale[0] = math.sqrt(1.0 / n_mels)
        dct = dct * scale[None, :]
    else:
        raise ValueError(f"unsupported norm: {norm!r}")
    return Tensor(dct.to(_dtype(dtype)))


def get_window(window: Union[str, tuple], win_length: int,
               fftbins: bool = True, dtype: str = "float32"):
    """A window by name: hann, hamming, blackman, bartlett,
    kaiser(beta), gaussian(std), general_gaussian(p, sig),
    exponential(center, tau), triang, bohman. Of the reference's set only
    ``taylor`` is absent (named in the error). ``fftbins=True`` gives the
    periodic form (the symmetric window of N + 1, cut to N)."""
    if isinstance(window, tuple):
        name, *args = window
    else:
        name, args = window, []
    n = win_length + 1 if fftbins else win_length
    i = torch.arange(n, dtype=torch.float32, device=_dev())
    if name == "hann":
        w = 0.5 - 0.5 * torch.cos(2 * math.pi * i / (n - 1))
    elif name == "hamming":
        w = 0.54 - 0.46 * torch.cos(2 * math.pi * i / (n - 1))
    elif name == "blackman":
        a = 2 * math.pi * i / (n - 1)
        w = 0.42 - 0.5 * torch.cos(a) + 0.08 * torch.cos(2 * a)
    elif name == "bartlett":
        w = 1.0 - torch.abs(2.0 * i / (n - 1) - 1.0)
    elif name == "triang":
        # scipy's triang: no zero endpoints
        if n % 2 == 0:
            w = torch.where(i < n / 2, (2 * i + 1) / n, (2 * (n - i) - 1) / n)
        else:
            w = 1.0 - torch.abs(i - (n - 1) / 2.0) / ((n + 1) / 2.0)
    elif name == "bohman":
        x = torch.abs(2.0 * i / (n - 1) - 1.0)
        w = (1 - x) * torch.cos(math.pi * x) + torch.sin(math.pi * x) / math.pi
        w = torch.where(x >= 1.0, torch.zeros_like(w), w)
    elif name == "kaiser":
        beta = float(args[0]) if args else 12.0
        x = 2.0 * i / (n - 1) - 1.0
        w = torch.special.i0(beta * torch.sqrt(torch.clamp_min(
            1 - x * x, 0.0))) / torch.special.i0(_f32(beta))
    elif name == "gaussian":
        std = float(args[0]) if args else 1.0
        x = i - (n - 1) / 2.0
        w = torch.exp(-0.5 * (x / std) ** 2)
    elif name == "general_gaussian":
        p = float(args[0]) if args else 1.0
        sig = float(args[1]) if len(args) > 1 else 1.0
        x = i - (n - 1) / 2.0
        w = torch.exp(-0.5 * torch.abs(x / sig) ** (2 * p))
    elif name == "exponential":
        center = args[0] if args else None
        tau = float(args[1]) if len(args) > 1 else 1.0
        c = (n - 1) / 2.0 if center is None else float(center)
        w = torch.exp(-torch.abs(i - c) / tau)
    else:
        raise ValueError(
            f"unsupported window: {name!r} (taylor is the one reference "
            "window not implemented; the rest are listed in the docstring)")
    if fftbins:
        w = w[:-1]
    return Tensor(w.to(_dtype(dtype)))
