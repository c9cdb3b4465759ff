"""Spectrogram, MelSpectrogram, LogMelSpectrogram and MFCC layers —
counterpart of ``paddle_tpu/audio/features.py``: each an ``nn.Layer``
whose forward is ``signal.stft`` → |·|^power → the filterbank → the DCT,
with the window, filterbank and DCT matrices as buffers."""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import signal
from ..core.tensor import Tensor
from ..nn import Layer
from . import functional as F

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


def _v(x):
    return x._value if isinstance(x, Tensor) else x


class Spectrogram(Layer):
    """|STFT|^power of a waveform (…, T) → (…, n_fft//2 + 1, frames)."""

    def __init__(self, n_fft: int = 512, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None,
                 window: Union[str, tuple] = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 dtype: str = "float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        w = F.get_window(window, self.win_length, fftbins=True, dtype=dtype)
        self.register_buffer("window", w)

    def forward(self, x):
        spec = signal.stft(x, self.n_fft, hop_length=self.hop_length,
                           win_length=self.win_length, window=self.window,
                           center=self.center, pad_mode=self.pad_mode,
                           onesided=True)
        v = torch.abs(_v(spec))
        if self.power != 1.0:
            v = v ** self.power
        return Tensor(v)


class MelSpectrogram(Layer):
    """The spectrogram through a mel filterbank: (…, n_mels, frames)."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None,
                 window: Union[str, tuple] = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0,
                 f_max: Optional[float] = None, htk: bool = False,
                 norm: Union[str, float] = "slaney",
                 dtype: str = "float32"):
        super().__init__()
        self._spectrogram = Spectrogram(
            n_fft=n_fft, hop_length=hop_length, win_length=win_length,
            window=window, power=power, center=center, pad_mode=pad_mode,
            dtype=dtype)
        fb = F.compute_fbank_matrix(
            sr=sr, n_fft=n_fft, n_mels=n_mels, f_min=f_min, f_max=f_max,
            htk=htk, norm=norm, dtype=dtype)
        self.register_buffer("fbank_matrix", fb)

    def forward(self, x):
        spec = self._spectrogram(x)
        return Tensor(torch.matmul(self.fbank_matrix, _v(spec)))


class LogMelSpectrogram(Layer):
    """``power_to_db`` of the mel spectrogram."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None,
                 window: Union[str, tuple] = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0,
                 f_max: Optional[float] = None, htk: bool = False,
                 norm: Union[str, float] = "slaney", ref_value: float = 1.0,
                 amin: float = 1e-10, top_db: Optional[float] = None,
                 dtype: str = "float32"):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr=sr, n_fft=n_fft, hop_length=hop_length,
            win_length=win_length, window=window, power=power,
            center=center, pad_mode=pad_mode, n_mels=n_mels, f_min=f_min,
            f_max=f_max, htk=htk, norm=norm, dtype=dtype)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        mel = self._melspectrogram(x)
        return F.power_to_db(mel, ref_value=self.ref_value, amin=self.amin,
                             top_db=self.top_db)


class MFCC(Layer):
    """The DCT of the log-mel spectrogram: (…, n_mfcc, frames)."""

    def __init__(self, sr: int = 22050, n_mfcc: int = 40, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None,
                 window: Union[str, tuple] = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0,
                 f_max: Optional[float] = None, htk: bool = False,
                 norm: Union[str, float] = "slaney", ref_value: float = 1.0,
                 amin: float = 1e-10, top_db: Optional[float] = None,
                 dtype: str = "float32"):
        super().__init__()
        if n_mfcc > n_mels:
            raise ValueError("n_mfcc cannot be larger than n_mels")
        self._log_melspectrogram = LogMelSpectrogram(
            sr=sr, n_fft=n_fft, hop_length=hop_length,
            win_length=win_length, window=window, power=power,
            center=center, pad_mode=pad_mode, n_mels=n_mels, f_min=f_min,
            f_max=f_max, htk=htk, norm=norm, ref_value=ref_value,
            amin=amin, top_db=top_db, dtype=dtype)
        self.register_buffer("dct_matrix",
                             F.create_dct(n_mfcc, n_mels, dtype=dtype))

    def forward(self, x):
        logmel = _v(self._log_melspectrogram(x))
        # (…, n_mels, frames) × (n_mels, n_mfcc) over the mel axis
        return Tensor(torch.einsum("...mf,mk->...kf", logmel,
                                   self.dct_matrix))
