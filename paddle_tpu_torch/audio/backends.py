"""WAV input and output on the host — counterpart of
``paddle_tpu/audio/backends.py``: 8/16/32-bit PCM WAV through the
standard ``wave`` module and numpy (the reference's dependency-free
default backend), and a named error for anything else. A loaded
waveform is a Tensor on the current place."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

from ..core.tensor import Tensor

__all__ = ["load", "save", "info", "list_available_backends",
           "get_current_backend", "set_backend"]


def list_available_backends():
    return ["wave_backend"]


def get_current_backend():
    return "wave_backend"


def set_backend(backend_name: str):
    if backend_name != "wave_backend":
        raise ValueError(
            f"backend {backend_name!r} unavailable: only the stdlib "
            "wave_backend is bundled (this environment has no soundfile)")


def info(filepath: str):
    """Metadata (sample_rate, num_channels, num_frames, bits_per_sample)."""
    with wave.open(filepath, "rb") as f:
        class _Info:
            sample_rate = f.getframerate()
            num_channels = f.getnchannels()
            num_frames = f.getnframes()
            bits_per_sample = f.getsampwidth() * 8
        return _Info()


def load(filepath: str, frame_offset: int = 0, num_frames: int = -1,
         normalize: bool = True, channels_first: bool = True
         ) -> Tuple[Tensor, int]:
    """Load a PCM WAV file → (waveform Tensor, sample_rate). Normalized
    float32 in [-1, 1] by default; (channels, time) when channels_first."""
    with wave.open(filepath, "rb") as f:
        sr = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        f.setpos(frame_offset)
        n = f.getnframes() - frame_offset if num_frames < 0 else num_frames
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16)
        scale = 1 << 15
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32)
        scale = 1 << 31
    elif width == 1:
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128
        scale = 1 << 7
    else:
        raise ValueError(f"unsupported PCM sample width {width} bytes; "
                         "wave_backend reads 8/16/32-bit PCM WAV")
    data = data.reshape(-1, nch)
    if normalize:
        data = data.astype(np.float32) / scale
    if channels_first:
        data = data.T
    return Tensor(np.ascontiguousarray(data)), sr


def save(filepath: str, src, sample_rate: int, channels_first: bool = True,
         encoding: str = "PCM_16", bits_per_sample: int = 16):
    """Save a waveform Tensor to 16-bit PCM WAV."""
    if bits_per_sample != 16 or encoding != "PCM_16":
        raise ValueError("wave_backend writes PCM_16 only")
    x = src._value if isinstance(src, Tensor) else src
    x = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    if not channels_first:
        x = x.T
    if np.issubdtype(x.dtype, np.floating):
        x = np.clip(x, -1.0, 1.0)
        x = (x * ((1 << 15) - 1)).astype(np.int16)
    with wave.open(filepath, "wb") as f:
        f.setnchannels(x.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(np.ascontiguousarray(x.T).tobytes())
