"""``paddle_tpu_torch.audio`` — audio feature extraction, counterpart of
``paddle_tpu/audio``: ``functional`` (mel scales, filterbanks, the DCT,
windows, ``power_to_db``), ``features`` (the Spectrogram, MelSpectrogram,
LogMelSpectrogram and MFCC layers over ``signal.stft``) and ``backends``
(WAV input and output through the standard ``wave`` module)."""

from . import functional  # noqa: F401
from . import features  # noqa: F401
from . import backends  # noqa: F401

__all__ = ["functional", "features", "backends"]
