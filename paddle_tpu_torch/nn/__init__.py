"""Layers and functions — counterpart of ``paddle_tpu/nn``: the ``Layer``
base and its containers, ``ParamAttr``, the standard layers, the
recurrent layers, beam-search decoding, the Transformer family, the
``layers_extra`` batch,
``functional``, ``initializer`` and ``utils``. ``nn.quant`` (the
quantization slice) is not ported and raises."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .layer import (  # noqa: F401
    HookRemoveHelper, Layer, LayerList, ParameterList, ParamAttr, Sequential,
)
from .common_layers import (  # noqa: F401
    Linear, Embedding, Identity, Flatten, Dropout, Dropout2D, Upsample,
    Conv1D, Conv2D, Conv3D, Conv2DTranspose,
    LayerNorm, RMSNorm, BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
    SyncBatchNorm, GroupNorm, InstanceNorm2D,
    MaxPool2D, MaxUnPool2D, AvgPool2D, AdaptiveAvgPool2D, AdaptiveMaxPool2D,
    ReLU, ReLU6, GELU, SiLU, Swish, Mish, Sigmoid, Tanh, Hardswish, Hardsigmoid,
    Hardtanh, ELU, SELU, CELU, Softplus, Softsign, Tanhshrink, Hardshrink,
    Softshrink, LogSoftmax, LeakyReLU, PReLU, Softmax,
    CrossEntropyLoss, MSELoss, L1Loss, NLLLoss, BCELoss, BCEWithLogitsLoss,
    SmoothL1Loss, KLDivLoss, Pad2D, PixelShuffle,
)
from .rnn import (  # noqa: F401
    SimpleRNN, LSTM, GRU, RNN, SimpleRNNCell, LSTMCell, GRUCell,
)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoderLayer, TransformerEncoder,
    TransformerDecoderLayer, TransformerDecoder, Transformer,
)
from .layers_extra import (  # noqa: F401
    MaxPool1D, AvgPool1D, AdaptiveAvgPool1D, Pad1D, Pad3D, ZeroPad2D,
    UpsamplingBilinear2D, GLU, AlphaDropout, LocalResponseNorm,
    InstanceNorm1D, Bilinear, CosineSimilarity, PairwiseDistance,
    Unfold, Fold, HuberLoss, MarginRankingLoss, TripletMarginLoss,
    SpectralNorm,
    ChannelShuffle, Softmax2D, ThresholdedReLU, RReLU, CTCLoss,
    CosineEmbeddingLoss, GaussianNLLLoss, HingeEmbeddingLoss,
    MultiLabelSoftMarginLoss, MultiMarginLoss, PoissonNLLLoss,
    SoftMarginLoss, AdaptiveLogSoftmaxWithLoss,
)


def __getattr__(name):
    if name == "quant":
        from ..ops._common import not_ported
        raise not_ported("paddle_tpu_torch.nn.quant", "quantization")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
