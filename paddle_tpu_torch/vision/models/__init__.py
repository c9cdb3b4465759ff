"""The vision model zoo — counterpart of ``paddle_tpu/vision/models``."""

from .resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock,
    resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2, resnext50_32x4d, resnext101_64x4d,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, mobilenet_v1, MobileNetV2, mobilenet_v2,
)
from .lenet import LeNet  # noqa: F401
from .vit import (  # noqa: F401
    VisionTransformer, vit_base_patch16_224, vit_large_patch16_224,
    vit_tiny_test,
)
from .ppyoloe import (  # noqa: F401
    PPYOLOE, ppyoloe_s, ppyoloe_m, ppyoloe_l,
)
