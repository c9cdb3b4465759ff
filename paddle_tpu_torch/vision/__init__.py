"""``paddle_tpu_torch.vision`` — counterpart of ``paddle_tpu/vision``:
the model zoo (LeNet, VGG, MobileNet, ResNet, ViT, PP-YOLOE), the
detection operators, the numpy transforms and the local-file datasets,
over the port's ``nn``."""

from . import models  # noqa: F401
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
from . import ops  # noqa: F401

from .models import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2, resnext50_32x4d, resnext101_64x4d,
    VGG, vgg11, vgg13, vgg16, vgg19,
    MobileNetV1, mobilenet_v1, MobileNetV2, mobilenet_v2,
    LeNet,
)
