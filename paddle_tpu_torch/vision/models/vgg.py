"""The VGG family — counterpart of ``paddle_tpu/vision/models/vgg.py``
(configurations A, B, D and E, with or without BatchNorm), over the
port's ``nn``."""

from __future__ import annotations

from ... import nn

_cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm=False):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2D(in_channels, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(arch, pretrained=False, batch_norm=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (offline build)")
    return VGG(_make_features(_cfgs[arch], batch_norm=batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, **kwargs)
