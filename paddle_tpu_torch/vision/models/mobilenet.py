"""MobileNet V1 and V2 — counterpart of
``paddle_tpu/vision/models/mobilenet.py``. A depthwise convolution is a
grouped ``Conv2D`` (``groups`` = channels), cuDNN's on the card."""

from __future__ import annotations

from ... import nn


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, relu6=False):
        padding = (kernel - 1) // 2
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_c),
            nn.ReLU6() if relu6 else nn.ReLU(),
        )


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.dw = _ConvBNReLU(in_c, in_c, 3, stride=stride, groups=in_c)
        self.pw = _ConvBNReLU(in_c, out_c, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return int(ch * scale)

        cfg = [  # (out, stride)
            (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
            (1024, 2), (1024, 1),
        ]
        layers = [_ConvBNReLU(3, c(32), 3, stride=2)]
        in_c = c(32)
        for out, stride in cfg:
            layers.append(_DepthwiseSeparable(in_c, c(out), stride))
            in_c = c(out)
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(in_c, hidden, 1, relu6=True))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden, relu6=True),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False),
            nn.BatchNorm2D(out_c),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        layers = [_ConvBNReLU(3, in_c, 3, stride=2, relu6=True)]
        for t, c_, n, s in cfg:
            out_c = _make_divisible(c_ * scale)
            for i in range(n):
                layers.append(InvertedResidual(in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        layers.append(_ConvBNReLU(in_c, last_c, 1, relu6=True))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (offline build)")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled (offline build)")
    return MobileNetV2(scale=scale, **kwargs)
