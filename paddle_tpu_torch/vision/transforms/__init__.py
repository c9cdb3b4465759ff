"""Image transforms — counterpart of
``paddle_tpu/vision/transforms/__init__.py``: the class surface over
:mod:`.functional`, numpy on the host. The random transforms draw from
Python's ``random`` module in the reference's order, so a pipeline
seeded with ``random.seed(s)`` gives the reference's crops, flips,
factors and angles."""

from __future__ import annotations

import numbers
import random as _pyrandom

import numpy as np

from . import functional as F  # noqa: F401
from .functional import (  # noqa: F401
    to_tensor, resize, center_crop, crop, hflip, vflip, normalize, pad,
    adjust_brightness, adjust_contrast, rotate, to_grayscale,
)


class BaseTransform:
    """Transform base (reference: BaseTransform in transforms.py:§0).
    Subclasses implement ``_apply_image``."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        if self.keys is None:
            return self._apply_image(inputs)
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        outputs = []
        for key, data in zip(self.keys, inputs):
            if key == "image":
                outputs.append(self._apply_image(data))
            else:
                outputs.append(data)
        return tuple(outputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed

    def _apply_image(self, img):
        if self.padding is not None:
            img = pad(img, self.padding)
        h, w = img.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            img = pad(img, (max(0, tw - w), max(0, th - h)))
            h, w = img.shape[:2]
        if h == th and w == tw:
            return img
        top = _pyrandom.randint(0, h - th)
        left = _pyrandom.randint(0, w - tw)
        return crop(img, top, left, th, tw)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return hflip(img) if _pyrandom.random() < self.prob else img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if _pyrandom.random() < self.prob else img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * _pyrandom.uniform(*self.scale)
            aspect = np.exp(_pyrandom.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = _pyrandom.randint(0, h - ch)
                left = _pyrandom.randint(0, w - cw)
                img2 = crop(img, top, left, ch, cw)
                return resize(img2, self.size, self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size, self.interpolation)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = mean
        self.std = std
        self.data_format = data_format
        self.to_rgb = to_rgb

    def _apply_image(self, img):
        if self.to_rgb:
            img = np.asarray(img)
            # channel axis position follows data_format (reference reverses
            # BGR→RGB before normalizing)
            img = img[::-1] if self.data_format == "CHW" else img[..., ::-1]
        return normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = _pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = _pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, factor)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def _apply_image(self, img):
        angle = _pyrandom.uniform(*self.degrees)
        return rotate(img, angle)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)
