"""Functional transforms over numpy HWC uint8 or float arrays —
counterpart of ``paddle_tpu/vision/transforms/functional.py``. They are
numpy, as the reference's are: a transform runs on the host (in a
``DataLoader`` worker), and only the batched array goes to the card."""

from __future__ import annotations

import numbers

import numpy as np


def _as_hwc(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(img, data_format="CHW"):
    """HWC uint8 [0,255] → float32 [0,1], optionally CHW."""
    img = _as_hwc(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format.upper() == "CHW":
        img = img.transpose(2, 0, 1)
    return img


def resize(img, size, interpolation="bilinear"):
    """Bilinear / nearest resize via vectorised numpy gather."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, numbers.Number):
        # short-side resize, preserving aspect ratio (paddle semantics)
        if h <= w:
            oh, ow = int(size), max(1, int(size * w / h))
        else:
            oh, ow = max(1, int(size * h / w)), int(size)
    else:
        oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return img
    in_dtype = img.dtype
    if interpolation == "nearest":
        rows = np.clip((np.arange(oh) + 0.5) * h / oh, 0, h - 1).astype(np.int64)
        cols = np.clip((np.arange(ow) + 0.5) * w / ow, 0, w - 1).astype(np.int64)
        return img[rows[:, None], cols[None, :]]
    # bilinear with half-pixel centres
    fr = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
    fc = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
    r0 = np.floor(fr).astype(np.int64)
    c0 = np.floor(fc).astype(np.int64)
    r1 = np.minimum(r0 + 1, h - 1)
    c1 = np.minimum(c0 + 1, w - 1)
    wr = (fr - r0)[:, None, None]
    wc = (fc - c0)[None, :, None]
    img_f = img.astype(np.float32)
    top = img_f[r0[:, None], c0[None, :]] * (1 - wc) + img_f[r0[:, None], c1[None, :]] * wc
    bot = img_f[r1[:, None], c0[None, :]] * (1 - wc) + img_f[r1[:, None], c1[None, :]] * wc
    out = top * (1 - wr) + bot * wr
    if np.issubdtype(in_dtype, np.integer):
        out = np.clip(np.round(out), 0, np.iinfo(in_dtype).max).astype(in_dtype)
    return out


def crop(img, top, left, height, width):
    img = _as_hwc(img)
    return img[top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _as_hwc(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[:2]
    th, tw = output_size
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return crop(img, top, left, th, tw)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    img = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        pl_, pt, pr, pb = (int(padding),) * 4
    elif len(padding) == 2:
        pl_, pt = int(padding[0]), int(padding[1])
        pr, pb = pl_, pt
    else:
        pl_, pt, pr, pb = (int(p) for p in padding)
    pads = ((pt, pb), (pl_, pr), (0, 0))
    if padding_mode == "constant":
        return np.pad(img, pads, mode="constant", constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, pads, mode=mode)


def normalize(img, mean, std, data_format="CHW"):
    img = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format.upper() == "CHW":
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    return (img - mean.reshape(shape)) / std.reshape(shape)


def adjust_brightness(img, factor):
    img = _as_hwc(img)
    in_dtype = img.dtype
    out = img.astype(np.float32) * factor
    if np.issubdtype(in_dtype, np.integer):
        return np.clip(out, 0, np.iinfo(in_dtype).max).astype(in_dtype)
    return out


def adjust_contrast(img, factor):
    img = _as_hwc(img)
    in_dtype = img.dtype
    img_f = img.astype(np.float32)
    mean = img_f.mean()
    out = (img_f - mean) * factor + mean
    if np.issubdtype(in_dtype, np.integer):
        return np.clip(out, 0, np.iinfo(in_dtype).max).astype(in_dtype)
    return out


def rotate(img, angle, interpolation="nearest", fill=0):
    """Rotate about the image centre (inverse-map nearest sampling)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    rad = -np.deg2rad(angle)  # inverse transform
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ys = (yy - cy) * np.cos(rad) - (xx - cx) * np.sin(rad) + cy
    xs = (yy - cy) * np.sin(rad) + (xx - cx) * np.cos(rad) + cx
    yi = np.round(ys).astype(np.int64)
    xi = np.round(xs).astype(np.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.full_like(img, fill)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def to_grayscale(img, num_output_channels=1):
    img = _as_hwc(img)
    in_dtype = img.dtype
    if img.shape[2] == 1:
        gray = img.astype(np.float32)
    else:
        weights = np.array([0.299, 0.587, 0.114], dtype=np.float32)
        gray = (img[..., :3].astype(np.float32) @ weights)[..., None]
    gray = np.repeat(gray, num_output_channels, axis=2)
    if np.issubdtype(in_dtype, np.integer):
        return np.clip(np.round(gray), 0, np.iinfo(in_dtype).max).astype(in_dtype)
    return gray
