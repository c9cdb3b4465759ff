"""``vision.ops`` — the detection operators of
``paddle_tpu/vision/ops.py``: ``box_iou``, ``nms``, ``roi_align``,
``yolo_box`` and ``box_coder``.

The reference computes them in XLA outside any Pallas kernel, so each is
plain PyTorch here, on the device of its inputs, in the reference's fp32
arithmetic and order: the IoU matrix is one broadcast block, NMS is the
reference's greedy pass over the score-sorted IoU matrix (a box is
suppressed when an earlier KEPT box overlaps it beyond the threshold;
per-category suppression by the coordinate-offset trick), RoIAlign
samples a fixed ``sampling_ratio`` grid per bin (2×2 for
``sampling_ratio <= 0``, the reference's static-shape choice), and
``yolo_box`` zeroes the scores under ``conf_thresh`` instead of dropping
rows.

Given ``Tensor``s (or numpy arrays, made Tensors on the current place as
the reference's ``_t`` does) they go through the dispatcher under the
reference's op names and return Tensors; given torch tensors they run
on them directly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dispatch import any_tensor, apply
from ..core.tensor import Tensor

__all__ = ["box_iou", "nms", "roi_align", "yolo_box", "box_coder"]


def _run(fn, *args, op_name, n_outputs=None):
    args = tuple(Tensor(a) if isinstance(a, (np.ndarray, list)) else a
                 for a in args)
    if any_tensor(*args):
        return apply(fn, *args, op_name=op_name, n_outputs=n_outputs)
    return fn(*args)


def _iou_matrix(a, b):
    """(N, 4), (M, 4) xyxy -> (N, M) IoU in fp32 (l.31-43)."""
    a, b = a.float(), b.float()
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0) \
        * torch.clamp(a[:, 3] - a[:, 1], min=0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0) \
        * torch.clamp(b[:, 3] - b[:, 1], min=0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def box_iou(boxes1, boxes2, name=None):
    """Pairwise IoU of two xyxy box sets."""
    return _run(_iou_matrix, boxes1, boxes2, op_name="box_iou")


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None,
        name=None):
    """Greedy IoU suppression (l.54-106): sort by score (stable, so equal
    scores keep their index order; no scores: document order), one IoU
    matrix, then box i is kept unless an earlier kept box overlaps it by
    more than ``iou_threshold``. With ``category_idxs`` suppression is
    per class (each class shifted to a disjoint tile). Returns the kept
    indices (int64) by descending score, at most ``top_k``."""
    if scores is None and category_idxs is not None:
        raise ValueError("category_idxs requires scores")

    def fn(bx, *rest):
        n = bx.shape[0]
        if rest:
            sc = rest[0].float()
        else:
            sc = -torch.arange(n, dtype=torch.float32, device=bx.device)
        work = bx.float()
        if len(rest) > 1:
            cat = rest[1].float()[:, None]
            span = work.max() - work.min() + 1.0
            work = work + cat * span
        order = torch.argsort(-sc, stable=True)
        iou = _iou_matrix(work[order], work[order])
        # the greedy pass, on the host (the reference's eager tail reads
        # the result there too)
        over = (iou > iou_threshold).cpu()
        kept = torch.zeros(n, dtype=torch.bool)
        for i in range(n):
            kept[i] = not bool((over[i, :i] & kept[:i]).any())
        return order[kept.to(order.device)].long()

    args = [boxes] + ([scores] if scores is not None else []) \
        + ([category_idxs] if category_idxs is not None else [])
    out = _run(fn, *args, op_name="nms")
    return out if top_k is None else out[:top_k]


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True, name=None):
    """(N, C, H, W) features and per-image xyxy RoIs -> (total, C, oh, ow)
    by bilinear sampling (l.109-183): a ``sampling_ratio``² grid of
    points per bin (2×2 when ``sampling_ratio <= 0``, the reference's
    fixed grid), their mean. ``aligned`` shifts by half a pixel."""
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    ratio = sampling_ratio if sampling_ratio > 0 else 2

    def fn(feat, rois, rois_num):
        n, c, h, w = feat.shape
        total = rois.shape[0]
        dev = feat.device
        img_of = torch.searchsorted(
            torch.cumsum(rois_num.long(), 0),
            torch.arange(total, device=dev), right=True)
        off = 0.5 if aligned else 0.0
        rb = rois.float() * spatial_scale - off
        x1, y1, x2, y2 = rb[:, 0], rb[:, 1], rb[:, 2], rb[:, 3]
        rw = torch.clamp(x2 - x1, min=1e-3 if aligned else 1.0)
        rh = torch.clamp(y2 - y1, min=1e-3 if aligned else 1.0)
        bin_w, bin_h = rw / ow, rh / oh
        steps = (torch.arange(ratio, device=dev) + 0.5) / ratio
        gy = y1[:, None, None] + (torch.arange(oh, device=dev)[None, :, None]
                                  + steps[None, None, :]) \
            * bin_h[:, None, None]                          # (T, oh, r)
        gx = x1[:, None, None] + (torch.arange(ow, device=dev)[None, :, None]
                                  + steps[None, None, :]) \
            * bin_w[:, None, None]                          # (T, ow, r)
        shape = (total, oh, ow, ratio, ratio)
        iy = gy[:, :, None, :, None].expand(shape).reshape(total, -1)
        ix = gx[:, None, :, None, :].expand(shape).reshape(total, -1)
        x0, y0 = torch.floor(ix), torch.floor(iy)
        wx, wy = ix - x0, iy - y0
        x0i = torch.clamp(x0.long(), 0, w - 1)
        x1i = torch.clamp(x0i + 1, 0, w - 1)
        y0i = torch.clamp(y0.long(), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        t = img_of[:, None].expand_as(x0i)

        def at(yi, xi):
            return feat[t, :, yi, xi]                       # (T, P, C)

        wx, wy = wx[..., None], wy[..., None]
        vals = (at(y0i, x0i) * (1 - wx) * (1 - wy)
                + at(y0i, x1i) * wx * (1 - wy)
                + at(y1i, x0i) * (1 - wx) * wy
                + at(y1i, x1i) * wx * wy)
        vals = vals.permute(0, 2, 1).reshape(total, c, oh, ow, ratio * ratio)
        return vals.mean(dim=-1)

    return _run(fn, x, boxes, boxes_num, op_name="roi_align")


def yolo_box(x, img_size, anchors: Sequence[int], class_num: int,
             conf_thresh: float = 0.005, downsample_ratio: int = 32,
             clip_bbox: bool = True, scale_x_y: float = 1.0,
             iou_aware: bool = False, iou_aware_factor: float = 0.5,
             name=None):
    """A raw YOLO head (N, A·(5+cls), H, W) -> boxes (N, A·H·W, 4) xyxy in
    image pixels and scores (N, A·H·W, cls) (l.186-238); scores under
    ``conf_thresh`` are zero."""
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    A = anchors.shape[0]

    def fn(xv, imgs):
        n, _, h, w = xv.shape
        dev = xv.device
        v = xv.reshape(n, A, 5 + class_num, h, w).float()
        tx, ty, tw, th, obj = (v[:, :, 0], v[:, :, 1], v[:, :, 2],
                               v[:, :, 3], v[:, :, 4])
        cls = v[:, :, 5:]
        gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None,
                                                              None, :]
        gy = torch.arange(h, dtype=torch.float32, device=dev)[None, None,
                                                              :, None]
        alpha = scale_x_y
        beta = -0.5 * (scale_x_y - 1.0)
        cx = (torch.sigmoid(tx) * alpha + beta + gx) / w
        cy = (torch.sigmoid(ty) * alpha + beta + gy) / h
        anc = torch.from_numpy(anchors).to(dev)
        aw = anc[:, 0][None, :, None, None]
        ah = anc[:, 1][None, :, None, None]
        bw = torch.exp(tw) * aw / (w * downsample_ratio)
        bh = torch.exp(th) * ah / (h * downsample_ratio)
        im_h = imgs[:, 0].float()[:, None, None, None]
        im_w = imgs[:, 1].float()[:, None, None, None]
        x1 = (cx - bw / 2) * im_w
        y1 = (cy - bh / 2) * im_h
        x2 = (cx + bw / 2) * im_w
        y2 = (cy + bh / 2) * im_h
        if clip_bbox:
            zero = torch.zeros((), device=dev)
            x1 = torch.clamp(x1, zero, im_w - 1)
            y1 = torch.clamp(y1, zero, im_h - 1)
            x2 = torch.clamp(x2, zero, im_w - 1)
            y2 = torch.clamp(y2, zero, im_h - 1)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        conf = torch.sigmoid(obj)
        conf = torch.where(conf > conf_thresh, conf, torch.zeros_like(conf))
        scores = torch.sigmoid(cls) * conf[:, :, None]
        boxes = boxes.reshape(n, A * h * w, 4)
        scores = scores.permute(0, 1, 3, 4, 2).reshape(n, A * h * w,
                                                        class_num)
        return boxes, scores

    return _run(fn, x, img_size, op_name="yolo_box", n_outputs=2)


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True, axis: int = 0, name=None):
    """SSD-style box encode / decode against priors (l.241-293)."""
    def fn(prior, var, target):
        prior, target = prior.float(), target.float()
        norm = 0.0 if box_normalized else 1.0
        pw = prior[:, 2] - prior[:, 0] + norm
        ph = prior[:, 3] - prior[:, 1] + norm
        pcx = prior[:, 0] + pw * 0.5
        pcy = prior[:, 1] + ph * 0.5
        if var is not None:
            var = var.float()
        if code_type == "encode_center_size":
            tw = target[:, 2] - target[:, 0] + norm
            th = target[:, 3] - target[:, 1] + norm
            tcx = target[:, 0] + tw * 0.5
            tcy = target[:, 1] + th * 0.5
            out = torch.stack([
                (tcx[:, None] - pcx[None, :]) / pw[None, :],
                (tcy[:, None] - pcy[None, :]) / ph[None, :],
                torch.log(tw[:, None] / pw[None, :]),
                torch.log(th[:, None] / ph[None, :])], dim=-1)
            if var is not None:
                out = out / (var[None, :, :] if var.dim() == 2 else var)
            return out
        t = target
        if var is not None:
            if var.dim() == 2:
                t = t * (var[None, :, :] if axis == 0 else var[:, None, :])
            else:
                t = t * var
        if axis == 0:
            pw_, ph_, pcx_, pcy_ = (pw[None, :], ph[None, :],
                                    pcx[None, :], pcy[None, :])
        else:
            pw_, ph_, pcx_, pcy_ = (pw[:, None], ph[:, None],
                                    pcx[:, None], pcy[:, None])
        ocx = t[..., 0] * pw_ + pcx_
        ocy = t[..., 1] * ph_ + pcy_
        ow_ = torch.exp(t[..., 2]) * pw_
        oh_ = torch.exp(t[..., 3]) * ph_
        return torch.stack([ocx - ow_ * 0.5, ocy - oh_ * 0.5,
                            ocx + ow_ * 0.5 - norm,
                            ocy + oh_ * 0.5 - norm], dim=-1)

    if prior_box_var is None:
        return _run(lambda prior, target: fn(prior, None, target),
                    prior_box, target_box, op_name="box_coder")
    return _run(fn, prior_box, prior_box_var, target_box,
                op_name="box_coder")
