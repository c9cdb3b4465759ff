"""PP-YOLOE — counterpart of ``paddle_tpu/vision/models/ppyoloe.py``: the
anchor-free detector (CSPResNet backbone with effective SE, the CSP-PAN
neck, the ET-head with distribution-focal box regression), its training
loss (varifocal classification, DFL and L1 box terms under the static
centre-radius assigner), ``predict`` (top-k over the static anchor set),
``predict_with_nms``, ``predict_bucketed`` and ``pad_ground_truth``.

Everything keeps the reference's static shapes: the head emits the fixed
anchor set A = Σ H_i·W_i, and selection is a top-k over it. ``predict``'s
top-k breaks ties towards the lower index, as ``lax.top_k`` does (the
stable sort of ``ops.moe_ops._top_k``). The layers take ``Tensor``s or
torch tensors; ``decode``, ``predict`` and ``compute_loss`` run their
arithmetic as one op over the head's outputs (the reference's
``apply``), in fp32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from ... import nn
from ...core.tensor import Tensor
from ...nn import functional as F
from ...nn.functional import _run
from ...ops.moe_ops import _top_k


def _cat(xs, axis):
    return _run(lambda *v: torch.cat(v, dim=axis), *xs, op_name="concat")


class ConvBNLayer(nn.Layer):
    def __init__(self, ch_in, ch_out, filter_size=3, stride=1, groups=1,
                 padding=None, act="silu"):
        super().__init__()
        pad = (filter_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2D(ch_in, ch_out, filter_size, stride=stride,
                              padding=pad, groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(ch_out)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class EffectiveSELayer(nn.Layer):
    """Effective squeeze-excite (CSPResNet's attention block)."""

    def __init__(self, channels):
        super().__init__()
        self.fc = nn.Conv2D(channels, channels, 1)

    def forward(self, x):
        s = _run(lambda v: v.mean(dim=(2, 3), keepdim=True), x, op_name="mean")
        return x * F.hardsigmoid(self.fc(s))


class CSPResBlock(nn.Layer):
    def __init__(self, ch, shortcut=True):
        super().__init__()
        self.conv1 = ConvBNLayer(ch, ch, 3)
        self.conv2 = ConvBNLayer(ch, ch, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.shortcut else y


class CSPResStage(nn.Layer):
    def __init__(self, ch_in, ch_out, n_blocks, stride=2, use_attn=True):
        super().__init__()
        self.down = ConvBNLayer(ch_in, ch_out, 3, stride=stride) \
            if stride > 1 or ch_in != ch_out else None
        mid = ch_out // 2
        self.conv1 = ConvBNLayer(ch_out, mid, 1)
        self.conv2 = ConvBNLayer(ch_out, mid, 1)
        self.blocks = nn.Sequential(*[CSPResBlock(mid)
                                      for _ in range(n_blocks)])
        self.attn = EffectiveSELayer(ch_out) if use_attn else None
        self.conv3 = ConvBNLayer(ch_out, ch_out, 1)

    def forward(self, x):
        if self.down is not None:
            x = self.down(x)
        y1 = self.conv1(x)
        y2 = self.blocks(self.conv2(x))
        y = _cat([y1, y2], 1)
        if self.attn is not None:
            y = self.attn(y)
        return self.conv3(y)


class CSPResNet(nn.Layer):
    """The backbone: feature maps at strides 8, 16 and 32."""

    def __init__(self, width_mult=0.5, depth_mult=0.33):
        super().__init__()
        chs = [int(c * width_mult) for c in (64, 128, 256, 512, 1024)]
        ns = [max(round(n * depth_mult), 1) for n in (3, 6, 6, 3)]
        self.stem = nn.Sequential(
            ConvBNLayer(3, chs[0] // 2, 3, stride=2),
            ConvBNLayer(chs[0] // 2, chs[0], 3, stride=1))
        self.stages = nn.LayerList([
            CSPResStage(chs[0], chs[1], ns[0]),
            CSPResStage(chs[1], chs[2], ns[1]),
            CSPResStage(chs[2], chs[3], ns[2]),
            CSPResStage(chs[3], chs[4], ns[3]),
        ])
        self.out_channels = [chs[2], chs[3], chs[4]]

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, st in enumerate(self.stages):
            x = st(x)
            if i >= 1:
                outs.append(x)
        return outs


class CSPPAN(nn.Layer):
    """Compact CSP-PAN: top-down fusion, then bottom-up aggregation."""

    def __init__(self, in_channels: Sequence[int], out_ch=None):
        super().__init__()
        c3, c4, c5 = in_channels
        o = out_ch or c3
        self.reduce5 = ConvBNLayer(c5, o, 1)
        self.reduce4 = ConvBNLayer(c4, o, 1)
        self.reduce3 = ConvBNLayer(c3, o, 1)
        self.td4 = CSPResStage(2 * o, o, 1, stride=1, use_attn=False)
        self.td3 = CSPResStage(2 * o, o, 1, stride=1, use_attn=False)
        self.down3 = ConvBNLayer(o, o, 3, stride=2)
        self.bu4 = CSPResStage(2 * o, o, 1, stride=1, use_attn=False)
        self.down4 = ConvBNLayer(o, o, 3, stride=2)
        self.bu5 = CSPResStage(2 * o, o, 1, stride=1, use_attn=False)
        self.out_channels = [o, o, o]

    def forward(self, feats):
        f3, f4, f5 = feats
        p5 = self.reduce5(f5)
        up5 = F.interpolate(p5, scale_factor=2, mode="nearest")
        p4 = self.td4(_cat([self.reduce4(f4), up5], 1))
        up4 = F.interpolate(p4, scale_factor=2, mode="nearest")
        p3 = self.td3(_cat([self.reduce3(f3), up4], 1))
        n4 = self.bu4(_cat([self.down3(p3), p4], 1))
        n5 = self.bu5(_cat([self.down4(n4), p5], 1))
        return [p3, n4, n5]


class PPYOLOEHead(nn.Layer):
    """The ET-head: per-level classification and DFL box-distribution
    branches, emitting (B, A, num_classes) logits and (B, A, 4·(m+1))
    distributions over the static anchor set A = Σ H_i·W_i."""

    def __init__(self, in_channels: Sequence[int], num_classes=80,
                 reg_max=16, strides=(8, 16, 32)):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.strides = list(strides)
        self.stems_cls = nn.LayerList(
            [ConvBNLayer(c, c, 3) for c in in_channels])
        self.stems_reg = nn.LayerList(
            [ConvBNLayer(c, c, 3) for c in in_channels])
        self.pred_cls = nn.LayerList(
            [nn.Conv2D(c, num_classes, 1) for c in in_channels])
        self.pred_reg = nn.LayerList(
            [nn.Conv2D(c, 4 * (reg_max + 1), 1) for c in in_channels])
        self._proj = np.arange(reg_max + 1, dtype=np.float32)
        self._on_device = {}

    def anchor_centers(self, shapes):
        """The static anchor centres in input pixels (A, 2) and each
        anchor's stride (A,), numpy."""
        pts, sts = [], []
        for (h, w), s in zip(shapes, self.strides):
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            c = np.stack([(xs + 0.5) * s, (ys + 0.5) * s], -1).reshape(-1, 2)
            pts.append(c.astype(np.float32))
            sts.append(np.full((h * w,), s, np.float32))
        return np.concatenate(pts), np.concatenate(sts)

    def device_anchors(self, shapes, device):
        """``anchor_centers`` and the DFL projection as tensors on
        ``device``, made once a (shapes, device): a compiled step's
        capture reads them there and copies nothing from the host."""
        key = (tuple(shapes), str(device))
        if key not in self._on_device:
            c, st = self.anchor_centers(shapes)
            self._on_device[key] = tuple(
                torch.from_numpy(a).to(device) for a in (c, st, self._proj))
        return self._on_device[key]

    def forward(self, feats):
        cls_list, reg_list, shapes = [], [], []
        for i, f in enumerate(feats):
            b, c, h, w = f.shape
            shapes.append((h, w))
            cl = self.pred_cls[i](self.stems_cls[i](f) + f)
            rg = self.pred_reg[i](self.stems_reg[i](f))
            cls_list.append(cl.reshape([b, self.num_classes, h * w]))
            reg_list.append(rg.reshape([b, 4 * (self.reg_max + 1), h * w]))
        cls = _run(lambda *v: torch.cat(v, dim=-1).transpose(1, 2),
                   *cls_list, op_name="concat")               # (B, A, C)
        reg = _run(lambda *v: torch.cat(v, dim=-1).transpose(1, 2),
                   *reg_list, op_name="concat")               # (B, A, 4(m+1))
        return cls, reg, shapes

    def decode(self, cls, reg, shapes):
        """(sigmoid scores (B, A, C), boxes (B, A, 4) xyxy in pixels)."""
        m = self.reg_max

        def fn(clv, rgv):
            c, st, proj = self.device_anchors(shapes, rgv.device)
            b, a, _ = rgv.shape
            dist = torch.softmax(rgv.reshape(b, a, 4, m + 1).float(), dim=-1)
            d = torch.einsum("bakm,m->bak", dist, proj)
            d = d * st[None, :, None]
            cx, cy = c[:, 0], c[:, 1]
            boxes = torch.stack([cx[None] - d[..., 0], cy[None] - d[..., 1],
                                 cx[None] + d[..., 2], cy[None] + d[..., 3]],
                                dim=-1)
            return torch.sigmoid(clv.float()), boxes

        return _run(fn, cls, reg, op_name="ppyoloe_decode", n_outputs=2)


class PPYOLOE(nn.Layer):
    """Backbone, neck and head. ``forward(images)`` -> (scores, boxes) on
    the static anchor set; ``compute_loss`` trains it."""

    def __init__(self, num_classes=80, width_mult=0.5, depth_mult=0.33):
        super().__init__()
        self.backbone = CSPResNet(width_mult, depth_mult)
        self.neck = CSPPAN(self.backbone.out_channels)
        self.head = PPYOLOEHead(self.neck.out_channels, num_classes)
        self.num_classes = num_classes

    def forward(self, images):
        cls, reg, shapes = self.head(self.neck(self.backbone(images)))
        return self.head.decode(cls, reg, shapes)

    def predict(self, images, score_threshold=0.25, top_k=100):
        """The top_k anchors by best class score (ties to the lower
        index): (scores, boxes, int32 labels, keep = score >=
        threshold)."""
        scores, boxes = self(images)

        def fn(sv, bv):
            best = sv.amax(dim=-1)                          # (B, A)
            label = sv.argmax(dim=-1)                       # first max
            val, idx = _top_k(best, top_k)
            sel = torch.gather(bv, 1, idx[..., None].expand(-1, -1, 4))
            lab = torch.gather(label, 1, idx)
            return val, sel, lab.to(torch.int32), val >= score_threshold

        return _run(fn, scores, boxes, op_name="ppyoloe_predict",
                    n_outputs=4)

    def predict_with_nms(self, images, score_threshold=0.25, top_k=100,
                         nms_threshold=0.6, keep_top_k=30):
        """The full postprocess: ``predict``, then per-image
        class-aware NMS (``vision.ops.nms``). Returns per-image lists of
        numpy (boxes (M, 4), scores (M,), labels (M,) int64)."""
        from .. import ops as vops

        def host(t):
            return getattr(t, "_value", t).detach().cpu().numpy()

        val, sel, lab, keep = (host(t) for t in self.predict(
            images, score_threshold, top_k))
        results = []
        for b in range(val.shape[0]):
            m = keep[b]
            if not m.any():
                results.append((np.zeros((0, 4), np.float32),
                                np.zeros((0,), np.float32),
                                np.zeros((0,), np.int64)))
                continue
            boxes, scores, labels = sel[b][m], val[b][m], lab[b][m]
            kept = vops.nms(torch.from_numpy(boxes), nms_threshold,
                            torch.from_numpy(scores),
                            torch.from_numpy(labels.astype(np.int32)),
                            categories=list(range(self.num_classes)),
                            top_k=keep_top_k).numpy()
            results.append((boxes[kept], scores[kept],
                            labels[kept].astype(np.int64)))
        return results

    def predict_bucketed(self, images, score_threshold=0.25, top_k=100,
                         batch_buckets=(1, 2, 4, 8)):
        """``predict`` with the batch padded up to the next bucket (at
        most ``len(batch_buckets)`` signatures for ragged batches); the
        padded rows are sliced off."""
        from ...jit.bucketing import pad_to_bucket
        padded, b = pad_to_bucket(images, axis=0, buckets=batch_buckets,
                                  pad_value=0.0)
        val, sel, lab, keep = self.predict(padded, score_threshold, top_k)
        return val[:b], sel[:b], lab[:b], keep[:b]

    def compute_loss(self, images, gt_boxes, gt_labels, radius=2.5):
        """gt_boxes (B, G, 4) xyxy pixels (pads: zeros), gt_labels (B, G)
        int (-1 = pad). An anchor is positive for the first ground truth
        whose centre lies within ``radius · stride`` of it."""
        cls, reg, shapes = self.head(self.neck(self.backbone(images)))
        m = self.head.reg_max
        C = self.num_classes

        def fn(clv, rgv, gb, gl):
            c, st, proj = self.head.device_anchors(shapes, clv.device)
            b, a, _ = clv.shape
            gb = gb.float()
            cx = (gb[..., 0] + gb[..., 2]) / 2                 # (B, G)
            cy = (gb[..., 1] + gb[..., 3]) / 2
            valid_gt = gl >= 0
            dx = torch.abs(c[None, :, 0, None] - cx[:, None, :])
            dy = torch.abs(c[None, :, 1, None] - cy[:, None, :])
            rad = radius * st[None, :, None]
            near = (dx < rad) & (dy < rad) & valid_gt[:, None, :]  # (B,A,G)
            assigned = near.int().argmax(dim=-1)      # first match
            pos = near.any(dim=-1)                             # (B, A)
            tgt_box = torch.gather(gb, 1,
                                   assigned[..., None].expand(-1, -1, 4))
            tgt_lab = torch.gather(gl.long(), 1, assigned)

            # classification: varifocal-style BCE, IoU-free quality target
            onehot = TF.one_hot(torch.where(pos, tgt_lab,
                                            torch.zeros_like(tgt_lab)),
                                C).float()
            tgt = onehot * pos[..., None]
            p = torch.sigmoid(clv.float())
            weight = torch.where(tgt > 0, tgt, 0.75 * p ** 2)
            bce = -(tgt * torch.log(torch.clamp(p, 1e-7, 1.0))
                    + (1 - tgt) * torch.log(torch.clamp(1 - p, 1e-7, 1.0)))
            n_pos = torch.clamp(pos.sum().float(), min=1.0)
            loss_cls = (weight * bce).sum() / n_pos

            # box: DFL + L1 on the positive anchors
            lt = torch.stack([c[None, :, 0] - tgt_box[..., 0],
                              c[None, :, 1] - tgt_box[..., 1]], -1)
            rb = torch.stack([tgt_box[..., 2] - c[None, :, 0],
                              tgt_box[..., 3] - c[None, :, 1]], -1)
            dist_t = torch.cat([lt, rb], -1) / st[None, :, None]
            dist_t = torch.clamp(dist_t, 0, m - 0.01)          # (B, A, 4)
            dl = torch.floor(dist_t)
            wr = dist_t - dl
            dl = dl.long()
            logd = torch.log_softmax(rgv.reshape(b, a, 4, m + 1).float(),
                                     dim=-1)

            def pick(idx):
                return torch.gather(logd, -1, idx[..., None])[..., 0]

            dfl = -(pick(dl) * (1 - wr) + pick(dl + 1) * wr)
            dist_p = torch.einsum("bakm,m->bak", torch.exp(logd), proj)
            l1 = torch.abs(dist_p - dist_t)
            loss_box = ((dfl + l1).mean(-1) * pos).sum() / n_pos
            return loss_cls + 0.5 * loss_box

        return _run(fn, cls, reg, _arg(gt_boxes, cls), _arg(gt_labels, cls),
                    op_name="ppyoloe_loss")


def _arg(x, like):
    """A host array given beside Tensors is made one (the reference's
    ``Tensor(jnp.asarray(...))``); beside torch tensors, a tensor on
    their device."""
    if isinstance(x, (Tensor, torch.Tensor)):
        return x
    if isinstance(like, Tensor):
        return Tensor(np.asarray(x))
    return torch.as_tensor(np.asarray(x), device=like.device)


def ppyoloe_s(num_classes=80, **kw):
    return PPYOLOE(num_classes, width_mult=0.5, depth_mult=0.33, **kw)


def ppyoloe_m(num_classes=80, **kw):
    return PPYOLOE(num_classes, width_mult=0.75, depth_mult=0.67, **kw)


def ppyoloe_l(num_classes=80, **kw):
    return PPYOLOE(num_classes, width_mult=1.0, depth_mult=1.0, **kw)


def pad_ground_truth(boxes_list, labels_list, buckets=(8, 16, 32, 64)):
    """A ragged list of per-image ground truths padded to the dense
    (B, G, 4) / (B, G) layout ``compute_loss`` takes (labels -1 = pad),
    G rounded up to a bucket (a bounded set of signatures). Returns
    Tensors on the current place."""
    from ...jit.bucketing import next_bucket
    b = len(boxes_list)
    gmax = max((np.shape(bx)[0] for bx in boxes_list), default=1)
    g = next_bucket(max(gmax, 1), buckets)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.full((b, g), -1, np.int32)
    for i, (bx, lb) in enumerate(zip(boxes_list, labels_list)):
        n = np.shape(bx)[0]
        if n:
            boxes[i, :n] = np.asarray(bx, np.float32)
            labels[i, :n] = np.asarray(lb, np.int32)
    return Tensor(boxes), Tensor(labels)
