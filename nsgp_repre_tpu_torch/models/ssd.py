"""SSD300: VGG-16 backbone, the SSD extra-layer neck and the multibox head.

Counterpart of nsgp_repre_tpu/models/ssd.py (reference config
cl_faster_rcnn_cfgs/_base_/models/ssd300.py):
- ``SSDVGG`` (mmdet ssd_vgg.py): VGG-16's 13 convs with ceil-mode 2x2
  pools (the JAX package pads with -inf to an even size, the same
  maxima), pool5 3x3/s1/p1, ``fc6`` a 3x3 conv of dilation 6 → 1024,
  ``fc7`` 1x1 → 1024; it returns conv4_3 (after its ReLU) and fc7. The
  layers sit in ``features`` at mmdet's indices (convs at 0, 2, 5, ...,
  28; fc6 at 31, fc7 at 33), so ``backbone.features.{i}`` loads by name.
- ``SSDNeck`` (ssd_neck.py): ``l2_norm`` (f32, its weight 20 at init) on
  conv4_3, and four extra levels, each a 1x1 bottleneck and a 3x3
  (``neck.extra_layers.{i}.{0,1}.conv``), ReLU after each.
- ``SSDHead`` (ssd_head.py): per level one 3x3 conv to A·(C+1) softmax
  logits and one to A·4 deltas (``bbox_head.cls_convs.{i}.0``).
- ``SSD.loss`` (ssd.py:254-310): MaxIoU 0.5/0.5/0 with
  ``gt_max_assign_all=False``, softmax CE with 3:1 hard negatives ranked
  by a stable descending sort of their CE (:func:`hard_negatives`),
  SmoothL1 on the positives' deltas (stds 0.1, 0.1, 0.2, 0.2), each
  image's sums divided by the batch's positives. ``predict``
  (:312-372): softmax without the background, then
  single_stage.py::dense_predict (NMS kernel on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..structures.boxes import bbox2delta
from ..structures.sample import DetBatch, InstanceArray
from .assigners import NEG, max_iou_assign
from .detector import he_normal_, reset_norms_and_biases
from .fpn import ConvModule
from .layers import CovConv, nchw, nhwc
from .losses import global_avg_factor, weighted_smooth_l1
from .single_stage import DenseDetector, dense_predict, flat_maps

# (convs, channels) of VGG-16's blocks
VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def ssd_anchor_sizes(input_size: int = 300, num_levels: int = 6,
                     basesize_ratio_range: Tuple[float, float] = (0.15, 0.9)
                     ) -> Tuple[List[float], List[float]]:
    """min/max anchor sizes per level (mmdet SSDAnchorGenerator)."""
    min_ratio = int(basesize_ratio_range[0] * 100)
    max_ratio = int(basesize_ratio_range[1] * 100)
    step = int(np.floor(max_ratio - min_ratio) / (num_levels - 2))
    min_sizes, max_sizes = [], []
    for ratio in range(min_ratio, max_ratio + 1, step):
        min_sizes.append(int(input_size * ratio / 100))
        max_sizes.append(int(input_size * (ratio + step) / 100))
    # the first level for a 300 input with the range starting at 0.15: 0.07
    min_sizes.insert(0, int(input_size * 7 / 100))
    max_sizes.insert(0, int(input_size * 15 / 100))
    return min_sizes[:num_levels], max_sizes[:num_levels]


def ssd_base_anchors(min_size: float, max_size: float, ratios: Sequence[float],
                     stride: int) -> np.ndarray:
    """One location's anchors, centred at stride / 2 (corner format): ratio
    1 at the min size and at sqrt(min·max), then (r, 1/r) pairs at min."""
    cx = cy = stride / 2.0
    ws, hs = [], []
    for s in (min_size, float(np.sqrt(min_size * max_size))):
        ws.append(s)
        hs.append(s)
    for r in ratios:
        sr = float(np.sqrt(r))
        ws.extend([min_size * sr, min_size / sr])
        hs.extend([min_size / sr, min_size * sr])
    ws = np.asarray(ws, np.float32)
    hs = np.asarray(hs, np.float32)
    return np.stack([cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs], axis=-1)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """The JAX package's SSDConfig (fields and defaults)."""

    num_classes: int = 20
    input_size: int = 300
    strides: Tuple[int, ...] = (8, 16, 32, 64, 100, 300)
    level_ratios: Tuple[Tuple[float, ...], ...] = (
        (2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,), (2.0,))
    basesize_ratio_range: Tuple[float, float] = (0.15, 0.9)
    neck_out_channels: Tuple[int, ...] = (512, 1024, 512, 256, 256, 256)
    l2_norm_scale: float = 20.0
    # train
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.0
    neg_pos_ratio: int = 3
    smoothl1_beta: float = 1.0
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    # test
    nms_pre: int = 1000
    score_thr: float = 0.02
    nms_iou: float = 0.45
    max_per_img: int = 200
    compute_dtype: str = "float32"
    use_approx_topk: bool = True

    @property
    def anchors_per_level(self) -> Tuple[int, ...]:
        return tuple(2 + 2 * len(r) for r in self.level_ratios)


class SSDVGG(nn.Module):
    """VGG-16 through fc7-as-conv (ssd_vgg.py), layers at mmdet's indices."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for b, (n, ch) in enumerate(VGG16):
            for _ in range(n):
                layers += [CovConv(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
            if b == 3:
                self.conv4_3 = len(layers) - 1  # its ReLU, before pool4
            if b < 4:
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        layers += [nn.MaxPool2d(3, 1, padding=1),
                   CovConv(512, 1024, 3, padding=6, dilation=6), nn.ReLU(),
                   CovConv(1024, 1024, 1), nn.ReLU()]
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        conv4_3 = None
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == self.conv4_3:
                conv4_3 = x
        return conv4_3, x


class L2Norm(nn.Module):
    """Channel L2 normalization with a learned per-channel scale, in f32
    (ssd.py:200-206 in JAX: x / (||x|| + 1e-10) * weight, then the input
    dtype)."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True)) + 1e-10
        return (xf / norm * self.weight[:, None, None]).to(x.dtype)


class SSDNeck(nn.Module):
    """L2Norm on conv4_3 and the extra feature levels (ssd_neck.py)."""

    def __init__(self, out_channels: Sequence[int] = (512, 1024, 512, 256, 256, 256),
                 level_strides: Sequence[int] = (2, 2, 1, 1),
                 level_paddings: Sequence[int] = (1, 1, 0, 0), l2_norm_scale: float = 20.0):
        super().__init__()
        self.l2_norm = L2Norm(out_channels[0], l2_norm_scale)
        extra, in_ch = [], out_channels[1]
        for oc, s, p in zip(out_channels[2:], level_strides, level_paddings):
            extra.append(nn.Sequential(ConvModule(in_ch, oc // 2, 1),
                                       ConvModule(oc // 2, oc, 3, padding=p, stride=s)))
            in_ch = oc
        self.extra_layers = nn.ModuleList(extra)

    def forward(self, feats) -> Tuple[torch.Tensor, ...]:
        conv4_3, fc7 = feats
        outs = [self.l2_norm(conv4_3), fc7]
        x = fc7
        for layer in self.extra_layers:
            for conv in layer:
                x = torch.relu(conv(x))
            outs.append(x)
        return tuple(outs)


class SSDHead(nn.Module):
    """Per-level 3x3 cls/reg convs (ssd_head.py)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 anchors_per_level: Sequence[int]):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = nn.ModuleList([
            nn.Sequential(CovConv(c, a * (num_classes + 1), 3, padding=1))
            for c, a in zip(in_channels, anchors_per_level)])
        self.reg_convs = nn.ModuleList([
            nn.Sequential(CovConv(c, a * 4, 3, padding=1))
            for c, a in zip(in_channels, anchors_per_level)])

    def forward(self, feats) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """NHWC levels → per level (cls (B,H,W,A·(C+1)), deltas (B,H,W,A·4))."""
        cls_out = [nhwc(m(nchw(f))) for m, f in zip(self.cls_convs, feats)]
        reg_out = [nhwc(m(nchw(f))) for m, f in zip(self.reg_convs, feats)]
        return cls_out, reg_out


def hard_negatives(ce: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                   neg_pos_ratio: int) -> torch.Tensor:
    """The negatives a MultiBox loss keeps, per image (ssd.py:286-293):
    min(ratio · positives, negatives) of them, ranked by CE descending
    with a stable sort (equal CEs keep anchor order, as ``jnp.argsort``).
    ce, pos, neg (B, N) → (B, N) bool."""
    num_neg = torch.minimum(neg_pos_ratio * pos.sum(dim=1), neg.sum(dim=1))
    neg_ce = torch.where(neg, ce.detach(), torch.full_like(ce, -1.0))
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    return neg & (rank < num_neg[:, None])


class SSD(DenseDetector):
    """SSD300 detector (ssd300.py)."""

    def __init__(self, config: SSDConfig):
        super().__init__(config)
        cfg = config
        self.backbone = SSDVGG()
        self.neck = SSDNeck(cfg.neck_out_channels, l2_norm_scale=cfg.l2_norm_scale)
        self.bbox_head = SSDHead(cfg.num_classes, cfg.neck_out_channels, cfg.anchors_per_level)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SSD":
        """JAX's initializers: He normal (fan_out) convs, zero biases, the
        L2Norm scale at ``l2_norm_scale``."""
        for m in self.modules():
            if isinstance(m, CovConv):
                he_normal_(m.weight, generator)
        reset_norms_and_biases(self)
        self.neck.l2_norm.weight.fill_(self.config.l2_norm_scale)
        return self

    def _grid_anchors(self, sizes):
        cfg = self.config
        min_s, max_s = ssd_anchor_sizes(cfg.input_size, len(cfg.strides), cfg.basesize_ratio_range)
        out = []
        for (fh, fw), stride, mn, mx, ratios in zip(sizes, cfg.strides, min_s, max_s,
                                                    cfg.level_ratios):
            base = ssd_base_anchors(mn, mx, ratios, stride)
            shift_x, shift_y = np.meshgrid(np.arange(fw, dtype=np.float32) * stride,
                                           np.arange(fh, dtype=np.float32) * stride)
            shifts = np.stack([shift_x, shift_y, shift_x, shift_y], -1).reshape(-1, 1, 4)
            out.append((shifts + base[None]).reshape(-1, 4))
        return out

    def _flat(self, feats):
        cls_maps, reg_maps = self.bbox_head(feats)
        return flat_maps(cls_maps, self.config.num_classes + 1), flat_maps(reg_maps, 4)

    def loss(self, batch: DetBatch, generator=None,
             priorities: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``loss_cls`` (CE of the positives and the hard negatives) and
        ``loss_bbox`` (SmoothL1 of the positives), both summed over the
        batch and divided by its positives. ``batch.images`` are normalized."""
        cfg = self.config
        feats = self.extract_feat(batch.images)
        cls_flat, reg_flat = self._flat(feats)
        anchors, _ = self._anchors(feats)
        gt = batch.gt.to(cls_flat.device)
        assigned, _ = max_iou_assign(anchors, gt.boxes, gt.valid, cfg.pos_iou_thr,
                                     cfg.neg_iou_thr, cfg.min_pos_iou, match_low_quality=True,
                                     gt_max_assign_all=False)
        pos = assigned >= 0
        neg = assigned == NEG
        g = torch.clamp(assigned, min=0).long()
        labels = torch.where(pos, torch.gather(gt.labels, 1, g), cfg.num_classes).long()
        B, N = g.shape
        matched = torch.gather(gt.boxes, 1, g[..., None].expand(B, N, 4))
        tgt = bbox2delta(anchors.expand(B, N, 4), matched, stds=cfg.target_stds)
        ce = -torch.gather(torch.log_softmax(cls_flat, -1), 2, labels[..., None])[..., 0]
        w = (pos | hard_negatives(ce, pos, neg, cfg.neg_pos_ratio)).float()
        total_pos = global_avg_factor(pos.sum())
        return {
            "loss_cls": (ce * w).sum(dim=1).sum() / total_pos,
            "loss_bbox": weighted_smooth_l1(reg_flat, tgt, pos[..., None].float(), 1.0,
                                            beta=cfg.smoothl1_beta) / total_pos,
        }

    @torch.no_grad()
    def predict(self, batch: DetBatch, rescale: bool = True) -> InstanceArray:
        """Normalized images → padded detections (max_per_img per image)."""
        cfg = self.config
        feats = self.extract_feat(batch.images)
        cls_flat, reg_flat = self._flat(feats)
        anchors, level_sizes = self._anchors(feats)
        probs = torch.softmax(cls_flat, -1)[..., :cfg.num_classes]
        return dense_predict(probs, reg_flat, anchors, level_sizes, batch, cfg.nms_pre,
                             cfg.score_thr, cfg.nms_iou, cfg.max_per_img, stds=cfg.target_stds,
                             rescale=rescale)
