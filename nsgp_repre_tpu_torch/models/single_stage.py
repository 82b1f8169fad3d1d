"""RetinaNet, and the dense-head predict both single-stage detectors share.

Counterpart of nsgp_repre_tpu/models/single_stage.py (mmdet
single_stage.py, retina_head.py, _base_/models/retinanet_r50_fpn.py):
- ``RetinaHead``: 4-conv cls and reg towers shared across the pyramid
  levels, ``retina_cls`` (A·C sigmoid logits, bias -log(99)) and
  ``retina_reg`` (A·4 deltas). Module names follow mmdet
  (``bbox_head.cls_convs.{i}.conv``, ``bbox_head.retina_cls``).
- ``RetinaNet``: ResNet-50, FPN(start_level=1, extra convs on the input)
  and octave anchors (4·2^(k/3), 3 ratios, strides 8-128). ``loss``
  (single_stage.py:199-245): MaxIoU 0.5/0.4/0 with the padded-canvas
  anchor flags, focal classification and L1 regression over every
  non-ignored anchor, both divided by the positives. ``predict``
  (:247-304): per-level top-``nms_pre`` over the level's anchors x
  classes, decode, one class-aware NMS through the NMS kernel.

Neither trains with a random draw; ``loss`` takes the two-stage
families' ``generator``/``priorities`` arguments and reads neither. No
kernel runs on a training step (the assignment is the plain
``max_iou_assign``, as in JAX); predict launches NMS once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.anchors import AnchorGenerator
from ..ops.nms_cuda import batched_nms
from ..ops.topk import top_k
from ..structures.boxes import bbox2delta, delta2bbox
from ..structures.sample import DetBatch, InstanceArray
from .assigners import NEG, max_iou_assign
from .detector import anchor_valid_flags, he_normal_, normal_, reset_norms_and_biases, xavier_
from .fpn import FPN, ConvModule
from .layers import CovConv, nchw, nhwc
from .losses import global_avg_factor, weighted_l1, weighted_sigmoid_focal
from .resnet import ResNet50

PRIOR_BIAS = float(-np.log((1 - 0.01) / 0.01))  # retina_head.py init_cfg bias_prob=0.01


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    """Static hyperparameters (retinanet_r50_fpn.py); the JAX package's
    fields and defaults. ``use_approx_topk`` is read by JAX on a TPU only
    (top-k is exact here)."""

    num_classes: int = 20
    # anchors (octave scales: 4 * 2^(k/3))
    anchor_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    octave_base_scale: float = 4.0
    scales_per_octave: int = 3
    # head
    feat_channels: int = 256
    stacked_convs: int = 4
    # assign (train_cfg)
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    min_pos_iou: float = 0.0
    # focal loss
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    # test cfg
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou: float = 0.5
    max_per_img: int = 100
    # backbone
    backbone_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    frozen_stages: int = 1
    compute_dtype: str = "float32"
    use_approx_topk: bool = True
    pad_size_divisor: int = 32

    @property
    def anchor_scales(self) -> Tuple[float, ...]:
        return tuple(self.octave_base_scale * 2.0 ** (k / self.scales_per_octave)
                     for k in range(self.scales_per_octave))

    @property
    def num_base_priors(self) -> int:
        return len(self.anchor_ratios) * self.scales_per_octave


def flat_maps(maps: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """Per-level NHWC head maps (B, H, W, A·k) → f32 (B, N, k), anchors in
    (level, y, x, a) order."""
    B = maps[0].shape[0]
    return torch.cat([m.reshape(B, -1, k) for m in maps], dim=1).float()


def dense_predict(probs: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
                  level_sizes: Sequence[int], batch: DetBatch, nms_pre: int, score_thr: float,
                  nms_iou: float, max_per_img: int, stds=(1.0, 1.0, 1.0, 1.0),
                  rescale: bool = True) -> InstanceArray:
    """A dense head's detections (base_dense_head.py predict_by_feat,
    single_stage.py:247-304 and ssd.py:312-372 in JAX): per level the
    top ``nms_pre`` of its anchors x classes scores (ties to the lowest
    index), their boxes decoded and clipped to the image, then one
    class-aware NMS over all levels (the kernel on the card).

    probs (B, N, C) class scores; deltas (B, N, 4); anchors (N, 4)."""
    B, _, C = probs.shape
    dev = probs.device
    shape = batch.img_shape.to(device=dev, dtype=torch.float32)
    max_shape = (shape[:, 0].view(B, 1, 1), shape[:, 1].view(B, 1, 1))
    boxes_l, scores_l, labels_l = [], [], []
    off = 0
    for n_l in level_sizes:
        flat = probs[:, off:off + n_l].reshape(B, -1)
        k = min(nms_pre, n_l * C)
        top_s, top_i = top_k(flat, k)
        a_idx = torch.div(top_i, C, rounding_mode="floor")
        d = torch.gather(deltas[:, off:off + n_l], 1, a_idx[..., None].expand(B, k, 4))
        boxes_l.append(delta2bbox(anchors[off:off + n_l][a_idx], d, stds=stds,
                                  max_shape=max_shape))
        scores_l.append(top_s)
        labels_l.append((top_i % C).to(torch.int32))
        off += n_l
    boxes = torch.cat(boxes_l, dim=1)
    scores = torch.cat(scores_l, dim=1)
    labels = torch.cat(labels_l, dim=1)
    if rescale:
        scale = batch.scale_factor.to(device=dev, dtype=torch.float32)
        boxes = boxes / torch.cat([scale, scale], dim=1)[:, None, :]
    keep_idx, dv = batched_nms(boxes, scores, labels, scores > score_thr, nms_iou, max_per_img)
    keep = keep_idx.long()
    return InstanceArray(boxes=torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)),
                         labels=torch.gather(labels, 1, keep), valid=dv,
                         scores=torch.gather(scores, 1, keep))


class DenseDetector(nn.Module):
    """What RetinaNet and SSD share: the compute dtype, NHWC feature
    extraction (no fused inference rewrite, as in JAX) and the anchors on
    the maps' device, built once per map size."""

    def __init__(self, config):
        super().__init__()
        if config.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {config.compute_dtype!r}")
        self.config = config
        self._anchor_cache: Dict[tuple, Tuple[torch.Tensor, List[int]]] = {}

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32

    def priority_shapes(self, batch_size: int, gt_slots: int,
                        num_anchors: int) -> Dict[str, Tuple[int, int]]:
        """No sampling draw: the loss reads none."""
        return {}

    def extract_feat(self, images: torch.Tensor, inference: bool = False) -> Tuple[torch.Tensor, ...]:
        """images (B,H,W,3) → NHWC levels in the compute dtype; ``inference``
        is taken for the two-stage families' signature and changes nothing."""
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return tuple(nhwc(f) for f in self.neck(self.backbone(x)))

    def _anchors(self, feats) -> Tuple[torch.Tensor, List[int]]:
        """All levels' anchors (N, 4) on the maps' device and each level's
        anchor count, from the family's ``_grid_anchors(sizes)``."""
        sizes = [(int(f.shape[1]), int(f.shape[2])) for f in feats]
        key = (tuple(sizes), str(feats[0].device))
        if key not in self._anchor_cache:
            per_level = self._grid_anchors(sizes)
            self._anchor_cache[key] = (
                torch.from_numpy(np.concatenate(per_level, axis=0).astype(np.float32)).to(
                    feats[0].device),
                [len(a) for a in per_level])
        return self._anchor_cache[key]


class RetinaHead(nn.Module):
    """Cls/reg conv towers shared across pyramid levels (retina_head.py:16-84)."""

    def __init__(self, num_classes: int, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, num_base_priors: int = 9):
        super().__init__()
        self.num_classes = num_classes
        self.num_base_priors = num_base_priors
        self.cls_convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3, padding=1)
            for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3, padding=1)
            for i in range(stacked_convs)])
        self.retina_cls = CovConv(feat_channels, num_base_priors * num_classes, 3, padding=1)
        self.retina_reg = CovConv(feat_channels, num_base_priors * 4, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """NHWC levels → per level (cls (B,H,W,A·C), deltas (B,H,W,A·4))."""
        cls_out, reg_out = [], []
        for f in feats:
            c = r = nchw(f)
            for conv in self.cls_convs:
                c = torch.relu(conv(c))
            for conv in self.reg_convs:
                r = torch.relu(conv(r))
            cls_out.append(nhwc(self.retina_cls(c)))
            reg_out.append(nhwc(self.retina_reg(r)))
        return cls_out, reg_out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.01) kernels, zero biases but the prior bias of retina_cls."""
        for m in self.modules():
            if isinstance(m, CovConv):
                normal_(m.weight, 0.01, generator)
                m.bias.zero_()
        self.retina_cls.bias.fill_(PRIOR_BIAS)


class RetinaNet(DenseDetector):
    """Backbone + FPN(start_level=1, extra convs on the input) + RetinaHead."""

    def __init__(self, config: RetinaNetConfig):
        super().__init__(config)
        cfg = config
        self.backbone = ResNet50(stage_blocks=cfg.backbone_blocks, frozen_stages=cfg.frozen_stages)
        ins = [256 * 2 ** i for i in range(len(cfg.backbone_blocks))]
        self.neck = FPN(ins, 256, num_outs=5, start_level=1, add_extra_convs="on_input")
        self.bbox_head = RetinaHead(cfg.num_classes, 256, cfg.feat_channels, cfg.stacked_convs,
                                    cfg.num_base_priors)
        self.anchor_gen = AnchorGenerator(strides=cfg.anchor_strides, ratios=cfg.anchor_ratios,
                                          scales=cfg.anchor_scales)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RetinaNet":
        """JAX's initializers: He normal (fan_out) backbone convs,
        Xavier-uniform FPN, N(0, 0.01) head convs, zero biases but the
        classifier's prior bias -log(99), identity BN."""
        for m in self.backbone.modules():
            if isinstance(m, CovConv):
                he_normal_(m.weight, generator)
        for m in self.neck.modules():
            if isinstance(m, CovConv):
                xavier_(m.weight, generator)
        reset_norms_and_biases(self)
        self.bbox_head.init_weights(generator)
        return self

    def _grid_anchors(self, sizes):
        return self.anchor_gen.grid_anchors(sizes)

    def _flat(self, feats):
        cls_maps, reg_maps = self.bbox_head(feats)
        return flat_maps(cls_maps, self.config.num_classes), flat_maps(reg_maps, 4)

    def loss(self, batch: DetBatch, generator=None,
             priorities: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``loss_cls`` (focal) and ``loss_bbox`` (L1) over every
        non-ignored anchor (anchor_head.py:309 with PseudoSampler).
        ``batch.images`` are normalized."""
        cfg = self.config
        C = cfg.num_classes
        feats = self.extract_feat(batch.images)
        cls_flat, reg_flat = self._flat(feats)
        anchors, _ = self._anchors(feats)
        dev = cls_flat.device
        gt = batch.gt.to(dev)
        sizes = [(int(f.shape[1]), int(f.shape[2])) for f in feats]
        valid = anchor_valid_flags(cfg, sizes, batch.img_shape.to(dev))
        assigned, _ = max_iou_assign(anchors, gt.boxes, gt.valid, cfg.pos_iou_thr,
                                     cfg.neg_iou_thr, cfg.min_pos_iou, match_low_quality=True,
                                     prior_valid=valid)
        pos = assigned >= 0
        neg = assigned == NEG
        g = torch.clamp(assigned, min=0).long()
        labels = torch.where(pos, torch.gather(gt.labels, 1, g), C)
        B, N = g.shape
        matched = torch.gather(gt.boxes, 1, g[..., None].expand(B, N, 4))
        tgt = bbox2delta(anchors.expand(B, N, 4), matched)
        num_pos = global_avg_factor(pos.sum())
        return {
            "loss_cls": weighted_sigmoid_focal(cls_flat, labels, (pos | neg).float(), num_pos, C,
                                               gamma=cfg.focal_gamma, alpha=cfg.focal_alpha),
            "loss_bbox": weighted_l1(reg_flat, tgt, pos[..., None].float(), num_pos),
        }

    @torch.no_grad()
    def predict(self, batch: DetBatch, rescale: bool = True) -> InstanceArray:
        """Normalized images → padded detections (max_per_img per image)."""
        cfg = self.config
        feats = self.extract_feat(batch.images)
        cls_flat, reg_flat = self._flat(feats)
        anchors, level_sizes = self._anchors(feats)
        return dense_predict(torch.sigmoid(cls_flat), reg_flat, anchors, level_sizes, batch,
                             cfg.nms_pre, cfg.score_thr, cfg.nms_iou, cfg.max_per_img,
                             rescale=rescale)
