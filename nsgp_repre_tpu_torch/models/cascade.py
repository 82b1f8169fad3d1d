"""Cascade R-CNN and Cascade Mask R-CNN.

Counterpart of nsgp_repre_tpu/models/cascade.py (mmdet cascade_rcnn.py,
cascade_roi_head.py; _base_/models/cascade-rcnn_r50_fpn.py and
cascade-mask-rcnn_r50_fpn.py):
- three bbox stages (``roi_head.bbox_head.{i}``, mmdet's names) with
  assigner IoUs 0.5/0.6/0.7, per-stage delta stds, stage loss weights
  (1, 0.5, 0.25), class-agnostic regression and SmoothL1 (beta 1);
- each stage samples ``rcnn_num`` RoIs per image from the gts and the
  previous stage's boxes, and the next stage refines the sampled RoIs
  with this stage's deltas, dropping the rows that came from the
  injected gts (refine_bboxes ``pos_is_gts``);
- predict: the stages refine the proposals; the score is the softmax of
  the mean of the stage logits; one multiclass NMS over R·C candidates
  (the same refined box for every class).

Cascade Mask R-CNN adds the FCN mask head (models/mask.py) on a separate
final-stage sample of the proposals, as the JAX module does
(cascade.py:304-418): the cascade's own sample and that one share the
proposals, which JAX recomputes from the same features.

Sampling priorities, in the order JAX splits its keys (split(rng,
num_stages + 1): the RPN, then one key per stage; each stage's key split
per image): ``rpn`` (B, N anchors), then ``s{i}`` and ``s{i}_2`` (B, G +
P_i) for stage i, P_0 = ``rpn_max_per_img`` and P_i = ``rcnn_num`` after
it; Cascade Mask R-CNN first splits its key in two (the cascade's, the
mask branch's) and adds ``mask`` and ``mask_2`` (B, G + P_0). Missing ones
are drawn from a ``torch.Generator`` in that order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.nms_cuda import batched_nms
from ..structures.boxes import bbox_clip, delta2bbox
from ..structures.sample import DetBatch, InstanceArray
from .bbox_head import Shared2FCBBoxHeadTask
from .detector import DetectorConfig, FasterRCNN, _RoIHead
from .losses import accuracy, global_avg_factor, weighted_smooth_l1, weighted_softmax_ce
from .mask import MaskBranch


@dataclasses.dataclass(frozen=True)
class CascadeConfig(DetectorConfig):
    """Cascade knobs on top of the two-stage defaults."""

    num_stages: int = 3
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)
    stage_pos_iou: Tuple[float, ...] = (0.5, 0.6, 0.7)
    stage_stds: Tuple[Tuple[float, ...], ...] = (
        (0.1, 0.1, 0.2, 0.2),
        (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067),
    )
    rpn_smooth_l1_beta: float = 1.0 / 9.0
    rcnn_smooth_l1_beta: float = 1.0
    # cascade-rcnn_r50_fpn.py train rpn_proposal max_per_img=2000
    rpn_max_per_img: int = 2000


@dataclasses.dataclass(frozen=True)
class CascadeMaskConfig(CascadeConfig):
    mask_size: int = 28
    mask_roi_out_size: int = 14
    mask_convs: int = 4
    mask_channels: int = 256
    gt_mask_size: int = 56


class CascadeRCNN(FasterRCNN):
    """Backbone + FPN + RPN + the cascade's stage heads."""

    def _build_roi_head(self) -> nn.Module:
        cfg: CascadeConfig = self.config
        nc = cfg.num_classes
        return _RoIHead(nn.ModuleList([
            Shared2FCBBoxHeadTask(task_split=(0, nc), task_id=1, num_classes=nc,
                                  reg_class_agnostic=True)
            for _ in range(cfg.num_stages)]))

    def _bbox_heads(self) -> List[Shared2FCBBoxHeadTask]:
        return list(self.roi_head.bbox_head)

    @staticmethod
    def _clip(boxes: torch.Tensor, img_shape: torch.Tensor, batch_idx: torch.Tensor):
        """Clip flat boxes (N, 4) to their images' (h, w)."""
        shape = img_shape.to(device=boxes.device, dtype=torch.float32)[batch_idx.long()]
        return bbox_clip(boxes, (shape[:, 0], shape[:, 1]))

    # ------------------------------------------------------------------
    def priority_shapes(self, batch_size: int, gt_slots: int,
                        num_anchors: int) -> Dict[str, Tuple[int, int]]:
        """``rpn`` (B, anchors), then ``s{i}`` and ``s{i}_2`` (B, G + P_i)
        per stage."""
        cfg: CascadeConfig = self.config
        out = {"rpn": (batch_size, num_anchors)}
        for i in range(cfg.num_stages):
            n = (batch_size, gt_slots + (cfg.rpn_max_per_img if i == 0 else cfg.rcnn_num))
            out[f"s{i}"] = out[f"s{i}_2"] = n
        return out

    def roi_loss(self, feats, proposals: InstanceArray, gt: InstanceArray,
                 img_shape: Optional[torch.Tensor] = None,
                 priorities: Optional[Dict[str, torch.Tensor]] = None, generator=None,
                 replay_feats=None, replay_labels=None) -> Dict[str, torch.Tensor]:
        """The three stages' ``s{i}.loss_cls``, ``s{i}.loss_bbox`` and
        ``s{i}.acc`` on ``proposals`` (cascade.py:178-225); FasterRCNN's
        arguments, ``img_shape`` required (the refined boxes are clipped to
        it), ``replay_*`` accepted and unused, as in JAX."""
        cfg: CascadeConfig = self.config
        if img_shape is None:
            raise ValueError("the cascade's roi_loss clips its refined boxes to img_shape")
        p = priorities or {}
        B = proposals.boxes.shape[0]
        dev = proposals.boxes.device
        gt = gt.to(dev)
        G = gt.boxes.shape[1]
        losses = {}
        cur = proposals
        for i in range(cfg.num_stages):
            shape = (B, G + cur.boxes.shape[1])
            u = self._priorities(p.get(f"s{i}"), shape, generator, dev)
            u2 = self._priorities(p.get(f"s{i}_2"), shape, generator, dev)
            thr = (cfg.stage_pos_iou[i],) * 3
            rois, batch_idx, labels, valid, pos, tgt, is_gt = self._sample(
                cur, gt, u, u2, thr, cfg.stage_stds[i])
            cls_score, bbox_pred = self.bbox_head[i](self._roi_feats(feats, rois, batch_idx))
            cls_score = cls_score.float()
            bbox_pred = bbox_pred.float()
            w = cfg.stage_loss_weights[i]
            label_w = valid.float()
            avg = global_avg_factor(label_w.sum())
            losses[f"s{i}.loss_cls"] = w * weighted_softmax_ce(cls_score, labels, label_w, avg)
            losses[f"s{i}.loss_bbox"] = w * weighted_smooth_l1(
                bbox_pred, tgt, pos[:, None].float(), avg, beta=cfg.rcnn_smooth_l1_beta)
            losses[f"s{i}.acc"] = accuracy(cls_score, labels, label_w, avg)
            if i < cfg.num_stages - 1:
                # refine the sampled RoIs with this stage's deltas; drop the
                # rows of the injected gts
                refined = self._clip(delta2bbox(rois, bbox_pred.detach(), stds=cfg.stage_stds[i]),
                                     img_shape, batch_idx)
                cur = InstanceArray(
                    boxes=refined.reshape(B, cfg.rcnn_num, 4),
                    labels=torch.zeros((B, cfg.rcnn_num), dtype=torch.int32, device=dev),
                    valid=(valid & ~is_gt).reshape(B, cfg.rcnn_num),
                )
        return losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, batch: DetBatch, rescale: bool = True) -> InstanceArray:
        feats = self.extract_feat(batch.images)
        return self._predict_feats(feats, batch, rescale)

    def _predict_feats(self, feats, batch: DetBatch, rescale: bool) -> InstanceArray:
        """cascade.py:228-301 on extracted features."""
        cfg: CascadeConfig = self.config
        _, proposals = self.rpn_loss_and_proposals(feats, batch.gt, batch.img_shape,
                                                   with_loss=False)
        B, R = proposals.boxes.shape[:2]
        dev = proposals.boxes.device
        batch_idx = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(R)
        boxes = proposals.boxes.reshape(-1, 4)
        ms_scores = []
        bbox_pred = None
        for i in range(cfg.num_stages):
            cls_score, bbox_pred = self.bbox_head[i](self._roi_feats(feats, boxes, batch_idx))
            ms_scores.append(cls_score.float())
            bbox_pred = bbox_pred.float()
            if i < cfg.num_stages - 1:
                boxes = self._clip(delta2bbox(boxes, bbox_pred, stds=cfg.stage_stds[i]),
                                   batch.img_shape, batch_idx)
        # the mean of the stage logits, then the softmax
        cls_score = sum(ms_scores) / cfg.num_stages
        final = self._clip(delta2bbox(boxes, bbox_pred, stds=cfg.stage_stds[-1]),
                           batch.img_shape, batch_idx).reshape(B, R, 4)
        C = cfg.num_classes
        probs = torch.softmax(cls_score, dim=-1)[:, :C].reshape(B, R, C)
        if rescale:
            scale = batch.scale_factor.to(device=dev, dtype=torch.float32)
            final = final / torch.cat([scale, scale], dim=-1)[:, None, :]
        # class-agnostic regression: the same box for every class
        fb = final.repeat_interleave(C, dim=1)
        fs = probs.reshape(B, R * C)
        fl = torch.arange(C, dtype=torch.int32, device=dev).repeat(B, R)
        ok = (fs > cfg.score_thr) & proposals.valid.repeat_interleave(C, dim=1)
        keep_idx, dv = batched_nms(fb, fs, fl, ok, cfg.nms_iou, cfg.max_per_img)
        keep = keep_idx.long()
        return InstanceArray(
            boxes=torch.gather(fb, 1, keep[..., None].expand(-1, -1, 4)),
            labels=torch.gather(fl, 1, keep),
            valid=dv,
            scores=torch.gather(fs, 1, keep),
        )


class CascadeMaskRCNN(MaskBranch, CascadeRCNN):
    """The cascade's bbox stages + one FCN mask head trained on a
    final-stage sample (cascade.py:312-398; mmdet trains a mask head per
    stage, the JAX package one on the final stage's assigner)."""

    def __init__(self, config: CascadeMaskConfig):
        super().__init__(config)
        self._add_mask_head()

    def priority_shapes(self, batch_size: int, gt_slots: int,
                        num_anchors: int) -> Dict[str, Tuple[int, int]]:
        """The cascade's draws, then ``mask`` and ``mask_2`` (B, G + P_0)."""
        n = (batch_size, gt_slots + self.config.rpn_max_per_img)
        return {**super().priority_shapes(batch_size, gt_slots, num_anchors),
                "mask": n, "mask_2": n}

    def roi_loss(self, feats, proposals: InstanceArray, gt: InstanceArray,
                 img_shape: Optional[torch.Tensor] = None,
                 priorities: Optional[Dict[str, torch.Tensor]] = None, generator=None,
                 replay_feats=None, replay_labels=None) -> Dict[str, torch.Tensor]:
        """The stages' losses, then, when the gts carry masks, ``loss_mask``
        on a sample of ``proposals`` with the final stage's assigner and
        coder (priorities ``mask``/``mask_2``)."""
        cfg: CascadeMaskConfig = self.config
        p = priorities or {}
        losses = super().roi_loss(feats, proposals, gt, img_shape, p, generator)
        dev = proposals.boxes.device
        gt = gt.to(dev)
        if gt.masks is None:
            return losses
        shape = (proposals.boxes.shape[0], gt.boxes.shape[1] + proposals.boxes.shape[1])
        u = self._priorities(p.get("mask"), shape, generator, dev)
        u2 = self._priorities(p.get("mask_2"), shape, generator, dev)
        rois, batch_idx, labels, _, pos, _, _ = self._sample(
            proposals, gt, u, u2, (cfg.stage_pos_iou[-1],) * 3, cfg.stage_stds[-1])
        losses["loss_mask"] = self._mask_loss(feats, rois, batch_idx, labels, pos, gt)
        return losses

    def _predict_feats(self, feats, batch: DetBatch, rescale: bool) -> InstanceArray:
        dets = super()._predict_feats(feats, batch, rescale)
        return self._predict_masks(feats, dets, batch, rescale)
