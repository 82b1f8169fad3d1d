"""RPN-only and Fast R-CNN detectors.

Counterpart of nsgp_repre_tpu/models/two_stage_variants.py:
- ``RPN`` (mmdet detectors/rpn.py, _base_/models/rpn_r50_fpn.py): the
  backbone, FPN and RPN head alone; ``loss`` is the RPN loss, ``predict``
  returns the proposals with label 0. It has no RoI head, as the JAX
  module initializes none.
- ``FastRCNN`` (detectors/fast_rcnn.py, fast-rcnn_r50_fpn.py): the
  two-stage detector fed with external proposals.

Both reuse FasterRCNN's machinery. The sampling priorities follow JAX's
keys: RPN.loss hands its key to the RPN whole (``priorities["rpn"]``, one
(N,) draw per image from split(rng, B)), and FastRCNN.loss hands it to
the RoI sampler whole (``priorities["roi"]``/``["roi2"]``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..structures.sample import DetBatch, InstanceArray
from .detector import FasterRCNN


class RPN(FasterRCNN):
    """Standalone region proposal network."""

    def _build_roi_head(self):
        return None

    def _bbox_heads(self):
        return []

    def priority_shapes(self, batch_size: int, gt_slots: int,
                        num_anchors: int) -> Dict[str, Tuple[int, int]]:
        return {"rpn": (batch_size, num_anchors)}

    def loss(self, batch: DetBatch, generator=None,
             priorities: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``loss_rpn_cls`` and ``loss_rpn_bbox``; ``priorities["rpn"]``
        (B, N anchors), else drawn from ``generator``."""
        p = priorities or {}
        feats = self.extract_feat(batch.images)
        losses, _ = self.rpn_loss_and_proposals(feats, batch.gt, batch.img_shape, with_loss=True,
                                                u=p.get("rpn"), generator=generator)
        return losses

    @torch.no_grad()
    def predict(self, batch: DetBatch, rescale: bool = True) -> InstanceArray:
        """The proposals (``rpn_max_per_img`` per image), label 0."""
        feats = self.extract_feat(batch.images)
        _, proposals = self.rpn_loss_and_proposals(feats, batch.gt, batch.img_shape,
                                                   with_loss=False)
        boxes = proposals.boxes
        if rescale:
            scale = batch.scale_factor.to(device=boxes.device, dtype=torch.float32)
            boxes = boxes / torch.cat([scale, scale], dim=-1)[:, None, :]
        return InstanceArray(boxes=boxes, labels=torch.zeros_like(proposals.labels),
                             valid=proposals.valid, scores=proposals.scores)


class FastRCNN(FasterRCNN):
    """Two-stage detector on given proposals (StandardRoIHead.predict)."""

    def priority_shapes(self, batch_size: int, gt_slots: int,
                        num_anchors: int) -> Dict[str, Tuple[int, int]]:
        """``roi`` and ``roi2`` for ``rpn_max_per_img`` given proposals."""
        shapes = super().priority_shapes(batch_size, gt_slots, num_anchors)
        return {"roi": shapes["roi"], "roi2": shapes["roi2"]}

    def loss(self, batch: DetBatch, proposals: InstanceArray, generator=None,
             priorities: Optional[Dict[str, torch.Tensor]] = None,
             roi_gt: Optional[InstanceArray] = None,
             replay_feats: Optional[torch.Tensor] = None,
             replay_labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """RoI-head losses on ``proposals``; ``priorities["roi"]`` and
        ``["roi2"]`` (B, G + P), else drawn from ``generator``."""
        p = priorities or {}
        feats = self.extract_feat(batch.images)
        return self.roi_loss(feats, proposals.to(feats[0].device),
                             roi_gt if roi_gt is not None else batch.gt, batch.img_shape, p,
                             generator, replay_feats, replay_labels)

    @torch.no_grad()
    def predict(self, batch: DetBatch, proposals: InstanceArray,
                rescale: bool = True) -> InstanceArray:
        feats = self.extract_feat(batch.images)
        return self._predict_from_proposals(feats, proposals.to(feats[0].device), batch, rescale)
