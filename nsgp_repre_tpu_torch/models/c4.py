"""Caffe-style single-level Faster and Mask R-CNN: the C4 and DC5 trunks.

Counterpart of nsgp_repre_tpu/models/c4.py (reference configs
faster-rcnn_r50-caffe-c4.py, faster-rcnn_r50-caffe-dc5.py,
mask-rcnn_r50-caffe-c4.py, rpn_r50-caffe-c4.py):
- ``FasterRCNNC4``: ResNet-50 through stage 3, caffe style (C4: stride
  16, 1024 channels, no neck), an RPN head of 1024 hidden channels and 15
  anchors (scales 2-32) on that one level, RoIAlign at 14x14, then the
  shared res5 (``roi_head.shared_head.layer4``, stride 2) and
  :class:`C4BBoxHead` (global average pool, plain ``fc_cls`` (C+1) and
  ``fc_reg`` (4C); ``roi_head.bbox_head.fc_cls`` in mmdet).
- ``FasterRCNNDC5``: ResNet-50 with a dilated stage 5 (strides
  (1,2,2,1), dilations (1,1,1,2): C5 at stride 16, 2048 channels), an RPN
  head of 2048, the task-split Shared2FC head on 7x7x2048.
- ``MaskRCNNC4``: res5 runs once on the sampled RoIs' 14x14 features and
  feeds both the box head and ``FCNMaskHead(num_convs=0)`` (its 2x
  transposed conv gives 14x14 logits; ``mask_size=14``), c4.py:218-323.
- ``RPNC4``: the RPN alone on the C4 trunk (zoo.py:204-212).

They reuse FasterRCNN's machinery with one level (``anchor_strides`` and
``roi_strides`` (16,)). On the card the dense RPN head runs the fused RPN
head kernel at F = 1024 or 2048 (the sparse-loss train step, batch-1
predict), the anchors go through the assign kernel, the proposals and
detections through NMS and the RoI features through the RoIAlign kernels
(forward and backward) on the one level: JAX takes its XLA gather there
(c4.py:129-143) because its windowed kernel needs a coarser level for
canvas-sized RoIs; the one-block-per-RoI kernel has no such limit and
computes the same function.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..ops.roi_align_cuda import multilevel_roi_align
from ..structures.sample import InstanceArray
from .bbox_head import Shared2FCBBoxHeadTask
from .detector import DetectorConfig, FasterRCNN, _RoIHead, he_normal_, normal_
from .layers import CovConv, CovDense, nchw, nhwc
from .mask import MaskRCNN
from .resnet import ResLayer, ResNet50
from .rpn_head import RPNHead
from .two_stage_variants import RPN


def c4_config(num_classes: int = 80, **overrides) -> DetectorConfig:
    """DetectorConfig preset for the C4/DC5 single-level trunk
    (faster-rcnn_r50-caffe-c4.py train/test cfg)."""
    kw = dict(
        num_classes=num_classes,
        task_split=(0, num_classes),
        anchor_strides=(16,),
        anchor_scales=(2.0, 4.0, 8.0, 16.0, 32.0),
        roi_strides=(16,),
        rpn_nms_pre=6000,
        rpn_max_per_img=1000,
        rcnn_num=512,
    )
    kw.update(overrides)
    return DetectorConfig(**kw)


class C4BBoxHead(nn.Module):
    """Global average pool of the res5 RoI features, then plain
    ``fc_cls`` (C + 1, background last) and ``fc_reg`` (BBoxHead
    with_avg_pool=True, bbox_head.py:23)."""

    def __init__(self, num_classes: int, in_channels: int = 2048):
        super().__init__()
        self.fc_cls = CovDense(in_channels, num_classes + 1)
        self.fc_reg = CovDense(in_channels, 4 * num_classes)

    mid_features = staticmethod(Shared2FCBBoxHeadTask.mid_features)

    def forward(self, y5: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, 7, 7, 2048) NHWC res5 features → (cls (R, C+1), reg (R, 4C))."""
        y = y5.mean(dim=(1, 2))
        return self.fc_cls(y), self.fc_reg(y)


class _C4RoIHead(nn.Module):
    """``roi_head.shared_head`` (res5) and ``roi_head.bbox_head``."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.shared_head = ResLayer(stage=3, num_blocks=3, stride=2, style="caffe")
        self.bbox_head = C4BBoxHead(num_classes)


class FasterRCNNC4(FasterRCNN):
    """Faster R-CNN R-50-caffe-C4 (faster-rcnn_r50-caffe-c4.py)."""

    def _build_backbone(self) -> nn.Module:
        cfg = self.config
        return ResNet50(stage_blocks=cfg.backbone_blocks[:3], strides=(1, 2, 2),
                        out_indices=(2,), style="caffe", frozen_stages=cfg.frozen_stages)

    def _build_neck(self):
        return None

    def _build_rpn_head(self) -> nn.Module:
        return RPNHead(1024, 1024, self.config.num_base_priors)

    def _build_roi_head(self) -> nn.Module:
        return _C4RoIHead(self.config.num_classes)

    def _bbox_heads(self):
        return []

    def _init_extra(self, generator: torch.Generator) -> None:
        """res5 like the backbone (He normal), N(0, 0.01) classifier and
        N(0, 0.001) regressor (c4.py:58-62)."""
        for m in self.roi_head.shared_head.modules():
            if isinstance(m, CovConv):
                he_normal_(m.weight, generator)
        normal_(self.bbox_head.fc_cls.weight, 0.01, generator)
        normal_(self.bbox_head.fc_reg.weight, 0.001, generator)

    def _res5(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, 1024) NHWC → (R, 7, 7, 2048) NHWC shared res5 features."""
        return nhwc(self.roi_head.shared_head(nchw(roi_feats)))

    def _roi_head_forward(self, roi_feats: torch.Tensor):
        return self.bbox_head(self._res5(roi_feats))

    def _roi_feats(self, feats, rois, batch_idx):
        """RoIAlign at 14x14 on the one stride-16 level (c4.py:129-143)."""
        cfg = self.config
        return multilevel_roi_align(
            [feats[0].to(self.dtype).contiguous()], rois, batch_idx, strides=cfg.roi_strides,
            output_size=14, sampling_ratio=cfg.roi_sampling_ratio,
            finest_scale=cfg.roi_finest_scale,
        ).to(self.dtype)


class FasterRCNNDC5(FasterRCNN):
    """Faster R-CNN R-50-caffe-DC5 (faster-rcnn_r50-caffe-dc5.py)."""

    def _build_backbone(self) -> nn.Module:
        cfg = self.config
        return ResNet50(stage_blocks=cfg.backbone_blocks, strides=(1, 2, 2, 1),
                        dilations=(1, 1, 1, 2), out_indices=(3,), style="caffe",
                        frozen_stages=cfg.frozen_stages)

    def _build_neck(self):
        return None

    def _build_rpn_head(self) -> nn.Module:
        return RPNHead(2048, 2048, self.config.num_base_priors)

    def _build_roi_head(self) -> nn.Module:
        cfg = self.config
        return _RoIHead(Shared2FCBBoxHeadTask(task_split=cfg.task_split, task_id=cfg.task_id,
                                              num_classes=cfg.num_classes, in_channels=2048))


class MaskRCNNC4(MaskRCNN, FasterRCNNC4):
    """Mask R-CNN R-50-caffe-C4 (mask-rcnn_r50-caffe-c4.py): the mask head
    (no convs) on the same res5 features as the box head; MaskRCNN's
    predict, FasterRCNNC4's trunk and heads."""

    mask_in_channels = 2048

    def _roi_losses(self, feats, rois, batch_idx, labels, valid, pos, tgt,
                    gt: InstanceArray) -> Dict[str, torch.Tensor]:
        """The box losses and, when the gts carry masks, ``loss_mask``,
        both on one res5 pass over the sampled RoIs (c4.py:243-304)."""
        y5 = self._res5(self._roi_feats(feats, rois, batch_idx))
        losses = self._cls_reg_losses(*self.bbox_head(y5), labels, valid, pos, tgt)
        if gt.masks is not None:
            losses["loss_mask"] = self._mask_bce(self.mask_head(y5).float(), rois, batch_idx,
                                                 labels, pos, gt)
        return losses

    def _mask_logits(self, feats, rois, batch_idx) -> torch.Tensor:
        """RoIAlign 14x14, res5, the mask head: f32 (N, 14, 14, C) logits
        (predict's mask branch, c4.py:306-323)."""
        return self.mask_head(self._res5(self._roi_feats(feats, rois, batch_idx))).float()


class RPNC4(RPN, FasterRCNNC4):
    """The RPN alone on the C4 trunk: RPN's loss and predict, FasterRCNNC4's
    backbone and 1024-channel head; no RoI head (zoo.py:204-212)."""

    def _init_extra(self, generator: torch.Generator) -> None:
        """No RoI head: nothing beyond the trunk and the RPN head."""
