"""Mask R-CNN: an FCN mask head on the two-stage detector.

Counterpart of nsgp_repre_tpu/models/mask.py (mmdet mask_rcnn.py,
_base_/models/mask-rcnn_r50_fpn.py):
- ``FCNMaskHead`` (fcn_mask_head.py): four 3x3 conv + ReLU, a 2x2
  stride-2 transposed conv + ReLU, a 1x1 conv to per-class 28x28 logits.
  Module names follow mmdet (``convs.{i}.conv``, ``upsample``,
  ``conv_logits``). As in JAX (flax ``ConvTranspose`` promotes its bf16
  input to its f32 kernel), the upsample and the logits run in f32.
- Mask targets (mask.py:73-111): gt masks are box-normalized crops
  (structures/mask_paste.py::normalize_gt_masks); a sampled RoI's target
  is the bilinear resample of its IoU-argmax gt's crop over the RoI,
  thresholded at 0.5 (:func:`resample_normalized`, batched over RoIs).
- The mask branch runs RoIAlign at ``mask_roi_out_size`` (14) on every
  sampled RoI of the bbox branch, with the loss (BCE on the label's
  slice, mask.py:150-234) weighted by the positives, and on the
  detections at predict (probabilities in ``InstanceArray.masks``;
  pasting is host-side, structures/mask_paste.py::paste_masks).

``MaskBranch`` holds the mask head's methods; ``MaskRCNN`` puts it on
FasterRCNN and models/cascade.py's ``CascadeMaskRCNN`` on the cascade.
The sampling priorities are FasterRCNN.loss's (``rpn``, ``roi``,
``roi2``): MaskRCNN.loss splits its key as FasterRCNN.loss does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.roi_align_cuda import multilevel_roi_align
from ..structures.boxes import bbox_overlaps
from ..structures.sample import DetBatch, InstanceArray
from ..utils.spans import span
from .detector import DetectorConfig, FasterRCNN
from .fpn import ConvModule
from .layers import CovConv, nchw, nhwc
from .losses import global_avg_factor


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig(DetectorConfig):
    mask_size: int = 28
    mask_roi_out_size: int = 14
    mask_convs: int = 4
    mask_channels: int = 256
    # the box-normalized gt-mask crops' side (host-side)
    gt_mask_size: int = 56


class _ConvTranspose2dF32(nn.ConvTranspose2d):
    """A transposed conv that computes in f32 whatever its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.float(), self.weight, self.bias, stride=self.stride)


class FCNMaskHead(nn.Module):
    """convs → 2x transposed conv → 1x1 per-class logits."""

    def __init__(self, num_classes: int, num_convs: int = 4, in_channels: int = 256,
                 channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else channels, channels, 3, padding=1)
            for i in range(num_convs)])
        up_in = channels if num_convs else in_channels
        self.upsample = _ConvTranspose2dF32(up_in, channels, 2, stride=2)
        self.conv_logits = CovConv(channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C) NHWC in the compute dtype → (R, 28, 28,
        num_classes) f32 logits."""
        x = nchw(x)
        for m in self.convs:
            x = torch.relu(m(x))
        return nhwc(self.conv_logits(torch.relu(self.upsample(x))))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """He normal (fan_out) kernels and zero biases, as the JAX head's
        ``variance_scaling(2.0, "fan_out", "normal")``."""
        for m in [c.conv for c in self.convs] + [self.conv_logits]:
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_out))
            m.bias.zero_()
        w = self.upsample.weight  # (in, out, kh, kw)
        fan_out = w.shape[1] * w[0, 0].numel()
        w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_out))
        self.upsample.bias.zero_()


def resample_normalized(crop: torch.Tensor, roi: torch.Tensor, gt_box: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """Bilinear resample of box-normalized gt-mask crops over RoI windows
    (mask.py:73-111, batched over RoIs): ``crop`` (N, S, S) covers
    ``gt_box`` (N, 4); returns the (N, out, out) targets over ``roi`` (N, 4)
    in image coordinates, zero outside the gt box. The JAX operation order,
    so the same f32 values come out."""
    S = crop.shape[-1]
    N = crop.shape[0]
    gx1, gy1, gx2, gy2 = (gt_box[:, k:k + 1] for k in range(4))
    gw = torch.clamp(gx2 - gx1, min=1e-4)
    gh = torch.clamp(gy2 - gy1, min=1e-4)
    rx1, ry1, rx2, ry2 = (roi[:, k:k + 1] for k in range(4))
    centers = torch.arange(out_size, dtype=torch.float32, device=crop.device) + 0.5
    # a tensor divisor: PyTorch's CUDA kernels divide by a Python scalar as a
    # multiply by its reciprocal, which rounds apart from the true division
    # of the CPU (and of JAX) and decides exact-0.5 targets otherwise
    frac = centers / torch.full_like(centers, out_size)
    ys = ry1 + frac * (ry2 - ry1)
    xs = rx1 + frac * (rx2 - rx1)
    cy = (ys - gy1) / gh * S - 0.5
    cx = (xs - gx1) / gw * S - 0.5
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    ly = cy - y0
    lx = cx - x0
    n = torch.arange(N, device=crop.device)[:, None, None]

    def take(iy, ix):
        iyc = torch.clamp(iy.long(), 0, S - 1)
        ixc = torch.clamp(ix.long(), 0, S - 1)
        v = crop[n, iyc[:, :, None], ixc[:, None, :]]
        inside = ((iy >= 0) & (iy <= S - 1))[:, :, None] & ((ix >= 0) & (ix <= S - 1))[:, None, :]
        return torch.where(inside, v, torch.zeros_like(v))

    v00 = take(y0, x0)
    v01 = take(y0, x0 + 1)
    v10 = take(y0 + 1, x0)
    v11 = take(y0 + 1, x0 + 1)
    w00 = (1 - ly)[:, :, None] * (1 - lx)[:, None, :]
    w01 = (1 - ly)[:, :, None] * lx[:, None, :]
    w10 = ly[:, :, None] * (1 - lx)[:, None, :]
    w11 = ly[:, :, None] * lx[:, None, :]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11


def mask_targets(rois: torch.Tensor, batch_idx: torch.Tensor, gt: InstanceArray,
                 mask_size: int) -> torch.Tensor:
    """Binary (N, mask_size, mask_size) targets of the sampled RoIs: the
    resampled crop of each RoI's IoU-argmax valid gt, thresholded at 0.5."""
    b = batch_idx.long()
    gt_boxes = gt.boxes[b]  # (N, G, 4)
    ious = bbox_overlaps(rois[:, None, :], gt_boxes)[:, 0]
    ious = torch.where(gt.valid[b], ious, torch.full_like(ious, -1.0))
    g = torch.argmax(ious, dim=1)
    crop = gt.masks[b, g].float()
    t = resample_normalized(crop, rois, gt_boxes[torch.arange(len(g), device=g.device), g],
                            mask_size)
    return (t > 0.5).float()


class MaskBranch:
    """The mask head's part of a detector (``roi_head.mask_head``); mixed
    in before the detector class it extends. ``mask_in_channels``: the
    channels of the features the mask head takes (the C4 head's res5
    output: 2048)."""

    mask_in_channels = 256

    def _add_mask_head(self) -> None:
        cfg = self.config
        self.roi_head.mask_head = FCNMaskHead(cfg.num_classes, cfg.mask_convs,
                                              in_channels=self.mask_in_channels,
                                              channels=cfg.mask_channels)

    @property
    def mask_head(self) -> FCNMaskHead:
        return self.roi_head.mask_head

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        self.mask_head.init_weights(generator)
        return self

    def _mask_roi_feats(self, feats, rois, batch_idx) -> torch.Tensor:
        """RoIAlign at ``mask_roi_out_size`` in the compute dtype."""
        cfg = self.config
        fs = [f.to(self.dtype).contiguous() for f in feats[: len(cfg.roi_strides)]]
        return multilevel_roi_align(
            fs, rois, batch_idx, strides=cfg.roi_strides, output_size=cfg.mask_roi_out_size,
            sampling_ratio=cfg.roi_sampling_ratio, finest_scale=cfg.roi_finest_scale,
        ).to(self.dtype)

    def _mask_logits(self, feats, rois, batch_idx) -> torch.Tensor:
        """The mask head's f32 (N, M, M, num_classes) logits on the RoIs."""
        return self.mask_head(self._mask_roi_feats(feats, rois, batch_idx)).float()

    def _mask_loss(self, feats, rois, batch_idx, labels, pos, gt: InstanceArray) -> torch.Tensor:
        return self._mask_bce(self._mask_logits(feats, rois, batch_idx), rois, batch_idx, labels,
                              pos, gt)

    def _mask_bce(self, logits, rois, batch_idx, labels, pos, gt: InstanceArray) -> torch.Tensor:
        """BCE of the sampled RoIs' label-slice logits against their targets
        (CrossEntropyLoss use_mask=True), the mean over each RoI's MxM
        weighted by the positives."""
        cfg = self.config
        targets = mask_targets(rois, batch_idx, gt, cfg.mask_size)
        M = cfg.mask_size
        lbl = torch.clamp(labels, 0, cfg.num_classes - 1).long()
        ml = torch.gather(logits, 3, lbl[:, None, None, None].expand(-1, M, M, 1))[..., 0]
        bce = torch.maximum(ml, torch.zeros_like(ml)) - ml * targets + torch.log1p(
            torch.exp(-torch.abs(ml)))
        w = pos.float()
        return (bce.mean(dim=(1, 2)) * w).sum() / global_avg_factor(w.sum())

    def _predict_masks(self, feats, dets: InstanceArray, batch: DetBatch,
                       rescale: bool) -> InstanceArray:
        """The mask head on the detections, in input coordinates:
        per-detection (B, D, M, M) probabilities of its label."""
        cfg = self.config
        B, D = dets.boxes.shape[:2]
        dev = dets.boxes.device
        boxes = dets.boxes
        if rescale:
            scale = batch.scale_factor.to(device=dev, dtype=torch.float32)
            boxes = boxes * torch.cat([scale, scale], dim=-1)[:, None, :]
        bidx = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(D)
        logits = self._mask_logits(feats, boxes.reshape(-1, 4), bidx)
        M = cfg.mask_size
        lbl = torch.clamp(dets.labels.reshape(-1), 0, cfg.num_classes - 1).long()
        per_det = torch.gather(logits, 3, lbl[:, None, None, None].expand(-1, M, M, 1))[..., 0]
        return dets.replace(masks=torch.sigmoid(per_det).reshape(B, D, M, M))


class MaskRCNN(MaskBranch, FasterRCNN):
    """FasterRCNN + the mask branch."""

    def __init__(self, config: MaskRCNNConfig):
        super().__init__(config)
        self._add_mask_head()

    def _extra_roi_losses(self, feats, rois, batch_idx, labels, pos,
                          gt: InstanceArray) -> Dict[str, torch.Tensor]:
        """``loss_mask`` on FasterRCNN.roi_loss's sampled RoIs when the gts
        carry masks."""
        if gt.masks is None:
            return {}
        with span("mask"):
            return {"loss_mask": self._mask_loss(feats, rois, batch_idx, labels, pos, gt)}

    @torch.no_grad()
    def predict(self, batch: DetBatch, rescale: bool = True) -> InstanceArray:
        return self._predict_feats(self.extract_feat(batch.images), batch, rescale)

    def _predict_feats(self, feats, batch: DetBatch, rescale: bool) -> InstanceArray:
        """mask.py:237-261 on extracted features."""
        _, proposals = self.rpn_loss_and_proposals(feats, batch.gt, batch.img_shape,
                                                   with_loss=False)
        dets = self._predict_from_proposals(feats, proposals, batch, rescale)
        return self._predict_masks(feats, dets, batch, rescale)
