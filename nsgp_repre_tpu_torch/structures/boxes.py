"""Box operations on tensors of corner boxes (..., 4) = (x1, y1, x2, y2).

Counterpart of nsgp_repre_tpu/structures/boxes.py, in the same operation
order so float results agree (mmdet bbox_overlaps and the DeltaXYWH
coder, including the ``wh_ratio_clip`` clamp).
"""
from __future__ import annotations

import math

import torch


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor, mode: str = "iou",
                  eps: float = 1e-6) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) → (..., M, N) IoU or IoF (over boxes1)."""
    if mode not in ("iou", "iof"):
        raise ValueError(mode)
    a1 = bbox_area(boxes1)
    a2 = bbox_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    if mode == "iou":
        union = a1[..., :, None] + a2[..., None, :] - inter
    else:
        union = a1[..., :, None].expand_as(inter)
    return inter / torch.clamp(union, min=eps)


def bbox_clip(boxes: torch.Tensor, img_shape) -> torch.Tensor:
    """Clip to ``img_shape = (h, w)``; h and w may be tensors broadcastable
    to ``boxes[..., 0]`` (one shape per image)."""
    h, w = img_shape[0], img_shape[1]
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2delta(proposals: torch.Tensor, gts: torch.Tensor, means=(0.0, 0.0, 0.0, 0.0),
               stds=(1.0, 1.0, 1.0, 1.0), eps: float = 1e-6) -> torch.Tensor:
    """Encode gts as (dx, dy, dw, dh) deltas w.r.t. proposals."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gts[..., 0] + gts[..., 2]) * 0.5
    gy = (gts[..., 1] + gts[..., 3]) * 0.5
    gw = gts[..., 2] - gts[..., 0]
    gh = gts[..., 3] - gts[..., 1]
    pw = torch.clamp(pw, min=eps)
    ph = torch.clamp(ph, min=eps)
    dx = (gx - px) / pw
    dy = (gy - py) / ph
    dw = torch.log(torch.clamp(gw, min=eps) / pw)
    dh = torch.log(torch.clamp(gh, min=eps) / ph)
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return (deltas - means) / stds


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor, means=(0.0, 0.0, 0.0, 0.0),
               stds=(1.0, 1.0, 1.0, 1.0), max_shape=None,
               wh_ratio_clip: float = 16.0 / 1000.0) -> torch.Tensor:
    """Decode deltas (..., K*4) w.r.t. rois (..., 4) → boxes (..., K*4).

    ``max_shape = (h, w)`` clips the boxes; h and w may be per-image
    tensors broadcastable to (..., K).
    """
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    k = deltas.shape[-1] // 4
    d = deltas.reshape(deltas.shape[:-1] + (k, 4))
    d = d * stds + means
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy = d[..., 0], d[..., 1]
    dw = torch.clamp(d[..., 2], -max_ratio, max_ratio)
    dh = torch.clamp(d[..., 3], -max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    if max_shape is not None:
        boxes = bbox_clip(boxes, max_shape)
    return boxes.reshape(deltas.shape)
