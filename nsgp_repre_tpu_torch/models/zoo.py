"""Model zoo: build a two-stage detector from a reference-shaped model
config dict.

Counterpart of nsgp_repre_tpu/models/zoo.py::build_detector for the
FPN two-stage families of cl_faster_rcnn_cfgs/_base_/models/:

| config ``model.type``            | class                                 |
|----------------------------------|---------------------------------------|
| FasterRCNN / FasterRCNNRoIReplay | models.detector.FasterRCNN            |
| RPN                              | models.two_stage_variants.RPN         |
| FastRCNN                         | models.two_stage_variants.FastRCNN    |
| MaskRCNN                         | models.mask.MaskRCNN                  |
| CascadeRCNN                      | models.cascade.CascadeRCNN            |
| CascadeMaskRCNN                  | models.cascade.CascadeMaskRCNN        |

RetinaNet, SSD and the caffe C4/DC5 trunks are not ported yet and
raise NotImplementedError (ROADMAP.md, queue 1 item 4). The config
mapping is JAX's: the mask config's RoIAlign ``sampling_ratio=0`` is not
read (``roi_sampling_ratio`` stays 2).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..utils.device import resolve_device
from .cascade import CascadeConfig, CascadeMaskConfig, CascadeMaskRCNN, CascadeRCNN
from .detector import DetectorConfig, FasterRCNN
from .mask import MaskRCNN, MaskRCNNConfig
from .two_stage_variants import RPN, FastRCNN

NOT_PORTED_TYPES = ("RetinaNet", "SSD", "FasterRCNNC4", "MaskRCNNC4", "RPNC4", "FasterRCNNDC5")


def _two_stage_kwargs(model: Dict[str, Any], num_classes: int) -> Dict[str, Any]:
    train_cfg = model.get("train_cfg", {}) or {}
    test_cfg = model.get("test_cfg", {}) or {}
    rpn_t = train_cfg.get("rpn", {}) or {}
    prop_t = train_cfg.get("rpn_proposal", {}) or {}
    rcnn_t = train_cfg.get("rcnn", {}) or {}
    if isinstance(rcnn_t, (list, tuple)):  # cascade: per-stage list
        rcnn_t = rcnn_t[0]
    rcnn_te = test_cfg.get("rcnn", {}) or {}
    bb = model.get("backbone", {}) or {}
    return dict(
        num_classes=num_classes,
        task_split=(0, num_classes),
        task_id=1,
        rpn_pos_iou_thr=rpn_t.get("assigner", {}).get("pos_iou_thr", 0.7),
        rpn_neg_iou_thr=rpn_t.get("assigner", {}).get("neg_iou_thr", 0.3),
        rpn_min_pos_iou=rpn_t.get("assigner", {}).get("min_pos_iou", 0.3),
        rpn_num=rpn_t.get("sampler", {}).get("num", 256),
        rpn_pos_fraction=rpn_t.get("sampler", {}).get("pos_fraction", 0.5),
        rpn_nms_pre=prop_t.get("nms_pre", 2000),
        rpn_max_per_img=prop_t.get("max_per_img", 1000),
        rpn_nms_iou=prop_t.get("nms", {}).get("iou_threshold", 0.7),
        rcnn_pos_iou_thr=rcnn_t.get("assigner", {}).get("pos_iou_thr", 0.5),
        rcnn_neg_iou_thr=rcnn_t.get("assigner", {}).get("neg_iou_thr", 0.5),
        rcnn_min_pos_iou=rcnn_t.get("assigner", {}).get("min_pos_iou", 0.5),
        rcnn_num=rcnn_t.get("sampler", {}).get("num", 512),
        rcnn_pos_fraction=rcnn_t.get("sampler", {}).get("pos_fraction", 0.25),
        score_thr=rcnn_te.get("score_thr", 0.05),
        nms_iou=rcnn_te.get("nms", {}).get("iou_threshold", 0.5),
        nms_type=rcnn_te.get("nms", {}).get("type", "nms"),
        soft_nms_sigma=rcnn_te.get("nms", {}).get("sigma", 0.5),
        soft_nms_min_score=rcnn_te.get("nms", {}).get("min_score", 1e-3),
        soft_nms_method=rcnn_te.get("nms", {}).get("method", "linear"),
        max_per_img=rcnn_te.get("max_per_img", 100),
        backbone_blocks=tuple(bb.get("stage_blocks", (3, 4, 6, 3))),
        frozen_stages=bb.get("frozen_stages", 1),
    )


def _cascade_kwargs(model: Dict[str, Any]) -> Dict[str, Any]:
    """Stage IoUs, stds, count and loss weights from a cascade config."""
    rh = model.get("roi_head", {}) or {}
    rcnn_list = (model.get("train_cfg", {}) or {}).get("rcnn", []) or []
    heads = rh.get("bbox_head", []) or []
    extra = {}
    if rcnn_list and isinstance(rcnn_list, (list, tuple)):
        extra["stage_pos_iou"] = tuple(
            s.get("assigner", {}).get("pos_iou_thr", t)
            for s, t in zip(rcnn_list, (0.5, 0.6, 0.7)))
    if heads:
        extra["stage_stds"] = tuple(
            tuple(h.get("bbox_coder", {}).get("target_stds", (0.1, 0.1, 0.2, 0.2)))
            for h in heads)
        extra["num_stages"] = len(heads)
    if rh.get("stage_loss_weights"):
        extra["stage_loss_weights"] = tuple(rh["stage_loss_weights"])
    return extra


def _head_num_classes(model: Dict[str, Any]) -> int:
    rh = model.get("roi_head", {}) or {}
    bh = rh.get("bbox_head", {})
    if isinstance(bh, (list, tuple)):
        bh = bh[0] if bh else {}
    return (bh or {}).get("num_classes", 80)


def build_config(model: Dict[str, Any], num_classes: Optional[int] = None,
                 compute_dtype: str = "float32", **overrides) -> Tuple[type, DetectorConfig]:
    """(model-config dict) → (detector class, its config dataclass), with
    JAX's mapping (zoo.py:77-254). ``num_classes`` overrides the head's
    (the bases keep COCO's 80)."""
    typ = model.get("type", "FasterRCNN")
    if typ in NOT_PORTED_TYPES:
        raise NotImplementedError(
            f"model type {typ!r} is not ported yet (ROADMAP.md, queue 1 item 4)")
    nc = num_classes if num_classes is not None else _head_num_classes(model)
    kw = _two_stage_kwargs(model, nc)
    kw["compute_dtype"] = compute_dtype
    kw.update(overrides)
    if typ in ("FasterRCNN", "FasterRCNNRoIReplay"):
        return FasterRCNN, DetectorConfig(**kw)
    if typ == "RPN":
        # rpn-only: the proposal settings live under test_cfg.rpn
        te = (model.get("test_cfg", {}) or {}).get("rpn", {}) or {}
        kw["rpn_nms_pre"] = te.get("nms_pre", kw["rpn_nms_pre"])
        kw["rpn_max_per_img"] = te.get("max_per_img", kw["rpn_max_per_img"])
        kw["rpn_nms_iou"] = te.get("nms", {}).get("iou_threshold", kw["rpn_nms_iou"])
        return RPN, DetectorConfig(**kw)
    if typ == "FastRCNN":
        return FastRCNN, DetectorConfig(**kw)
    if typ == "MaskRCNN":
        mh = (model.get("roi_head", {}) or {}).get("mask_head", {}) or {}
        return MaskRCNN, MaskRCNNConfig(
            **kw, mask_convs=mh.get("num_convs", 4),
            mask_channels=mh.get("conv_out_channels", 256))
    if typ == "CascadeMaskRCNN":
        return CascadeMaskRCNN, CascadeMaskConfig(**kw, **_cascade_kwargs(model))
    if typ == "CascadeRCNN":
        return CascadeRCNN, CascadeConfig(**kw, **_cascade_kwargs(model))
    raise ValueError(f"unsupported model type: {typ}")


def build_detector(model: Dict[str, Any], num_classes: Optional[int] = None,
                   compute_dtype: str = "float32",
                   device: Optional[Union[str, torch.device]] = None, seed: int = 0,
                   **overrides):
    """(model-config dict) → (detector, its config): the detector with a
    seeded random init (``init_weights``), in eval mode, on ``device``
    (``cuda`` unless the caller names one; with none named and no CUDA
    device it raises). Overrides are config fields."""
    dev = resolve_device(device)
    cls, cfg = build_config(model, num_classes, compute_dtype, **overrides)
    det = cls(cfg).init_weights(torch.Generator().manual_seed(seed))
    return det.to(dev).eval(), cfg

