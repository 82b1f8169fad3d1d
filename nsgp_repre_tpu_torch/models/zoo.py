"""Model zoo: build a detector from a reference-shaped model config dict.

Counterpart of nsgp_repre_tpu/models/zoo.py::build_detector for every
model base under cl_faster_rcnn_cfgs/_base_/models/:

| config ``model.type``            | class                                 |
|----------------------------------|---------------------------------------|
| FasterRCNN / FasterRCNNRoIReplay | models.detector.FasterRCNN            |
| RetinaNet                        | models.single_stage.RetinaNet         |
| SSD                              | models.ssd.SSD                        |
| RPN                              | models.two_stage_variants.RPN         |
| FastRCNN                         | models.two_stage_variants.FastRCNN    |
| MaskRCNN                         | models.mask.MaskRCNN                  |
| FasterRCNNC4 / FasterRCNNDC5     | models.c4.FasterRCNNC4 / FasterRCNNDC5 |
| MaskRCNNC4                       | models.c4.MaskRCNNC4                  |
| RPNC4                            | models.c4.RPNC4                       |
| CascadeRCNN                      | models.cascade.CascadeRCNN            |
| CascadeMaskRCNN                  | models.cascade.CascadeMaskRCNN        |

Another type raises ValueError. The config mapping is JAX's
(zoo.py:77-254): RetinaNet's and SSD's overrides keep only their config's
fields (``backbone_blocks`` means nothing to the VGG of SSD), the mask
config's RoIAlign ``sampling_ratio=0`` is not read (``roi_sampling_ratio``
stays 2).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import dataclasses

import torch

from ..utils.device import resolve_device
from .c4 import RPNC4, FasterRCNNC4, FasterRCNNDC5, MaskRCNNC4
from .cascade import CascadeConfig, CascadeMaskConfig, CascadeMaskRCNN, CascadeRCNN
from .detector import DetectorConfig, FasterRCNN
from .mask import MaskRCNN, MaskRCNNConfig
from .single_stage import RetinaNet, RetinaNetConfig
from .ssd import SSD, SSDConfig
from .two_stage_variants import RPN, FastRCNN

C4_TYPES = {"FasterRCNNC4": FasterRCNNC4, "MaskRCNNC4": MaskRCNNC4, "RPNC4": RPNC4,
            "FasterRCNNDC5": FasterRCNNDC5}


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


def _only_fields(cls, kw: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kw.items() if k in names}


def _retinanet_config(model, num_classes, compute_dtype, overrides) -> RetinaNetConfig:
    head = model.get("bbox_head", {}) or {}
    test_cfg = model.get("test_cfg", {}) or {}
    assigner = (model.get("train_cfg", {}) or {}).get("assigner", {})
    anchor = head.get("anchor_generator", {}) or {}
    bb = model.get("backbone", {}) or {}
    kw = dict(
        num_classes=num_classes or head.get("num_classes", 80),
        anchor_strides=tuple(anchor.get("strides", (8, 16, 32, 64, 128))),
        anchor_ratios=tuple(anchor.get("ratios", (0.5, 1.0, 2.0))),
        octave_base_scale=anchor.get("octave_base_scale", 4),
        scales_per_octave=anchor.get("scales_per_octave", 3),
        stacked_convs=head.get("stacked_convs", 4),
        feat_channels=head.get("feat_channels", 256),
        pos_iou_thr=assigner.get("pos_iou_thr", 0.5),
        neg_iou_thr=assigner.get("neg_iou_thr", 0.4),
        min_pos_iou=assigner.get("min_pos_iou", 0.0),
        focal_gamma=head.get("loss_cls", {}).get("gamma", 2.0),
        focal_alpha=head.get("loss_cls", {}).get("alpha", 0.25),
        nms_pre=test_cfg.get("nms_pre", 1000),
        score_thr=test_cfg.get("score_thr", 0.05),
        nms_iou=test_cfg.get("nms", {}).get("iou_threshold", 0.5),
        max_per_img=test_cfg.get("max_per_img", 100),
        backbone_blocks=tuple(bb.get("stage_blocks", (3, 4, 6, 3))),
        frozen_stages=bb.get("frozen_stages", 1),
        compute_dtype=compute_dtype,
    )
    kw.update(_only_fields(RetinaNetConfig, overrides))
    return RetinaNetConfig(**kw)


def _ssd_config(model, num_classes, compute_dtype, overrides) -> SSDConfig:
    head = model.get("bbox_head", {}) or {}
    train_cfg = model.get("train_cfg", {}) or {}
    test_cfg = model.get("test_cfg", {}) or {}
    anchor = head.get("anchor_generator", {}) or {}
    kw = dict(
        num_classes=num_classes or head.get("num_classes", 80),
        input_size=anchor.get("input_size", 300),
        strides=tuple(anchor.get("strides", (8, 16, 32, 64, 100, 300))),
        level_ratios=tuple(tuple(float(x) for x in r) for r in
                           anchor.get("ratios", [[2], [2, 3], [2, 3], [2, 3], [2], [2]])),
        basesize_ratio_range=tuple(anchor.get("basesize_ratio_range", (0.15, 0.9))),
        neg_pos_ratio=train_cfg.get("neg_pos_ratio", 3),
        smoothl1_beta=train_cfg.get("smoothl1_beta", 1.0),
        nms_pre=test_cfg.get("nms_pre", 1000),
        score_thr=test_cfg.get("score_thr", 0.02),
        nms_iou=test_cfg.get("nms", {}).get("iou_threshold", 0.45),
        max_per_img=test_cfg.get("max_per_img", 200),
        compute_dtype=compute_dtype,
    )
    kw.update(_only_fields(SSDConfig, overrides))
    return SSDConfig(**kw)


def _head_num_classes(model: Dict[str, Any]) -> int:
    rh = model.get("roi_head", {}) or {}
    bh = rh.get("bbox_head", {})
    if isinstance(bh, (list, tuple)):
        bh = bh[0] if bh else {}
    return (bh or {}).get("num_classes", 80)


def build_config(model: Dict[str, Any], num_classes: Optional[int] = None,
                 compute_dtype: str = "float32", **overrides) -> Tuple[type, Any]:
    """(model-config dict) → (detector class, its config dataclass), with
    JAX's mapping (zoo.py:77-254). ``num_classes`` overrides the head's
    (the bases keep COCO's 80)."""
    typ = model.get("type", "FasterRCNN")
    if typ == "RetinaNet":
        return RetinaNet, _retinanet_config(model, num_classes, compute_dtype, overrides)
    if typ == "SSD":
        return SSD, _ssd_config(model, num_classes, compute_dtype, overrides)
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
    if typ in C4_TYPES:
        # single-level caffe trunks: anchor scales 2-32 on stride 16
        anchor = (model.get("rpn_head", {}) or {}).get("anchor_generator", {}) or {}
        kw["anchor_strides"] = tuple(anchor.get("strides", (16,)))
        kw["anchor_scales"] = tuple(float(s) for s in anchor.get("scales", (2, 4, 8, 16, 32)))
        kw["roi_strides"] = kw["anchor_strides"]
        if typ == "MaskRCNNC4":
            # shared res5 mask branch, FCNMaskHead(num_convs=0), mask_size=14
            mh = (model.get("roi_head", {}) or {}).get("mask_head", {}) or {}
            return MaskRCNNC4, MaskRCNNConfig(
                **kw, mask_size=14, mask_roi_out_size=14, mask_convs=mh.get("num_convs", 0),
                mask_channels=mh.get("conv_out_channels", 256))
        return C4_TYPES[typ], DetectorConfig(**kw)
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
    device it raises). Overrides are config fields (RetinaNet and SSD
    drop those their config lacks, as JAX's does)."""
    dev = resolve_device(device)
    cls, cfg = build_config(model, num_classes, compute_dtype, **overrides)
    det = cls(cfg).init_weights(torch.Generator().manual_seed(seed))
    return det.to(dev).eval(), cfg

