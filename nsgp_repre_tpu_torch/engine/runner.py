"""Config → DetectorConfig mapping.

Counterpart of nsgp_repre_tpu/engine/runner.py, holding only
``detector_config_from_cfg`` (copied as-is). The runners wait for slice
(d) (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from ..models.detector import DetectorConfig
from ..utils.config import Config


def detector_config_from_cfg(cfg: Config) -> DetectorConfig:
    """Map a reference-shaped model config dict onto DetectorConfig."""
    model = cfg.get("model", {})
    bbox_head = model.get("roi_head", {}).get("bbox_head", {})
    num_classes = bbox_head.get("num_classes", 20)
    task_split = tuple(cfg.get("train_task_split", (0, num_classes)))
    task_id = cfg.get("task_id", 1)
    rr = cfg.get("rr_thresh", [0.5, 0.5])
    train_cfg = model.get("train_cfg", {})
    rpn_t = train_cfg.get("rpn", {})
    prop_t = train_cfg.get("rpn_proposal", {})
    rcnn_t = train_cfg.get("rcnn", {})
    test_cfg = model.get("test_cfg", {})
    rcnn_te = test_cfg.get("rcnn", {})
    return DetectorConfig(
        num_classes=num_classes,
        task_split=task_split,
        task_id=task_id,
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
        max_per_img=rcnn_te.get("max_per_img", 100),
        rpn_thresh=rr[0],
        roi_thresh=rr[1],
        compute_dtype=cfg.get("compute_dtype", "float32"),
        backbone_blocks=tuple(
            model.get("backbone", {}).get("stage_blocks", (3, 4, 6, 3))
        ),
        frozen_stages=model.get("backbone", {}).get("frozen_stages", 1),
        replay_mode=(
            "raw"
            if model.get("roi_head", {}).get("type") == "StandardRoIReplayHead"
            else "prototype"
        ),
        # parity mode: exact top-k for pre-NMS selection (slower; flip on
        # when validating mAP against the reference)
        use_approx_topk=cfg.get("use_approx_topk", True),
        teacher_fast=cfg.get("teacher_fast", cfg.get("use_approx_topk", True)),
        roi_align_mode=cfg.get(
            "roi_align_mode",
            "window" if cfg.get("use_approx_topk", True) else "gather",
        ),
        rpn_nms_impl=cfg.get("rpn_nms_impl", "auto"),
        rpn_sparse_loss=cfg.get(
            "rpn_sparse_loss", cfg.get("use_approx_topk", True)
        ),
        stem_s2d=cfg.get("stem_s2d", False),
    )
