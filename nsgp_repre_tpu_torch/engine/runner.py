"""Config → DetectorConfig, optimizer, schedule and teacher.

Counterpart of nsgp_repre_tpu/engine/runner.py: ``detector_config_from_cfg``
(copied as-is), ``translate_ignore_keys`` (copied as-is),
``build_optimizer`` (runner.py:72-99), and two pieces of
``NullSpaceRunner.__init__`` as helpers, so that a config builds the
same objects on both sides: :func:`build_train_optimizer` (the schedule
and trainable-mask wiring, runner.py:279-336) and :func:`build_teacher`
(the frozen teacher, runner.py:222-243, 338-341). The runners wait for
slice (d) (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..models.detector import DetectorConfig, FasterRCNN
from ..models.layers import FrozenBatchNorm
from ..utils.config import Config
from . import optim
from .train import make_lr_schedule, trainable_mask

# reference ignore_keys name their torch modules; translate prefixes to the
# JAX parameter paths that key the covariances (nsrunner:354 default +
# forced entries)
_IGNORE_NAME_MAP = {
    "rpn": "rpn_head",
    "roi_head.bbox_head.fc_cls": "bbox_head/fc_cls",
    "roi_head.bbox_head.fc_reg": "bbox_head/fc_reg",
    "roi_head": "bbox_head",
    "teacher": "teacher",
}
_FORCED_IGNORE = ["roi_head.bbox_head.fc_cls", "roi_head.bbox_head.fc_reg", "teacher"]


def translate_ignore_keys(keys: List[str]) -> List[str]:
    """A config's ``ignore_keys`` → the patterns engine/nsgp.py::build_transforms skips."""
    return [_IGNORE_NAME_MAP.get(k, k) for k in list(keys) + _FORCED_IGNORE]


def build_optimizer(opt_cfg: dict, lr_schedule, named_params, model: FasterRCNN,
                    paramwise_cfg: Optional[dict] = None):
    """Map a reference ``optim_wrapper.optimizer`` dict onto the projected
    optimizers over ``named_params`` (SGD/Adam/AdamW ± NSCL share
    implementations: the plain types are the NSCL ones with no transform
    installed). ``model`` names the parameters for ``paramwise_cfg``."""
    mults = optim.paramwise_mults(model, paramwise_cfg) if paramwise_cfg else None
    opt_type = opt_cfg.get("type", "SGDNSCL")
    if opt_type in ("SGDNSCL", "SGDNSCLNA", "SGD"):
        return optim.sgd_nscl(
            named_params, lr_schedule,
            momentum=opt_cfg.get("momentum", 0.9),
            weight_decay=opt_cfg.get("weight_decay", 1e-4),
            mults=mults,
        )
    if opt_type in ("AdamNSCL", "Adam"):
        return optim.adam_nscl(
            named_params, lr_schedule, weight_decay=opt_cfg.get("weight_decay", 0.0),
            mults=mults,
        )
    if opt_type in ("AdamWNSCL", "AdamW"):
        return optim.adam_nscl(
            named_params, lr_schedule,
            weight_decay=opt_cfg.get("weight_decay", 0.1),
            decoupled_wd=True,
            mults=mults,
        )
    raise ValueError(opt_type)


def build_train_optimizer(cfg: Config, model: FasterRCNN, steps_per_epoch: int):
    """The optimizer ``NullSpaceRunner`` builds for a config: the LinearLR
    warm-up + MultiStepLR schedule of ``param_scheduler`` (with
    ``auto_scale_lr``), ``optim_wrapper``'s optimizer and paramwise
    multipliers, over the trainable parameters only. Frozen parameters
    (``trainable_mask``) get ``requires_grad_(False)`` and no entry: the
    port's form of JAX's ``optim.masked``."""
    opt_cfg = cfg.get("optim_wrapper", {}).get("optimizer", {})
    max_epochs = cfg.get("train_cfg", {}).get("max_epochs", 30)
    milestones, gamma, warmup = (8, 11), 0.1, 500
    for s in cfg.get("param_scheduler", None) or []:
        if s.get("type") == "MultiStepLR":
            milestones = tuple(s.get("milestones", milestones))
            gamma = s.get("gamma", gamma)
        if s.get("type") == "LinearLR":
            warmup = s.get("end", warmup)
    base_lr = opt_cfg.get("lr", 0.02)
    tl_cfg = cfg.get("train_dataloader", {})
    asl = cfg.get("auto_scale_lr", {})
    if asl.get("enable", False):
        base_lr = base_lr * tl_cfg.get("batch_size", 16) / asl.get("base_batch_size", 16)
    schedule = make_lr_schedule(base_lr, max(steps_per_epoch, 1), max_epochs=max_epochs,
                                milestones=milestones, gamma=gamma, warmup_iters=warmup)
    mask = trainable_mask(model, model.config)
    named = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            named.append((name, p))
    paramwise_cfg = cfg.get("optim_wrapper", {}).get("paramwise_cfg") or {}
    return build_optimizer(opt_cfg, schedule, named, model, paramwise_cfg)


def build_teacher(model: FasterRCNN) -> FasterRCNN:
    """The frozen previous-task teacher of a task >= 2 student: a second
    FasterRCNN with ``task_id - 1`` and a copy of the student's current
    parameters (the reference deep-copies after loading the checkpoint,
    nsrunner:529-549), in eval mode with no gradient. Its RoIAlign takes a
    1x1 sample grid when ``teacher_fast`` holds and ``roi_align_mode`` is
    not 'window', as JAX has the rule (runner.py:233-238); else the
    student's grid. Its FrozenBatchNorm statistics ARE the student's
    buffers (shared tensors), as JAX runs the teacher with the student's
    ``batch_stats`` (train.py:181-185)."""
    cfg = model.config
    ratio = (1 if cfg.teacher_fast and cfg.roi_align_mode != "window"
             else cfg.roi_sampling_ratio)
    teacher = FasterRCNN(dataclasses.replace(cfg, task_id=cfg.task_id - 1,
                                             roi_sampling_ratio=ratio))
    dev = next(model.parameters()).device
    teacher.to(dev)
    with torch.no_grad():
        for (name, p), (tname, tp) in zip(model.named_parameters(), teacher.named_parameters()):
            if name != tname:
                raise ValueError(f"student {name} and teacher {tname} differ")
            tp.copy_(p)
    for s_bn, t_bn in zip((m for m in model.modules() if isinstance(m, FrozenBatchNorm)),
                          (m for m in teacher.modules() if isinstance(m, FrozenBatchNorm))):
        t_bn.running_mean = s_bn.running_mean
        t_bn.running_var = s_bn.running_var
    teacher.requires_grad_(False)
    return teacher.eval()


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
