"""Training orchestrators, and the config → model, optimizer and teacher helpers.

Counterpart of nsgp_repre_tpu/engine/runner.py:
- :class:`NullSpaceRunner` ≙ BRNullSpaceRunner
  (mmdet/engine/runner/nsrunner_roi_replay.py:112): per task, load the
  previous task's best checkpoint, build the frozen teacher
  (task_id − 1), install the NSGP projections from ``covariance.npz``,
  load the EWC terms, build the RePRE prototypes from ``rois_etc.npz``,
  run the train loop (validation and the best checkpoint every epoch),
  then compute and save the next task's files (EWC importance, input
  covariances, RoI features);
- :class:`TeacherRunner` ≙ mmdet/engine/runner/teacherrunner.py:65:
  teacher pseudo-labels only, no NSGP, EWC or task-end files;
- the helpers ``detector_config_from_cfg`` and ``translate_ignore_keys``
  (copied as-is), ``build_optimizer`` (runner.py:72-99),
  :func:`build_train_optimizer` (the schedule and trainable-mask wiring,
  runner.py:279-336), :func:`build_teacher` (runner.py:222-243, 338-341),
  ``build_dataset``, ``_leaf_dataset`` and ``_dataset_repeat``.

The runners read and write the JAX package's files (utils/checkpoint.py),
so a work dir of either package is a ``previous_dir`` of the other. They
run on ``cuda`` unless a device is named (utils/device.py).
``jax.random`` keys become ``torch.Generator`` s on the device, seeded as
JAX seeds its keys: the train loop ``seed + 1``, the covariance pass
``+ 2``, the RoI store ``+ 3``, the importance pass ``+ 4``.
``timings`` holds each stage's wall seconds and counts. The train
loop's waits on its loader are also the span ``nsgp.runner.loader_wait``
(utils/spans.py), so a ``profile_dir`` trace (train iterations 10-15 of
epoch 0) shows them beside the step's ``nsgp.train_step``: a loop held
by its loader from one held by the step.

Data parallel (parallel/mesh.py; JAX's process-aware paths): with a
process group up, each rank loads its rows of every global batch
(``DetLoader(num_shards, shard_id)``), the parameters are broadcast from
rank 0 after the weights are loaded, the steps reduce what the global
batch needs (engine/train.py), and every rank gathers the teacher's and
validation's detections, so all ranks hold the same cache, mAP and best
checkpoint. Every rank computes the task-end files alike; rank 0 writes
each file, with a barrier after the write.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import os.path as osp
import pickle
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..datasets.coco import CocoTaskDataset
from ..datasets.dior import DIORTaskDataset
from ..datasets.loader import DetLoader
from ..datasets.prefetch import PrefetchLoader, to_device
from ..datasets.voc import VOCTaskDataset
from ..evaluation import eval_coco_map, eval_voc_map
from ..models.detector import DetectorConfig, FasterRCNN
from ..models.layers import FrozenBatchNorm
from ..parallel import mesh
from ..structures.sample import DetBatch, InstanceArray
from ..utils import checkpoint as ckpt_io
from ..utils.config import Config
from ..utils.convert import jax_flat_from_state_dict, state_dict_from_jax
from ..utils.device import resolve_device
from ..utils.spans import span
from . import ewc, nsgp, optim, replay
from .train import (TrainState, make_cov_step, make_eval_step, make_importance_step,
                    make_lr_schedule, make_roi_extract_step, make_teacher_step, make_train_step,
                    trainable_mask)

logger = logging.getLogger("nsgp_repre_tpu_torch")

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


def build_dataset(ds_cfg: Config, data_root_override: Optional[str] = None):
    typ = ds_cfg.get("type", "VOCTask")
    data_root = data_root_override or ds_cfg.get("data_root", "data/VOCdevkit")
    common = dict(
        task_split=list(ds_cfg.get("task_split", (0, 20))),
        task_id=ds_cfg.get("task_id", 1),
        test_mode=ds_cfg.get("test_mode", False),
    )
    if typ in ("VOCTask", "VOCTaskDataset"):
        return VOCTaskDataset(
            data_root=data_root,
            ann_file=ds_cfg.get("ann_file", "VOC2007/ImageSets/Main/trainval.txt"),
            sub_data_root=ds_cfg.get("data_prefix", {}).get("sub_data_root", "VOC2007/"),
            **common,
        )
    if typ in ("DIORTask", "DIORTaskDataset"):
        return DIORTaskDataset(
            data_root=data_root,
            ann_file=ds_cfg.get("ann_file"),
            sub_data_root=ds_cfg.get("data_prefix", {}).get("sub_data_root", ""),
            **common,
        )
    if typ in ("CocoTaskDataset", "CocoTask"):
        return CocoTaskDataset(
            data_root=data_root,
            ann_file=ds_cfg.get("ann_file"),
            img_prefix=ds_cfg.get("data_prefix", {}).get("img", ""),
            **common,
        )
    raise ValueError(f"unknown dataset type {typ}")


def _leaf_dataset(ds_cfg: Config) -> Config:
    """Unwrap RepeatDataset/ConcatDataset nesting in reference configs."""
    cur = ds_cfg
    while cur.get("type") in ("RepeatDataset", "ConcatDataset"):
        if cur.get("type") == "RepeatDataset":
            cur = cur.get("dataset", {})
        else:
            datasets = cur.get("datasets", [])
            cur = datasets[0] if datasets else {}
    return cur


def _dataset_repeat(ds_cfg: Config) -> int:
    if ds_cfg.get("type") == "RepeatDataset":
        return ds_cfg.get("times", 1)
    return 1


class NullSpaceRunner:
    """Per-task orchestration of the NSGP-RePRE pipeline on one device per
    process (several processes: parallel/mesh.py)."""

    def __init__(self, cfg: Config, use_nsgp: bool = True, device=None):
        t_init = time.perf_counter()
        self.world, self.rank = mesh.world_size(), mesh.rank()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timings: Dict[str, float] = {}
        self.use_nsgp = use_nsgp
        self.work_dir = cfg.get("work_dir", "./work_dirs/default")
        os.makedirs(self.work_dir, exist_ok=True)
        self.task_id = cfg.get("task_id", 1)
        self.task_split = list(cfg.get("train_task_split", (0, 20)))
        self.previous_dir = cfg.get("previous_dir") if self.task_id != 1 else None
        if self.previous_dir is not None and not osp.exists(self.previous_dir):
            raise FileNotFoundError(
                f"task {self.task_id} needs the previous task's dir {self.previous_dir}")
        self.ckpt_keywords = cfg.get("ckpt_keywords", "best")
        self.offset = cfg.get("offset", 0.0) or 0.0
        self.ignore_keys = translate_ignore_keys(cfg.get("ignore_keys", ["rpn", "roi_head"]))
        self.max_prototype = cfg.get("max_prototype", 10)
        self.reserve_per_class = cfg.get("reserve_per_class", 0) or 0
        self.is_trained = bool(cfg.get("is_trained", False))
        self.seed = cfg.get("seed", 0)
        self.use_teacher = cfg.get("use_teacher", True) and self.task_id != 1 \
            and "joint" not in self.work_dir
        self.det_cfg = detector_config_from_cfg(cfg)
        self.n_tasks = len(self.det_cfg.task_split) - 1
        self.last_val_map: Optional[float] = None

        # ---- data ----
        tl_cfg = cfg.get("train_dataloader", {})
        vl_cfg = cfg.get("val_dataloader", {})
        self.train_dataset = build_dataset(_leaf_dataset(tl_cfg.get("dataset", {})))
        self.val_dataset = build_dataset(_leaf_dataset(vl_cfg.get("dataset", {})))
        self.batch_size = tl_cfg.get("batch_size", 16)
        self.scale = tuple(cfg.get("img_scale", (1000, 600)))
        self.gt_capacity = cfg.get("gt_capacity", 64)
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        # each rank loads its rows of every global batch of one seeded plan
        # (runner.py:256-276 in JAX)
        shards = dict(num_shards=self.world, shard_id=self.rank)
        self.train_loader = PrefetchLoader(DetLoader(
            self.train_dataset, batch_size=self.batch_size, scale=self.scale, training=True,
            repeat=_dataset_repeat(tl_cfg.get("dataset", {})), seed=self.seed,
            gt_capacity=self.gt_capacity, **shards,
        ), buffer_size=tl_cfg.get("num_workers", 2), transfer_fn=self._device_batch)
        self.val_loader = PrefetchLoader(DetLoader(
            self.val_dataset, batch_size=vl_cfg.get("batch_size", self.batch_size),
            scale=self.scale, training=False, gt_capacity=self.gt_capacity, **shards,
        ), buffer_size=2, transfer_fn=self._device_batch)
        self.max_epochs = cfg.get("train_cfg", {}).get("max_epochs", 30)

        # ---- model, then the checkpoint ----
        self.model = FasterRCNN(self.det_cfg).init_weights(torch.Generator().manual_seed(self.seed))
        load_from = cfg.get("load_from")
        if load_from is None and self.previous_dir is not None:
            load_from = ckpt_io.find_checkpoint(self.previous_dir, self.ckpt_keywords)
            if not load_from:
                raise FileNotFoundError(f"no '{self.ckpt_keywords}' checkpoint in {self.previous_dir}")
        pretrained = cfg.get_nested("model.backbone.init_cfg.checkpoint")
        if load_from:
            ckpt_io.load_checkpoint(self.model, load_from)
            logger.info(f"loaded checkpoint {load_from}")
        elif pretrained and osp.exists(str(pretrained)):
            self._load_backbone(pretrained)
        self.model.to(self.device)
        mesh.replicate(self.model)  # before the teacher copies it

        # ---- optimizer and teacher, both after the load (nsrunner:529-549) ----
        self.optimizer = build_train_optimizer(cfg, self.model, len(self.train_loader))
        opt_type = cfg.get("optim_wrapper", {}).get("optimizer", {}).get("type", "SGDNSCL")
        self.adaptive = opt_type != "SGDNSCLNA"
        self.teacher = build_teacher(self.model) if self.use_teacher else None

        # ---- NSGP transforms (update_optim_transforms, nsrunner:634) ----
        if self.use_nsgp and self.task_id != 1 and not self.is_trained:
            cov = ckpt_io.load_covariance(cfg.get("fea_in_load_path") or self.previous_dir)
            t0 = time.perf_counter()
            transforms = nsgp.build_transforms(cov, offset=self.offset,
                                               ignore_patterns=self.ignore_keys,
                                               adaptive=self.adaptive, logger=logger)
            self.timings["build_transforms_s"] = time.perf_counter() - t0
            optim.set_transforms(self.optimizer, transforms, self.n_tasks)
            logger.info(f"installed {len(self.optimizer.transforms)} of {len(transforms)} NSGP "
                        "transforms (the others are on frozen layers)")

        # ---- EWC terms (load_importance, nsrunner:996-999) ----
        self.ewc_terms: ewc.Terms = {}
        if self.use_nsgp and self.task_id != 1 and not self.is_trained \
                and "joint" not in self.work_dir \
                and osp.exists(osp.join(self.previous_dir, "ewc_reg_terms_ewc.npz")):
            raw = ckpt_io.load_ewc_terms(self.previous_dir, self.n_tasks)
            self.ewc_terms = {k: (torch.from_numpy(i).to(self.device),
                                  torch.from_numpy(p).to(self.device)) for k, (i, p) in raw.items()}

        # ---- RePRE prototypes ----
        replay_feats = replay_labels = None
        roi_head_type = cfg.get_nested("model.roi_head.type", "StandardMultiPrototypeReplayHead")
        if self.task_id != 1 and self.previous_dir and osp.exists(
                osp.join(self.previous_dir, "rois_etc.npz")):
            feats, cls_targets = ckpt_io.load_rois_etc(self.previous_dir)[:2]
            if roi_head_type == "StandardRoIReplayHead":
                # raw-feature variant: the WHOLE stored buffer; the train step
                # draws 64 rows a step (standard_roi_replay_head.py:56-66)
                protos = feats.reshape(feats.shape[0], -1).astype(np.float32)
                labels = cls_targets.astype(np.int32)
                logger.info(f"raw replay buffer: {len(protos)} stored RoI feats")
            elif roi_head_type == "StandardPrototypeReplayHead":
                protos, labels = replay.build_coarse_prototypes(
                    feats, cls_targets, self.task_split, self.task_id)
            else:  # StandardMultiPrototypeReplayHead (main configs)
                protos, labels, masks = replay.build_prototypes(
                    feats, cls_targets, self.task_split, self.task_id,
                    max_prototype=self.max_prototype,
                    saved_masks=ckpt_io.load_masks(self.previous_dir))
                mesh.main_write(lambda: ckpt_io.save_masks(self.work_dir, masks), "masks")
            if roi_head_type == "StandardRoIReplayHead" or len(protos):
                replay_feats = torch.from_numpy(protos).to(self.device)
                replay_labels = torch.from_numpy(labels).to(self.device)
                logger.info(f"replay: {len(protos)} rows ({roi_head_type})")

        # ---- steps ----
        clip_cfg = cfg.get("optim_wrapper", {}).get("clip_grad") or {}
        self.train_step = make_train_step(self.model, self.optimizer, self.teacher,
                                          clip_grad_norm=clip_cfg.get("max_norm"))
        # teacher pseudo-label cache: the frozen teacher is deterministic per
        # (image, flip), so its labels are computed once per variant (a
        # two-variant pre-pass, a live run for a missing entry) instead of
        # every step; teacher_label_cache=False runs the teacher in every
        # step, as the reference does (faster_rcnn_roi_replay.py:65-109).
        self.teacher_cache = bool(cfg.get("teacher_label_cache", True)) and self.use_teacher
        self.teacher_step = make_teacher_step(self.teacher) if self.use_teacher else None
        # entries hold the valid rows and their row positions only; past
        # the byte budget new entries are not cached (a warning is logged)
        self._pseudo_cache: Dict[tuple, tuple] = {}
        self._pseudo_cache_bytes = 0
        self._pseudo_cache_budget = int(cfg.get("teacher_cache_budget_mb", 512)) * (1 << 20)
        self._pseudo_cache_full = False
        self.eval_step = make_eval_step(self.model)
        self.cov_step = make_cov_step(self.model)
        self.roi_step = make_roi_extract_step(self.model)
        self.imp_step = make_importance_step(self.model, self.teacher)
        self.state = TrainState(
            self.optimizer,
            teacher_params=dict(self.teacher.named_parameters()) if self.teacher else None,
            replay_feats=replay_feats, replay_labels=replay_labels, ewc_terms=self.ewc_terms)
        self.timings["init_s"] = time.perf_counter() - t_init

    # ------------------------------------------------------------------
    def _add(self, key: str, value: float) -> None:
        self.timings[key] = self.timings.get(key, 0) + value

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, iterable, key: str):
        """``iterable``'s items, the time spent waiting for each added to
        ``timings[key]``."""
        it = iter(iterable)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    with span("runner.loader_wait"):
                        item = next(it)
                except StopIteration:
                    return
                finally:
                    self._add(key, time.perf_counter() - t0)
                yield item
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _device_batch(self, batch):
        """The loaders' ``transfer_fn`` (run in their worker threads)."""
        return to_device(batch, self.device, self._copy_stream)

    # ------------------------------------------------------------------
    def _load_backbone(self, path: str):
        ckpt_io.load_torch_backbone(self.model, path)
        logger.info(f"loaded torch backbone {path}")

    def _host_state(self, with_slots: bool = False) -> Dict[str, np.ndarray]:
        """The model's checkpoint entries, and with ``with_slots`` the
        train-loop state of ``resume_state.npz``: ``opt_<slot>/<path>`` for
        every parameter (JAX's masked optimizer keeps buffers for the
        frozen ones too; here they are zeros, and no update reads them),
        ``count`` and ``step``."""
        flat = ckpt_io.model_flat(self.model.state_dict())
        if with_slots:
            opt = self.optimizer
            for slot in opt.SLOTS:
                bufs = {n: opt.state[p][slot] if slot in opt.state.get(p, {}) else torch.zeros_like(p)
                        for n, p in self.model.named_parameters()}
                params, _ = jax_flat_from_state_dict(bufs)
                flat.update({f"opt_{slot}/{k}": v for k, v in params.items()})
            flat["count"] = np.asarray(opt.count, np.int32)
            flat["step"] = np.asarray(self.state.step, np.int32)
        return flat

    def _save_checkpoint(self, name: str, host_state=None) -> str:
        flat = host_state or self._host_state()
        path = osp.join(self.work_dir, name)
        mesh.main_write(lambda: ckpt_io.save_flat(path, {
            k: v for k, v in flat.items() if k.startswith(("params/", "batch_stats/"))}),
            "ckpt:" + name)
        return path

    # ------------------------------------------------------------------
    # resume (any task): every cross-task input (teacher, projections,
    # prototypes, EWC terms) is rebuilt at __init__ from the previous
    # task's files, which a crash mid-task cannot corrupt, so resume
    # restores the train-loop state only (runner.py:545-557 in JAX).
    # ------------------------------------------------------------------
    def _save_resume_state(self, epoch: int, host_state=None, best_map=-1.0):
        flat = dict(host_state or self._host_state(with_slots=True))
        flat["epoch"] = np.asarray(epoch)
        # the best-mAP watermark keeps a post-resume epoch from replacing a
        # better pre-crash best_*.npz
        flat["best_map"] = np.asarray(float(best_map))
        mesh.main_write(lambda: ckpt_io.save_flat(osp.join(self.work_dir, "resume_state.npz"),
                                                  flat), "resume_state")

    def _try_resume(self) -> int:
        self._resumed_best = -1.0
        path = osp.join(self.work_dir, "resume_state.npz")
        if not (self.cfg.get("resume", False) and osp.exists(path)):
            return 0
        flat = ckpt_io.load_pytree_flat(path)

        def pick(prefix):
            return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}

        ckpt_io.restore_state(self.model, state_dict_from_jax(pick("params/"), pick("batch_stats/")),
                              strict=True)
        opt = self.optimizer
        trainable = {id(p) for group in opt.param_groups for p in group["params"]}
        for slot in opt.SLOTS:
            bufs = state_dict_from_jax(pick(f"opt_{slot}/"), {})
            for n, p in self.model.named_parameters():
                if id(p) in trainable:
                    opt.state[p][slot] = bufs[n].to(p.device)
        opt.count = int(flat["count"])
        self.state.step = int(flat["step"])
        self._resumed_best = float(flat.get("best_map", -1.0))
        epoch = int(flat["epoch"]) + 1
        logger.info(f"resumed from {path} at epoch {epoch} "
                    f"(best mAP so far {self._resumed_best:.4f})")
        return epoch

    # ------------------------------------------------------------------
    # teacher pseudo-label cache (task > 1): the frozen teacher's labels
    # depend only on (image, flip)
    # ------------------------------------------------------------------
    @staticmethod
    def _global_keys(meta):
        """(img_id, flip) key per row of the batch."""
        flips = getattr(meta, "flips", [False] * len(meta))
        return list(zip(list(meta), flips))

    def _fill_pseudo_cache(self, batch: DetBatch, keys):
        """Run the teacher on the batch and cache every row of the global
        batch (``keys``; the ranks' detections are gathered, so every rank
        caches alike); returns this rank's detections on the device, ready
        for the step."""
        dets = self.teacher_step(batch)
        boxes, scores, labels, valid = mesh.all_gather_rows(
            (dets.boxes, dets.scores, dets.labels, dets.valid))
        for i, key in enumerate(keys):
            if key in self._pseudo_cache:
                continue
            idx = np.where(valid[i])[0].astype(np.int32)
            entry = (np.ascontiguousarray(boxes[i][idx]), np.ascontiguousarray(scores[i][idx]),
                     np.ascontiguousarray(labels[i][idx]), idx)
            nbytes = sum(a.nbytes for a in entry)
            if self._pseudo_cache_bytes + nbytes > self._pseudo_cache_budget:
                if not self._pseudo_cache_full:
                    self._pseudo_cache_full = True
                    logger.warning(
                        "teacher pseudo-label cache budget reached "
                        f"({self._pseudo_cache_budget >> 20} MB at {len(self._pseudo_cache)} "
                        "entries); further images fall back to per-step teacher recompute "
                        "(raise teacher_cache_budget_mb to cache more)")
                continue
            self._pseudo_cache_bytes += nbytes
            self._pseudo_cache[key] = entry
        return dets

    def _cached_pseudo(self, batch: DetBatch, meta) -> InstanceArray:
        """This rank's rows of the batch's teacher detections from the cache
        (valid rows at their positions, the rest zero and invalid), or one
        live teacher run, which also fills the cache, when any row of the
        global batch is missing (every rank decides alike)."""
        keys = self._global_keys(meta)
        if any(k not in self._pseudo_cache for k in keys):
            return self._fill_pseudo_cache(batch, keys)
        P = self.det_cfg.max_per_img
        B = batch.images.shape[0]
        boxes = np.zeros((B, P, 4), np.float32)
        scores = np.zeros((B, P), np.float32)
        labels = np.full((B, P), -1, np.int32)
        valid = np.zeros((B, P), bool)
        lo = self.rank * B  # this shard's keys (runner.py:655-676 in JAX)
        for i, k in enumerate(keys[lo:lo + B]):
            b, s, lab, idx = self._pseudo_cache[k]
            boxes[i][idx] = b
            scores[i][idx] = s
            labels[i][idx] = lab
            valid[i][idx] = True
        t = torch.from_numpy
        return to_device(InstanceArray(boxes=t(boxes), labels=t(labels), valid=t(valid),
                                       scores=t(scores)), self.device)

    def _precompute_pseudo_labels(self):
        """Two passes in order (flip off, flip on) over the train set with
        the teacher; fills the (img_id, flip) cache."""
        t0 = time.perf_counter()
        for force_flip in (False, True):
            pre = DetLoader(self.train_dataset, batch_size=self.batch_size, scale=self.scale,
                            training=False, gt_capacity=self.gt_capacity, force_flip=force_flip,
                            num_shards=self.world, shard_id=self.rank)
            for i, (batch, meta) in enumerate(PrefetchLoader(
                    pre, buffer_size=2, transfer_fn=self._device_batch)):
                self._fill_pseudo_cache(batch, self._global_keys(meta))
                self._add("teacher_batches", 1)
                if i % 20 == 0:
                    logger.info(f"teacher prefill flip={force_flip} batch {i} "
                                f"({time.perf_counter() - t0:.0f}s)")
        self.timings["teacher_prepass_s"] = time.perf_counter() - t0
        logger.info(f"teacher pseudo-label cache: {len(self._pseudo_cache)} entries "
                    f"in {self.timings['teacher_prepass_s']:.1f}s")

    def _train_batch_step(self, batch: DetBatch, meta, generator: torch.Generator):
        """One optimizer step, the teacher's labels from the cache when enabled."""
        if self.teacher_cache and self.state.teacher_params is not None:
            return self.train_step(self.state, batch, generator,
                                   teacher_dets=self._cached_pseudo(batch, meta))
        return self.train_step(self.state, batch, generator)

    def train(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        start_epoch = self._try_resume()
        best_map = self._resumed_best
        profile_dir = self.cfg.get("profile_dir")
        if not self.is_trained:
            if self.teacher_cache and self.state.teacher_params is not None:
                self._precompute_pseudo_labels()
            # JAX serialises the two canvases' programs on a canvas switch
            # (runner.py:732-753) against a TPU memory hazard of programs in
            # flight at once; eager PyTorch frees a step's activations before
            # the next step allocates, so there is nothing to guard here.
            # Rank 0 writes the scalars (the metrics are the global batch's).
            with open(osp.join(self.work_dir, "scalars.json") if mesh.is_main() else os.devnull,
                      "a") as log_f:
                for epoch in range(start_epoch, self.max_epochs):
                    self.train_loader.set_epoch(epoch)
                    t_loop, prof = time.perf_counter(), None
                    for it, (batch, meta) in enumerate(self._timed(self.train_loader,
                                                                   "loader_wait_s")):
                        if profile_dir and epoch == 0 and it == 10 and mesh.is_main():
                            prof = _start_profile(self.device)
                        if prof is not None and it == 15:
                            prof = _stop_profile(prof, profile_dir)
                        t0 = time.time()
                        self.state, metrics = self._train_batch_step(batch, meta, gen)
                        self._add("train_steps", 1)
                        if it % 50 == 0:
                            metrics = {k: float(v) for k, v in metrics.items()}
                            lr = float(self.optimizer.learning_rate(self.state.step))
                            logger.info(
                                f"epoch {epoch} iter {it}/{len(self.train_loader)} lr {lr:.2e} "
                                + " ".join(f"{k}:{v:.4f}" for k, v in metrics.items()))
                            log_f.write(json.dumps(dict(epoch=epoch, iter=it, lr=lr,
                                                        time=time.time() - t0, **metrics)) + "\n")
                            log_f.flush()
                    if prof is not None:
                        _stop_profile(prof, profile_dir)
                    self._sync()
                    self._add("train_loop_s", time.perf_counter() - t_loop)
                    mAP = self.val()
                    logger.info(f"epoch {epoch}: mAP {mAP:.4f}")
                    host_state = self._host_state(with_slots=True)
                    self._save_checkpoint(f"epoch_{epoch}.npz", host_state)
                    self._save_resume_state(epoch, host_state, best_map=max(mAP, best_map))
                    last = osp.join(self.work_dir, f"epoch_{epoch - 1}.npz")
                    if mesh.is_main() and osp.exists(last):
                        os.remove(last)  # max_keep_ckpts=1
                    # every rank scored the same gathered detections
                    if mAP > best_map:
                        if mesh.is_main():
                            for f in os.listdir(self.work_dir):
                                if f.startswith("best_"):
                                    os.remove(osp.join(self.work_dir, f))
                        best_map = mAP
                        self._save_checkpoint(f"best_mAP_epoch_{epoch}.npz", host_state)
        # post-training files (nsrunner:589-593)
        self.calculate_save_importance()
        self.cal_fea_in()
        self.cal_rois()

    # ------------------------------------------------------------------
    def _visualize(self, batch, img_ids, boxes, scores, labels, valid) -> None:
        """Each listed image of a val batch drawn with its gts (left) and
        its detections (right) to ``<work_dir>/vis_data/<img_id>.jpg``
        (runner.py:886-915 in JAX: the batch's canvas image, the
        detections as predict returns them). The detections are the
        global batch's; its images are gathered too, and rank 0 draws."""
        from ..visualization import DetLocalVisualizer

        imgs, gt_boxes, gt_labels, gt_valid = mesh.all_gather_rows(
            (batch.images, batch.gt.boxes, batch.gt.labels, batch.gt.valid))
        if not mesh.is_main():
            return
        vis = DetLocalVisualizer(osp.join(self.work_dir, "vis_data"),
                                 class_names=getattr(self.val_dataset, "classes", None))
        for i, img_id in enumerate(img_ids):
            v, gv = valid[i], gt_valid[i]
            pred = dict(boxes=boxes[i][v], scores=scores[i][v], labels=labels[i][v])
            vis.add_datasample(str(img_id), imgs[i], pred,
                               gt=dict(boxes=gt_boxes[i][gv], labels=gt_labels[i][gv]))

    @torch.no_grad()
    def val(self, dump_to: Optional[str] = None) -> float:
        """Predict over the val set and score it (VOC or COCO mAP by
        ``val_evaluator``); with ``dump_to`` also pickle the per-image
        detections (img_id, boxes, scores, labels), the reference's
        ``tools/test.py --out`` (DumpDetResults). Under data parallel the
        ranks' detections are gathered, so every rank scores the global
        set (runner.py:870-935 in JAX); rank 0 draws and dumps."""
        t0 = time.perf_counter()
        detections, annotations = [], []
        dumped = [] if dump_to else None
        vis_budget = self.cfg.get("vis_images", 0)  # DetVisualizationHook
        for batch, img_ids in self.val_loader:
            dets = self.eval_step(batch)
            boxes, scores, labels, valid = mesh.all_gather_rows(
                (dets.boxes, dets.scores, dets.labels, dets.valid))
            if vis_budget > 0:
                self._visualize(batch, img_ids[:vis_budget], boxes, scores, labels, valid)
                vis_budget -= len(img_ids)
            for i in range(len(img_ids)):
                per_cls = {}
                for c in range(self.det_cfg.num_classes):
                    m = valid[i] & (labels[i] == c)
                    per_cls[c] = (boxes[i][m], scores[i][m])
                detections.append(per_cls)
                if dumped is not None:
                    v = valid[i]
                    dumped.append(dict(img_id=img_ids[i], boxes=boxes[i][v], scores=scores[i][v],
                                       labels=labels[i][v]))
            annotations.extend(self._val_annotations(img_ids))
        self._add("val_s", time.perf_counter() - t0)
        self._add("val_images", len(detections))
        if dump_to:
            mesh.main_write(lambda: self._dump(dumped, dump_to), "dump")
        if self.cfg.get("val_evaluator", {}).get("type", "VOCMetric") == "CocoMetric":
            mAP = eval_coco_map(detections, annotations, self.det_cfg.num_classes)["mAP"]
        else:
            mode = self.cfg.get("val_evaluator", {}).get("eval_mode", "11points")
            mAP, _ = eval_voc_map(detections, annotations, self.det_cfg.num_classes, mode=mode)
        self.last_val_map = mAP
        return mAP

    def _val_annotations(self, img_ids):
        by_id = getattr(self, "_val_ann_cache", None)
        if by_id is None:
            by_id = {r["img_id"]: r for r in self.val_dataset.records}
            self._val_ann_cache = by_id
        return [dict(boxes=by_id[i]["boxes"], labels=by_id[i]["labels"],
                     difficult=by_id[i].get("difficult"),
                     ignore_boxes=by_id[i].get("ignore_boxes")) for i in img_ids]

    @staticmethod
    def _dump(dumped, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(dumped, f)
        logger.info(f"dumped {len(dumped)} per-image results to {path}")

    def test(self, dump_to: Optional[str] = None) -> float:
        mAP = self.val(dump_to=dump_to)
        logger.info(f"test mAP: {mAP:.4f}")
        # nsrunner test() also recomputes the files (:624-625)
        self.cal_fea_in()
        self.calculate_save_importance()
        return mAP

    # ------------------------------------------------------------------
    # task-end passes
    # ------------------------------------------------------------------
    def _reload_best(self):
        path = ckpt_io.find_checkpoint(self.work_dir, self.ckpt_keywords)
        if path:
            ckpt_io.load_checkpoint(self.model, path)

    def _batches(self, max_batches: Optional[int], key: str):
        """The train loader's epoch-0 plan, capped at ``max_batches``,
        counted in ``timings[key]``."""
        self.train_loader.set_epoch(0)
        for i, (batch, _) in enumerate(self.train_loader):
            if max_batches and i >= max_batches:
                return
            self._add(key, 1)
            yield batch

    def cal_fea_in(self, max_batches: Optional[int] = None):
        """Input covariances over the train set (nsrunner:704-763)."""
        logger.info("cal_fea_in ...")
        t0 = time.perf_counter()
        self._reload_best()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        total = None
        for batch in self._batches(max_batches, "cov_batches"):
            cov = self.cov_step(batch, gen)
            # the reference hooks only modules outside ignore_keys
            # (nsrunner:731-732): the file holds those layers only
            cov = {k: v for k, v in cov.items()
                   if not any(re.match(p, k) for p in self.ignore_keys)}
            total = nsgp.accumulate_cov(total, cov)
        total = {k: v.cpu().numpy() for k, v in (total or {}).items()}
        if self.task_id != 1:
            # accumulate onto the previous file (nsrunner:746-749); keys only
            # in the previous file carry forward
            prev = ckpt_io.load_covariance(self.previous_dir)
            total = (dict(prev)
                     | {k: v for k, v in total.items() if k not in prev}
                     | {k: v + prev[k] for k, v in total.items() if k in prev})
        # every rank holds the same sums: the taps averaged the batch means
        mesh.main_write(lambda: logger.info(
            f"covariance saved to {ckpt_io.save_covariance(self.work_dir, total)}"), "covariance")
        self.timings["cov_s"] = time.perf_counter() - t0

    def cal_rois(self, max_batches: Optional[int] = None):
        """RoI features for RePRE (nsrunner:776-868)."""
        logger.info("cal_rois ...")
        t0 = time.perf_counter()
        self._reload_best()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 3)
        parts = [[] for _ in ckpt_io.ROIS_KEYS]
        for batch in self._batches(max_batches, "roi_batches"):
            # the global batch's RoIs on every rank (FasterRCNN.get_bbox_stuff)
            *arrays, valid = [x.cpu().numpy() for x in self.roi_step(batch, gen)]
            for part, a in zip(parts, arrays):
                part.append(a[valid])
        arrays = [np.concatenate(p) for p in parts]
        if self.reserve_per_class:
            arrays = replay.subsample_per_class(arrays, arrays[1], self.reserve_per_class,
                                                num_classes=self.det_cfg.num_classes)
        if self.task_id != 1:
            prev = ckpt_io.load_rois_etc(self.previous_dir)
            arrays = [np.concatenate([p, a]) for p, a in zip(prev, arrays)]
        mesh.main_write(lambda: logger.info(
            f"rois_etc saved to {ckpt_io.save_rois_etc(self.work_dir, arrays)} "
            f"({len(arrays[0])} features)"), "rois_etc")
        self.timings["rois_s"] = time.perf_counter() - t0

    def calculate_save_importance(self, max_batches: Optional[int] = None):
        """EWC Fisher diagonal over the train set (nsrunner:946-990)."""
        logger.info("cal importance ...")
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 4)
        params = dict(self.model.named_parameters())
        importance = ewc.init_importance(params)
        n_batches = len(self.train_loader)
        for batch in self._batches(max_batches, "importance_batches"):
            grads = self.imp_step(self.state, batch, gen)  # the global batch's
            importance = ewc.accumulate_importance(
                importance, grads, batch.images.shape[0] * self.world, n_batches)
        terms = ewc.append_task_terms(dict(self.state.ewc_terms or {}), importance, params)
        mesh.main_write(lambda: logger.info(
            f"EWC terms saved to {ckpt_io.save_ewc_terms(self.work_dir, terms, self.n_tasks)}"),
            "ewc_terms")
        self.timings["importance_s"] = time.perf_counter() - t0


class TeacherRunner(NullSpaceRunner):
    """Teacher-only baseline: no NSGP projections, no EWC, no task-end
    files (teacherrunner.py:65)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__(cfg, use_nsgp=False, device=device)

    def train(self):
        best_map = -1.0
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        for epoch in range(self.max_epochs):
            self.train_loader.set_epoch(epoch)
            for it, (batch, _) in enumerate(self.train_loader):
                self.state, metrics = self.train_step(self.state, batch, gen)
                if it % 50 == 0:
                    logger.info(f"epoch {epoch} iter {it}: "
                                + " ".join(f"{k}:{float(v):.4f}" for k, v in metrics.items()))
            mAP = self.val()
            self._save_checkpoint(f"epoch_{epoch}.npz")
            if mAP > best_map:
                best_map = mAP
                self._save_checkpoint(f"best_mAP_epoch_{epoch}.npz")


def _start_profile(device: torch.device):
    """torch.profiler over the train loop's iterations 10-15 of epoch 0
    (``profile_dir``, JAX's jax.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = osp.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace saved to {path}")
