"""Task-aware Faster R-CNN: predict, the training loss and its task-2 terms.

Counterpart of nsgp_repre_tpu/models/detector.py: ``DetectorConfig``
(same fields and defaults), ``extract_feat``, ``_anchors``,
``_anchor_valid``, ``rpn_loss_and_proposals`` (dense and sparse RPN
loss), ``_rpn_proposals_from_maps``, ``_sample_rois``, ``_roi_feats``,
``roi_loss``, ``loss`` (with the teacher's merged gt sets and prototype
replay), ``bbox_forward``, ``replay_loss``, ``raw_replay_loss``,
``predict``, ``_predict_from_proposals`` and ``get_bbox_stuff`` (the
RePRE RoI store). Shapes stay static as in JAX: 1000 proposals, 512
sampled RoIs and 100 detections per image, padded, with validity masks.
Feature maps cross module boundaries as NHWC views of channels_last
tensors.

Hand-written kernels: on predict, the FPN output convs (conv3x3) and the
dense RPN head (rpn_head) at batch <= ``infer_fused_max_batch``, NMS
twice (proposals, multiclass) and RoIAlign once; on a training step, the
dense RPN head (forward only, sparse loss), the anchor assignment
(assign), proposal NMS, and RoIAlign forward and backward. On CPU
tensors each runs its plain version.

The random sampling draws its priorities (uniform on [0, 1)) in the
order JAX splits its key: the RPN's (B, N) for the anchors, then the
RoI head's two (B, G + proposals) draws (masks, then gather order), G
the RoI gt set's capacity (merged with the teacher's detections on
task 2). They come from a ``torch.Generator`` or are passed in, so a
test can feed JAX's draws. ``rpn_nms_impl='matrix'`` runs the NMS kernel
with JAX's batch-wide group offset (ops/nms_cuda.py::batched_nms_matrix);
``nms_type='soft_nms'`` takes the plain-PyTorch ``batched_soft_nms`` of
ops/nms.py (no kernel in JAX either).

Under a running profiler the stages mark themselves with the ranges of
utils/spans.py: ``predict``, ``backbone`` (extract_feat), ``rpn`` (the
head, anchors, assignment, sampling and loss), ``proposals``, ``roi``
(the RoI stage of the loss and of predict) and ``replay``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.anchors import AnchorGenerator
from ..ops.assign_cuda import rpn_assign_targets
from ..ops.nms import batched_soft_nms
from ..ops.nms_cuda import batched_nms, batched_nms_matrix
from ..ops.roi_align_cuda import multilevel_roi_align
from ..ops.topk import top_k
from ..parallel.mesh import all_gather_rows, rank, shard_rows, world_size
from ..structures.boxes import bbox2delta, delta2bbox
from ..structures.sample import DetBatch, InstanceArray
from ..utils.spans import span
from .assigners import max_iou_assign
from .bbox_head import Shared2FCBBoxHeadTask
from .fpn import FPN
from .layers import CovConv, CovDense, FrozenBatchNorm, nhwc
from .losses import (accuracy, global_avg_factor, weighted_l1, weighted_sigmoid_bce,
                     weighted_softmax_ce)
from .resnet import ResNet50
from .rpn_head import RPNHead
from .samplers import random_sample_gather, random_sample_masks

@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static hyperparameters (faster-rcnn_r50_fpn.py train/test cfg).

    The fields and defaults are those of the JAX package's
    DetectorConfig, so one config maps onto both. Fields that only steer
    a TPU-specific choice are read as follows here: ``use_approx_topk``
    is ignored (top-k is always exact), both ``roi_align_mode`` values
    run the RoIAlign kernel with mmdet routing, ``stem_s2d`` is ignored
    (a plain conv computes the same function), and ``rpn_nms_impl``
    'auto', 'pallas' and 'xla' all run the NMS kernel ('matrix' runs it
    too, with the group offset over the whole batch as JAX's matrix form
    takes it).
    """

    num_classes: int = 20
    task_split: Tuple[int, ...] = (0, 20)
    task_id: int = 1
    # anchors
    anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_scales: Tuple[float, ...] = (8.0,)
    # rpn assign/sample (train_cfg.rpn)
    rpn_pos_iou_thr: float = 0.7
    rpn_neg_iou_thr: float = 0.3
    rpn_min_pos_iou: float = 0.3
    rpn_num: int = 256
    rpn_pos_fraction: float = 0.5
    # rpn proposals (train_cfg.rpn_proposal; reference predict() also
    # uses the train cfg — faster_rcnn_roi_replay.py:272)
    rpn_nms_pre: int = 2000
    rpn_max_per_img: int = 1000
    rpn_nms_iou: float = 0.7
    # rcnn assign/sample (train_cfg.rcnn)
    rcnn_pos_iou_thr: float = 0.5
    rcnn_neg_iou_thr: float = 0.5
    rcnn_min_pos_iou: float = 0.5
    rcnn_num: int = 512
    rcnn_pos_fraction: float = 0.25
    # rcnn test (test_cfg.rcnn)
    score_thr: float = 0.05
    nms_iou: float = 0.5
    max_per_img: int = 100
    # nms=dict(type='soft_nms', ...) knob (bbox_nms.py → mmcv soft_nms):
    # 'nms' = hard greedy (default), 'soft_nms' = score-decay variant
    nms_type: str = "nms"
    soft_nms_sigma: float = 0.5
    soft_nms_min_score: float = 1e-3
    soft_nms_method: str = "linear"
    # coders
    rcnn_target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    # roi extraction
    roi_out_size: int = 7
    roi_strides: Tuple[int, ...] = (4, 8, 16, 32)
    roi_finest_scale: float = 56.0
    roi_sampling_ratio: int = 2
    # backbone depth knob — (3,4,6,3) = ResNet-50; tests shrink it the way
    # the reference shrinks R50→R18 (tests/test_detectors/test_two_stage.py:26)
    backbone_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    frozen_stages: int = 1
    # exact space-to-depth evaluation of the 7x7/2 stem (JAX only)
    stem_s2d: bool = False
    # teacher pseudo-label thresholds (rr_thresh; nsrunner:356)
    rpn_thresh: float = 0.5
    roi_thresh: float = 0.7
    pseudo_iou_skip: float = 0.7
    compute_dtype: str = "float32"
    # approximate pre-NMS top-k (JAX on a TPU only; the port is exact)
    use_approx_topk: bool = True
    # proposal-NMS implementation: 'matrix' (exact greedy with a batch-wide
    # group offset), 'pallas' / 'xla' / 'auto' (greedy NMS); the kernel here
    rpn_nms_impl: str = "auto"
    # sparse RPN loss path: the RPN losses are evaluated at the sampled
    # anchors only (RPNHead.at_positions) and the dense head runs forward
    # only, for the proposals
    rpn_sparse_loss: bool = True
    # fused RPN head kernel on forward-only dense-head paths (predict; the
    # sparse-loss train path at any batch)
    rpn_fused_head: bool = True
    # the fused FPN output convs and the fused RPN head run on predict
    # only when the batch is at most this size; larger batches use
    # library convs, as the JAX package leaves them to XLA
    infer_fused_max_batch: int = 1
    # the teacher's RoIAlign takes a 1x1 sample grid, unless
    # roi_align_mode is 'window' (engine/runner.py::build_teacher)
    teacher_fast: bool = True
    # RoIAlign implementation in JAX: 'window' (Pallas) or 'gather' (XLA,
    # reference routing). Both run the RoIAlign kernel here.
    roi_align_mode: str = "window"
    # RePRE replay variant: 'prototype' (cross-entropy of the prototypes'
    # logits) or 'raw' (MSE against the teacher's logits on stored features)
    replay_mode: str = "prototype"
    # per-image pad divisor for anchor valid-flags (mmdet Pad transform,
    # pad_size_divisor=32 in the detector data_preprocessor config)
    pad_size_divisor: int = 32

    @property
    def num_base_priors(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_scales)


class _RoIHead(nn.Module):
    """Container so the bbox head's names read ``roi_head.bbox_head.*``."""

    def __init__(self, bbox_head: nn.Module):
        super().__init__()
        self.bbox_head = bbox_head


def anchor_valid_flags(cfg, sizes, img_shape: torch.Tensor) -> torch.Tensor:
    """(B, N) inside-image flags of every anchor from each image's padded
    shape (detector.py:242-266): the grid cell must lie inside
    ceil(pad_shape / stride), pad_shape the resized shape rounded up to
    ``cfg.pad_size_divisor`` (mmdet valid_flags with allowed_border=-1).
    ``cfg`` names the anchor strides and the priors per location."""
    A = cfg.num_base_priors
    B = img_shape.shape[0]
    dev = img_shape.device
    div = float(cfg.pad_size_divisor)
    shape = img_shape.to(torch.float32)
    pad_h = (torch.ceil(shape[:, 0] / div) * div)[:, None, None]
    pad_w = (torch.ceil(shape[:, 1] / div) * div)[:, None, None]
    flags = []
    for (fh, fw), stride in zip(sizes, cfg.anchor_strides):
        gy = torch.arange(fh, device=dev)[None, :, None]
        gx = torch.arange(fw, device=dev)[None, None, :]
        f = (gy < torch.ceil(pad_h / stride)) & (gx < torch.ceil(pad_w / stride))
        flags.append(f.reshape(B, -1).repeat_interleave(A, dim=1))
    return torch.cat(flags, dim=1)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std) draws from the CPU generator (weights independent of the device)."""
    t.copy_(torch.randn(t.shape, generator=generator) * std)


def he_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """He normal over fan_out (CovConv's default init in JAX)."""
    normal_(t, math.sqrt(2.0 / (t.shape[0] * t[0, 0].numel())), generator)


def xavier_(t: torch.Tensor, generator: torch.Generator) -> None:
    """Xavier uniform (the FPN's and the shared FCs' init in JAX)."""
    fan_out, fan_in = t.shape[0], t.shape[1]
    rf = t[0, 0].numel() if t.dim() > 2 else 1
    lim = math.sqrt(6.0 / ((fan_in + fan_out) * rf))
    t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * lim)


def reset_norms_and_biases(model: nn.Module) -> None:
    """Zero biases and identity frozen BNs, every init's last step."""
    for m in model.modules():
        if isinstance(m, (CovConv, CovDense)) and m.bias is not None:
            m.bias.zero_()
        if isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


class FasterRCNN(nn.Module):
    """Backbone + FPN + RPN + task-split RoI head. The model zoo's
    families change a part through its ``_build_*`` method (the C4 and
    DC5 trunks have no neck: ``_build_neck`` gives None)."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        cfg = config
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.config = cfg
        self.backbone = self._build_backbone()
        self.neck = self._build_neck()
        self.rpn_head = self._build_rpn_head()
        self.roi_head = self._build_roi_head()
        self.anchor_gen = AnchorGenerator(
            strides=cfg.anchor_strides, ratios=cfg.anchor_ratios, scales=cfg.anchor_scales)
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}

    def _build_backbone(self) -> nn.Module:
        cfg = self.config
        return ResNet50(stage_blocks=cfg.backbone_blocks, frozen_stages=cfg.frozen_stages)

    def _build_neck(self) -> Optional[nn.Module]:
        return FPN(out_channels=256, num_outs=5)

    def _build_rpn_head(self) -> nn.Module:
        return RPNHead(256, 256, self.config.num_base_priors)

    def _build_roi_head(self) -> Optional[nn.Module]:
        """The RoI head (``roi_head.*``); the model zoo's families override it."""
        cfg = self.config
        return _RoIHead(Shared2FCBBoxHeadTask(
            task_split=cfg.task_split, task_id=cfg.task_id, num_classes=cfg.num_classes))

    @property
    def bbox_head(self) -> Shared2FCBBoxHeadTask:
        return self.roi_head.bbox_head

    def _bbox_heads(self) -> List[Shared2FCBBoxHeadTask]:
        """Every bbox head of the model (one here; a cascade's stages)."""
        return [self.bbox_head]

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "FasterRCNN":
        """Seeded random init with the JAX package's initializers: He
        normal (fan_out) backbone convs, Xavier-uniform FPN and shared FCs,
        N(0, 0.01) RPN convs and classifiers, N(0, 0.001) regressors, zero
        biases, identity BN. Draws on the CPU generator, so the weights do
        not depend on the device."""

        g = generator
        for m in self.backbone.modules():
            if isinstance(m, CovConv):
                he_normal_(m.weight, g)
        for m in (self.neck.modules() if self.neck is not None else ()):
            if isinstance(m, CovConv):
                xavier_(m.weight, g)
        for m in self.rpn_head.modules():
            if isinstance(m, CovConv):
                normal_(m.weight, 0.01, g)
        for head in self._bbox_heads():
            for m in head.shared_fcs:
                xavier_(m.weight, g)
            for m in head.fc_cls:
                normal_(m.weight, 0.01, g)
            for m in head.fc_reg:
                normal_(m.weight, 0.001, g)
        self._init_extra(g)
        reset_norms_and_biases(self)
        return self

    def _init_extra(self, generator: torch.Generator) -> None:
        """The init of what a family adds (the C4 head's res5 and classifiers)."""

    # ------------------------------------------------------------------
    def extract_feat(self, images: torch.Tensor, inference: bool = False) -> Tuple[torch.Tensor, ...]:
        """images (B,H,W,3) → 5 NHWC FPN levels in the compute dtype.
        ``inference=True`` lets the FPN output convs take the conv3x3
        kernel at batch <= infer_fused_max_batch."""
        with span("backbone"):
            cfg = self.config
            fused = (inference and cfg.rpn_fused_head
                     and images.shape[0] <= cfg.infer_fused_max_batch)
            x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            feats = self.backbone(x)
            if self.neck is not None:
                feats = self.neck(feats, fused=fused)
            return tuple(nhwc(f) for f in feats)

    def _anchors(self, feats) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
        """All levels' anchors (N, 4) on the maps' device, and the sizes."""
        sizes = [(int(f.shape[1]), int(f.shape[2])) for f in feats]
        dev = feats[0].device
        key = (tuple(sizes), str(dev))
        if key not in self._anchor_cache:
            per_level = self.anchor_gen.grid_anchors(sizes)
            self._anchor_cache[key] = torch.from_numpy(np.concatenate(per_level, axis=0)).to(dev)
        return self._anchor_cache[key], sizes

    # ------------------------------------------------------------------
    def _anchor_valid(self, sizes, img_shape: torch.Tensor) -> torch.Tensor:
        """(B, N) inside-image anchor flags (:func:`anchor_valid_flags`)."""
        return anchor_valid_flags(self.config, sizes, img_shape)

    @staticmethod
    def _priorities(given, shape, generator, device) -> torch.Tensor:
        """Sampling priorities of this rank's rows, ``shape`` (B, ...):
        ``given`` (of the global shape (W·B, ...), checked), else uniform
        [0, 1) draws at the global shape from ``generator`` on its own
        device; either way rank r takes rows ``[r·B, (r+1)·B)``, so every
        rank consumes the generator alike and a world of W samples what
        one process does on the whole batch (parallel/mesh.py)."""
        W = world_size()
        gshape = (shape[0] * W,) + tuple(shape[1:])
        if given is not None:
            if tuple(given.shape) != gshape:
                raise ValueError(f"priorities of shape {gshape} expected, got {tuple(given.shape)}")
            u = given.to(device=device, dtype=torch.float32)
        elif generator is None:
            raise ValueError("sampling needs a torch.Generator or the priorities themselves")
        else:
            u = torch.rand(gshape, generator=generator, device=generator.device).to(device)
        return u if W == 1 else shard_rows(u, rank(), W)

    # ------------------------------------------------------------------
    def rpn_loss_and_proposals(self, feats, gt: InstanceArray, img_shape: torch.Tensor,
                               with_loss: bool = True, u=None, generator=None):
        """RPN losses (``with_loss``) and proposals (loss_and_predict,
        base_dense_head.py:132). ``u``: the (B, N) anchor-sampling
        priorities, else drawn from ``generator``. Proposals are data:
        no gradient flows through them."""
        with span("rpn"):
            cfg = self.config
            B = feats[0].shape[0]
            # sparse loss: the dense head runs forward only (its maps feed the
            # proposals); the loss-path logits are re-evaluated at the sampled
            # anchors below
            sparse = with_loss and cfg.rpn_sparse_loss
            fused = cfg.rpn_fused_head and (
                sparse or (not with_loss and B <= cfg.infer_fused_max_batch))
            head_in = tuple(f.detach() for f in feats) if sparse else feats
            cls_maps, reg_maps = self.rpn_head(head_in, fused=fused)
            anchors, sizes = self._anchors(feats)
            A = cfg.num_base_priors
            cls_flat = torch.cat([m.reshape(B, -1) for m in cls_maps], dim=1).float()
            reg_flat = torch.cat([m.reshape(B, -1, 4) for m in reg_maps], dim=1).float()
            level_sizes = [h * w * A for h, w in sizes]

            losses = {}
            if with_loss:
                dev = cls_flat.device
                valid = self._anchor_valid(sizes, img_shape.to(dev))
                assigned, _, tgt = rpn_assign_targets(
                    anchors, gt.boxes.to(dev), gt.valid.to(dev), valid,
                    cfg.rpn_pos_iou_thr, cfg.rpn_neg_iou_thr, cfg.rpn_min_pos_iou,
                )
                u = self._priorities(u, assigned.shape, generator, dev)
                pos, neg = random_sample_masks(assigned, cfg.rpn_num, cfg.rpn_pos_fraction, u)
                label_w = (pos | neg).float()
                # avg_factor over the whole (global) batch, as in JAX
                avg = global_avg_factor(label_w.sum())
                if sparse:
                    cls_s, reg_s, pos_s, w_s, tgt_s = self._rpn_sparse_logits(
                        feats, pos, neg, tgt, level_sizes)
                    losses["loss_rpn_cls"] = weighted_sigmoid_bce(cls_s, pos_s, w_s, avg)
                    losses["loss_rpn_bbox"] = weighted_l1(reg_s, tgt_s, pos_s[..., None], avg)
                else:
                    losses["loss_rpn_cls"] = weighted_sigmoid_bce(
                        cls_flat, pos.float(), label_w, avg)
                    losses["loss_rpn_bbox"] = weighted_l1(
                        reg_flat, tgt, pos[..., None].float(), avg)

        return self._rpn_proposals_from_maps(cls_flat.detach(), reg_flat.detach(), level_sizes,
                                             anchors, img_shape, losses, B)

    def _rpn_sparse_logits(self, feats, pos, neg, tgt, level_sizes):
        """Loss-path RPN logits at the sampled anchors only
        (detector.py:388-455). The sampled set depends on anchors and gts,
        never on predictions, so the head is evaluated as matmuls on the
        gathered 3x3 input windows (RPNHead.at_positions); the gradients
        equal the dense path's, whose conv backward is zero at every
        unsampled position.

        Returns cls (B, S), reg (B, S, 4), pos (B, S), weight (B, S) and
        tgt (B, S, 4), f32, S = rpn_num.
        """
        cfg = self.config
        A = cfg.num_base_priors
        B = pos.shape[0]
        S = min(cfg.rpn_num, pos.shape[1])
        # the sampled anchors' indices, lowest first; slots beyond the
        # sampled count get weight 0 (top-k values of a 0/1 mask)
        w_s, idx = top_k((pos | neg).float(), S)
        pos_s = torch.gather(pos, 1, idx).float()
        tgt_s = torch.gather(tgt, 1, idx[..., None].expand(B, S, 4))

        # flat anchor index → (level, y, x, a): each level is laid out
        # (y, x, a) with a fastest, at offsets that are multiples of A
        offsets = [0]
        for n_l in level_sizes:
            offsets.append(offsets[-1] + n_l)
        a_idx = idx % A

        C = feats[0].shape[-1]
        dt = feats[0].dtype
        d3 = torch.arange(-1, 2, device=idx.device)
        patches = torch.zeros((B, S, 9, C), dtype=dt, device=idx.device)
        for l, f in enumerate(feats):
            fh, fw = f.shape[1], f.shape[2]
            in_l = (idx >= offsets[l]) & (idx < offsets[l + 1])
            hw = (idx - offsets[l]) // A
            y, x = hw // fw, hw % fw
            yy = y[..., None, None] + d3[:, None]  # (B, S, 3, 1)
            xx = x[..., None, None] + d3[None, :]  # (B, S, 1, 3)
            ok = (yy >= 0) & (yy < fh) & (xx >= 0) & (xx < fw) & in_l[..., None, None]
            p = (torch.clamp(yy, 0, fh - 1) * fw + torch.clamp(xx, 0, fw - 1)).reshape(B, S * 9, 1)
            g = torch.gather(f.reshape(B, fh * fw, C), 1, p.expand(B, S * 9, C)).reshape(B, S, 9, C)
            patches = patches + g * ok.reshape(B, S, 9, 1).to(dt)

        cls_m, reg_m = self.rpn_head.at_positions(patches.reshape(B * S, 3, 3, C))
        cls_s = torch.gather(cls_m.float().reshape(B, S, A), 2, a_idx[..., None])[..., 0]
        reg_s = torch.gather(reg_m.float().reshape(B, S, A, 4), 2,
                             a_idx[..., None, None].expand(B, S, 1, 4))[:, :, 0]
        return cls_s, reg_s, pos_s, w_s, tgt_s

    @torch.no_grad()
    def _rpn_proposals_from_maps(self, cls_flat, reg_flat, level_sizes, anchors,
                                 img_shape, losses, B):
        with span("proposals"):
            cfg = self.config
            if cfg.rpn_nms_impl not in ("auto", "matrix", "pallas", "xla"):
                raise ValueError(f"unknown rpn_nms_impl {cfg.rpn_nms_impl!r}")
            shape = img_shape.to(device=cls_flat.device, dtype=torch.float32)
            max_shape = (shape[:, 0].view(B, 1, 1), shape[:, 1].view(B, 1, 1))
            boxes_l, scores_l, lvl_l = [], [], []
            off = 0
            for li, n_l in enumerate(level_sizes):
                s = torch.sigmoid(cls_flat[:, off:off + n_l])
                d = reg_flat[:, off:off + n_l]
                a = anchors[off:off + n_l]
                k = min(cfg.rpn_nms_pre, n_l)
                top_s, top_i = top_k(s, k)
                sel_d = torch.gather(d, 1, top_i[..., None].expand(B, k, 4))
                boxes_l.append(delta2bbox(a[top_i], sel_d, max_shape=max_shape))
                scores_l.append(top_s)
                lvl_l.append(torch.full((B, k), li, dtype=torch.int32, device=cls_flat.device))
                off += n_l
            boxes = torch.cat(boxes_l, dim=1)
            scores = torch.cat(scores_l, dim=1)
            lvls = torch.cat(lvl_l, dim=1)
            wh_ok = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
            nms_fn = batched_nms_matrix if cfg.rpn_nms_impl == "matrix" else batched_nms
            keep_idx, p_valid = nms_fn(boxes, scores, lvls, wh_ok, cfg.rpn_nms_iou,
                                       cfg.rpn_max_per_img)
            keep = keep_idx.long()
            p_boxes = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
            p_scores = torch.gather(scores, 1, keep)
            proposals = InstanceArray(
                boxes=p_boxes,
                labels=torch.zeros(p_boxes.shape[:2], dtype=torch.int32, device=p_boxes.device),
                valid=p_valid,
                scores=p_scores,
            )
            return losses, proposals

    # ------------------------------------------------------------------
    def _sample_rois(self, proposals: InstanceArray, gt: InstanceArray, u, u2):
        """Assign + random-sample ``rcnn_num`` RoIs per image from the gts
        and the proposals (detector.py:526-563, add_gt_as_proposals=True)
        with priorities ``u`` (masks) and ``u2`` (order), (B, G + P) each.
        Returns the flat (B * rcnn_num) rois, batch indices, labels,
        validity, positive flags and regression targets."""
        cfg = self.config
        thr = (cfg.rcnn_pos_iou_thr, cfg.rcnn_neg_iou_thr, cfg.rcnn_min_pos_iou)
        return self._sample(proposals, gt, u, u2, thr, cfg.rcnn_target_stds)[:6]

    def _sample(self, proposals: InstanceArray, gt: InstanceArray, u, u2, thr, stds):
        """:meth:`_sample_rois` with the assigner's (pos, neg, min_pos) IoU
        thresholds ``thr`` and the coder's ``stds`` given (a cascade
        stage's), and one more output: the flat ``is_gt``, True where the
        sampled slot indexes the injected gt block (cascade.py:140-156)."""
        cfg = self.config
        B = proposals.boxes.shape[0]
        dev = proposals.boxes.device
        cand_boxes = torch.cat([gt.boxes, proposals.boxes], dim=1)
        cand_valid = torch.cat([gt.valid, proposals.valid], dim=1)
        assigned, _ = max_iou_assign(
            cand_boxes, gt.boxes, gt.valid, *thr,
            match_low_quality=False, prior_valid=cand_valid,
        )
        idx, idx_valid, idx_pos = random_sample_gather(
            assigned, cfg.rcnn_num, cfg.rcnn_pos_fraction, u, u2)
        S = idx.shape[1]
        rois = torch.gather(cand_boxes, 1, idx[..., None].expand(B, S, 4))
        g = torch.clamp(torch.gather(assigned, 1, idx), min=0).long()
        labels = torch.where(idx_pos, torch.gather(gt.labels, 1, g), cfg.num_classes)
        labels = torch.where(idx_valid, labels, cfg.num_classes)
        tgt = bbox2delta(rois, torch.gather(gt.boxes, 1, g[..., None].expand(B, S, 4)),
                         stds=stds)
        tgt = torch.where(idx_pos[..., None], tgt, torch.zeros_like(tgt))
        batch_idx = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(S)
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        is_gt = idx < gt.boxes.shape[1]
        return (flat(rois), batch_idx, flat(labels), flat(idx_valid), flat(idx_pos), flat(tgt),
                flat(is_gt))

    def _roi_feats(self, feats, rois, batch_idx):
        """RoIAlign in the compute dtype (f32 accumulation inside),
        differentiable w.r.t. the features through the backward kernel.
        Both ``roi_align_mode`` values run the same kernels with mmdet
        routing: the TPU window path's level bump has no counterpart
        here."""
        cfg = self.config
        fs = [f.to(self.dtype).contiguous() for f in feats[: len(cfg.roi_strides)]]
        return multilevel_roi_align(
            fs, rois, batch_idx, strides=cfg.roi_strides, output_size=cfg.roi_out_size,
            sampling_ratio=cfg.roi_sampling_ratio, finest_scale=cfg.roi_finest_scale,
        ).to(self.dtype)

    def priority_shapes(self, batch_size: int, gt_slots: int,
                        num_anchors: int) -> Dict[str, Tuple[int, int]]:
        """The shape of every sampling draw :meth:`loss` reads, keyed and
        ordered as it draws them: ``rpn`` (B, anchors), then the RoI
        head's ``roi`` and ``roi2`` (B, G + proposals)."""
        n = (batch_size, gt_slots + self.config.rpn_max_per_img)
        return {"rpn": (batch_size, num_anchors), "roi": n, "roi2": n}

    def roi_loss(self, feats, proposals: InstanceArray, gt: InstanceArray,
                 img_shape: Optional[torch.Tensor] = None,
                 priorities: Optional[Dict[str, torch.Tensor]] = None, generator=None,
                 replay_feats: Optional[torch.Tensor] = None,
                 replay_labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """RoI-head losses on sampled proposals (standard_roi_head.py:95,
        detector.py:586-613): ``loss_cls``, ``loss_bbox`` and ``acc``, and
        ``replay_loss_cls`` when prototypes are given. ``priorities`` may
        hold ``roi``/``roi2``, (B, G + P) each, else they are drawn from
        ``generator`` in that order. Every family takes these arguments;
        ``img_shape`` (B, 2) is read by the cascade's refinement only."""
        with span("roi"):
            p = priorities or {}
            B, P = proposals.boxes.shape[:2]
            dev = proposals.boxes.device
            shape = (B, gt.boxes.shape[1] + P)
            u = self._priorities(p.get("roi"), shape, generator, dev)
            u2 = self._priorities(p.get("roi2"), shape, generator, dev)
            gt = gt.to(dev)
            rois, batch_idx, labels, valid, pos, tgt = self._sample_rois(proposals, gt, u, u2)
            losses = self._roi_losses(feats, rois, batch_idx, labels, valid, pos, tgt, gt)
            if replay_feats is not None:
                losses["replay_loss_cls"] = self.replay_loss(replay_feats, replay_labels)
            return losses

    def _roi_losses(self, feats, rois, batch_idx, labels, valid, pos, tgt,
                    gt: InstanceArray) -> Dict[str, torch.Tensor]:
        """The RoI head's losses on the sampled RoIs: the bbox head's, and
        those a family adds (the mask head's)."""
        losses = self._bbox_losses(feats, rois, batch_idx, labels, valid, pos, tgt)
        losses.update(self._extra_roi_losses(feats, rois, batch_idx, labels, pos, gt))
        return losses

    def _extra_roi_losses(self, feats, rois, batch_idx, labels, pos,
                          gt: InstanceArray) -> Dict[str, torch.Tensor]:
        """Losses a family adds on the same sampled RoIs (the mask head's)."""
        return {}

    def _roi_head_forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """RoIAlign output → (cls_score, bbox_pred) in the compute dtype."""
        return self.bbox_head(roi_feats)

    def _bbox_losses(self, feats, rois, batch_idx, labels, valid, pos,
                     tgt) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox`` (L1 on the sampled class's
        regression) and ``acc`` of the sampled RoIs (detector.py:586-608)."""
        cls_score, bbox_pred = self._roi_head_forward(self._roi_feats(feats, rois, batch_idx))
        return self._cls_reg_losses(cls_score, bbox_pred, labels, valid, pos, tgt)

    def _cls_reg_losses(self, cls_score, bbox_pred, labels, valid, pos,
                        tgt) -> Dict[str, torch.Tensor]:
        cfg = self.config
        cls_score = cls_score.float()
        bbox_pred = bbox_pred.float()

        label_w = valid.float()
        avg = global_avg_factor(label_w.sum())
        loss_cls = weighted_softmax_ce(cls_score, labels, label_w, avg)
        # the regression of the sampled class (bbox_head.py:575)
        n = bbox_pred.shape[0]
        pred4 = bbox_pred.reshape(n, cfg.num_classes, 4)
        cls_idx = torch.clamp(labels, 0, cfg.num_classes - 1).long()
        sel = torch.gather(pred4, 1, cls_idx[:, None, None].expand(n, 1, 4))[:, 0]
        loss_bbox = weighted_l1(sel, tgt, pos[:, None].float(), avg)
        return {
            "loss_cls": loss_cls,
            "loss_bbox": loss_bbox,
            "acc": accuracy(cls_score, labels, label_w, avg),
        }

    def bbox_forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bbox head on stored flattened RoI features (R, C*7*7), torch
        order: f32 (cls_score, bbox_pred). The raw replay's teacher logits."""
        cls, reg = self.bbox_head(roi_feats.to(self.dtype))
        return cls.float(), reg.float()

    def raw_replay_loss(self, replay_feats: torch.Tensor, teacher_cls: torch.Tensor) -> torch.Tensor:
        """StandardRoIReplayHead's MSE of the student's cls logits against
        the frozen teacher's on stored RoI features
        (standard_roi_replay_head.py:73-104), over the columns both heads
        have active: ``[:task_split[max(task_id - 1, 1)]] ++ [background]``
        (detector.py:621-639)."""
        with span("replay"):
            cls, _ = self.bbox_forward(replay_feats)
            pre = self.config.task_split[max(self.config.task_id - 1, 1)]
            s = torch.cat([cls[:, :pre], cls[:, -1:]], dim=-1)
            t = torch.cat([teacher_cls[:, :pre], teacher_cls[:, -1:]], dim=-1)
            return torch.mean(torch.square(s - t))

    def replay_loss(self, replay_feats: torch.Tensor, replay_labels: torch.Tensor) -> torch.Tensor:
        """RePRE prototype replay (standard_roi_replay_head.py:468-501): the
        prototypes' logits over ``[:task_split[task_id]] ++ [background]``,
        and the cross-entropy of their SOFTMAX, a softmax taken twice as
        the reference takes it (it changes the gradients)."""
        with span("replay"):
            cls_score, _ = self.bbox_head(replay_feats.to(self.dtype))
            cls_score = cls_score.float()
            pre = self.config.task_split[self.config.task_id]
            sliced = torch.cat([cls_score[:, :pre], cls_score[:, -1:]], dim=-1)
            logp = torch.log_softmax(torch.softmax(sliced, dim=-1), dim=-1)
            return -torch.gather(logp, 1, replay_labels.long()[:, None]).mean()

    def loss(self, batch: DetBatch, generator=None,
             priorities: Optional[Dict[str, torch.Tensor]] = None,
             rpn_gt: Optional[InstanceArray] = None, roi_gt: Optional[InstanceArray] = None,
             replay_feats: Optional[torch.Tensor] = None,
             replay_labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The detector loss (faster_rcnn_roi_replay.py:44, detector.py:667-687).
        ``batch.images`` are normalized. ``rpn_gt``/``roi_gt``: the gt sets
        merged with the teacher's detections (engine/pseudo.py), else
        ``batch.gt``; ``replay_feats``/``replay_labels``: prototypes.
        ``priorities`` may hold the sampling draws ``rpn`` (B, N anchors),
        ``roi`` and ``roi2`` (B, G + proposals); the missing ones are drawn
        from ``generator`` in that order."""
        p = priorities or {}
        feats = self.extract_feat(batch.images)
        rpn_losses, proposals = self.rpn_loss_and_proposals(
            feats, rpn_gt if rpn_gt is not None else batch.gt, batch.img_shape, with_loss=True,
            u=p.get("rpn"), generator=generator)
        roi_losses = self.roi_loss(feats, proposals, roi_gt if roi_gt is not None else batch.gt,
                                   batch.img_shape, p, generator, replay_feats, replay_labels)
        return {**rpn_losses, **roi_losses}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, batch: DetBatch, rescale: bool = True) -> InstanceArray:
        """Normalized images → padded detections (max_per_img per image)."""
        with span("predict"):
            feats = self.extract_feat(batch.images, inference=True)
            _, proposals = self.rpn_loss_and_proposals(feats, batch.gt, batch.img_shape,
                                                       with_loss=False)
            return self._predict_from_proposals(feats, proposals, batch, rescale)

    def _predict_from_proposals(self, feats, proposals: InstanceArray, batch: DetBatch,
                                rescale: bool = True) -> InstanceArray:
        """RoI-stage predict on given proposals (StandardRoIHead.predict +
        bbox_head.py:427), batched over images."""
        with span("roi"):
            cfg = self.config
            nc = cfg.num_classes
            B, R = proposals.boxes.shape[:2]
            dev = proposals.boxes.device
            rois = proposals.boxes.reshape(-1, 4)
            batch_idx = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(R)
            cls_score, bbox_pred = self._roi_head_forward(self._roi_feats(feats, rois, batch_idx))
            cls_score = cls_score.float().reshape(B, R, -1)
            bbox_pred = bbox_pred.float().reshape(B, R, -1)

            shape = batch.img_shape.to(device=dev, dtype=torch.float32)
            max_shape = (shape[:, 0].view(B, 1, 1), shape[:, 1].view(B, 1, 1))
            boxes = delta2bbox(proposals.boxes, bbox_pred, stds=cfg.rcnn_target_stds,
                               max_shape=max_shape).reshape(B, R, nc, 4)
            if rescale:
                scale = batch.scale_factor.to(device=dev, dtype=torch.float32)
                boxes = boxes / torch.cat([scale, scale], dim=1)[:, None, None, :]
            probs = torch.softmax(cls_score, dim=-1)[..., :nc]
            flat_boxes = boxes.reshape(B, -1, 4)
            flat_scores = probs.reshape(B, -1)
            flat_labels = torch.arange(nc, dtype=torch.int32, device=dev).repeat(B, R)
            ok = (flat_scores > cfg.score_thr) & proposals.valid.repeat_interleave(nc, dim=1)
            # multiclass NMS (bbox_nms.py:12): greedy (the kernel), or soft-NMS
            # with its decayed scores (detector.py:739-752 in JAX)
            if cfg.nms_type == "soft_nms":
                keep_idx, dv, scores = batched_soft_nms(
                    flat_boxes, flat_scores, flat_labels, ok, cfg.nms_iou, cfg.max_per_img,
                    sigma=cfg.soft_nms_sigma, min_score=cfg.soft_nms_min_score,
                    method=cfg.soft_nms_method)
            else:
                keep_idx, dv = batched_nms(flat_boxes, flat_scores, flat_labels, ok, cfg.nms_iou,
                                           cfg.max_per_img)
                scores = None
            keep = keep_idx.long()
            return InstanceArray(
                boxes=torch.gather(flat_boxes, 1, keep[..., None].expand(-1, -1, 4)),
                labels=torch.gather(flat_labels, 1, keep),
                valid=dv,
                scores=torch.gather(flat_scores, 1, keep) if scores is None else scores,
            )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def get_bbox_stuff(self, batch: DetBatch, generator=None, target_count: int = 5,
                       priorities: Optional[Dict[str, torch.Tensor]] = None):
        """Exactly ``target_count`` RoI features of the batch for the RePRE
        store (standard_roi_replay_head.py:168-196, detector.py:770-807):
        the sampled RoIs ranked foreground first, then the other valid
        ones, in a random order within each group. ``batch.images`` are
        normalized. ``priorities`` may hold ``roi`` and ``roi2`` (B, G +
        proposals; the sampler's) and ``cap`` (B * rcnn_num; the ranking),
        else they are drawn from ``generator`` in that order.

        Returns f32 features (T, C*7*7) in torch order, labels, cls
        weights (ones), regression targets, bbox weights, rois and a
        validity mask (all True).
        """
        cfg = self.config
        p = priorities or {}
        feats = self.extract_feat(batch.images, inference=True)
        _, proposals = self.rpn_loss_and_proposals(feats, batch.gt, batch.img_shape,
                                                   with_loss=False)
        B, P = proposals.boxes.shape[:2]
        dev = proposals.boxes.device
        gt = batch.gt.to(dev)
        shape = (B, gt.boxes.shape[1] + P)
        u = self._priorities(p.get("roi"), shape, generator, dev)
        u2 = self._priorities(p.get("roi2"), shape, generator, dev)
        rois, batch_idx, labels, valid, pos, tgt = self._sample_rois(proposals, gt, u, u2)
        mid = self.bbox_head.mid_features(self._roi_feats(feats, rois, batch_idx)).float()
        u3 = self._priorities(p.get("cap"), valid.shape, generator, dev)
        # exactly target_count: foreground first, then the other valid RoIs
        key = torch.where(pos & valid, 2.0 + u3, torch.where(valid, u3, -1.0))
        order = top_k(key, target_count)[1]
        picked = (mid[order], labels[order], tgt[order], pos[order], rois[order])
        if world_size() > 1:
            # the global batch's top target_count are among the ranks' own
            # top ones; gathered in rank order, equal keys keep the lowest
            # global index first, as top_k over the whole batch has them
            keys, *cands = all_gather_rows((key[order],) + picked)
            sel = top_k(torch.from_numpy(keys), target_count)[1].numpy()
            picked = tuple(torch.from_numpy(c[sel]).to(dev) for c in cands)
        mid, labels, tgt, pos, rois = picked
        return (
            mid,
            labels,
            torch.ones(target_count, dtype=torch.float32, device=dev),
            tgt,
            pos[:, None].float().repeat(1, 4),
            rois,
            torch.ones(target_count, dtype=torch.bool, device=dev),
        )
