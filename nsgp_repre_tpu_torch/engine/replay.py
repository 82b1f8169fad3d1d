"""RePRE: prototypes from stored RoI features, host-side numpy.

Counterpart of nsgp_repre_tpu/engine/replay.py, kept as the port's own
copy (reference StandardMultiPrototypeReplayHead.__init__,
standard_roi_replay_head.py:397-452). Per old class:
- ONE coarse prototype = mean of all stored features (:413-414);
- up to ``max_prototype - 1`` fine prototypes by greedy cosine-similarity
  clustering (:417-448): normalize flattened features, similarity matrix,
  threshold 0.6, rank candidates by neighbor count (descending), exclude
  the bottom third as centers, take each chosen center's cluster mean,
  mark members used; cached cluster masks reproduce prior tasks' clusters
  bit-exactly (mask.pth protocol, :407-452).

Runs once per task on the stored features; the results go to the card as
``TrainState.replay_feats`` / ``replay_labels``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def build_prototypes(
    bbox_feats: np.ndarray,
    cls_targets: np.ndarray,
    task_split: Sequence[int],
    task_id: int,
    max_prototype: int = 10,
    saved_masks: Optional[List[List[np.ndarray]]] = None,
) -> Tuple[np.ndarray, np.ndarray, List[List[np.ndarray]]]:
    """Build coarse + fine prototypes for all previous-task classes.

    Args:
        bbox_feats: (N, 12544) stored RoI features.
        cls_targets: (N,) class labels of the stored features.
        saved_masks: per-class list of cached cluster masks (mask.pth).

    Returns:
        prototypes (P, 12544), labels (P,), save_idx (updated masks).
    """
    feats = np.asarray(bbox_feats, dtype=np.float32)
    targets = np.asarray(cls_targets).astype(np.int64)
    previous_cls = range(task_split[0], task_split[task_id - 1])
    save_idx: List[List[np.ndarray]] = list(saved_masks) if saved_masks else []

    protos: List[np.ndarray] = []
    labels: List[int] = []
    for i in previous_cls:
        cls_mask = targets == i
        cls_feats = feats[cls_mask]
        if len(cls_feats) == 0:
            # degenerate (class never stored) — reference would produce a
            # NaN mean; skip instead and keep training sane.
            if i >= len(save_idx):
                save_idx.append([])
            continue
        protos.append(cls_feats.mean(axis=0))
        labels.append(i)

        norm = np.linalg.norm(cls_feats, axis=-1, keepdims=True)
        fn = cls_feats / np.maximum(norm, 1e-12)
        sim = fn @ fn.T
        sim_mask = sim >= 0.6  # (n, n)
        counts = sim_mask.sum(axis=-1)
        order = np.argsort(-counts, kind="stable")
        sim_sum_sorted = counts[order]
        thresh = sim_sum_sorted[-max(len(counts) // 3, 1)]
        used = counts <= thresh  # bottom third can't seed clusters (:423)

        tmp_mask: List[np.ndarray] = (
            list(save_idx[i]) if i < len(save_idx) else []
        )
        for proto_count in range(max_prototype - 1):
            for id_ in order:
                if proto_count < len(tmp_mask):
                    m = np.asarray(tmp_mask[proto_count], dtype=bool)
                else:
                    if used[id_]:
                        continue
                    m = sim_mask[id_]
                    tmp_mask.append(m)
                used = used | m
                protos.append(cls_feats[m].mean(axis=0))
                labels.append(i)
                break
        if i >= len(save_idx):
            save_idx.append(tmp_mask)

    if protos:
        return (
            np.stack(protos).astype(np.float32),
            np.asarray(labels, dtype=np.int32),
            save_idx,
        )
    return (
        np.zeros((0, feats.shape[-1]), np.float32),
        np.zeros((0,), np.int32),
        save_idx,
    )


def build_coarse_prototypes(
    bbox_feats: np.ndarray,
    cls_targets: np.ndarray,
    task_split: Sequence[int],
    task_id: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """StandardPrototypeReplayHead ablation — one class-mean prototype per
    old class (standard_roi_replay_head.py:230-236)."""
    feats = np.asarray(bbox_feats, dtype=np.float32)
    targets = np.asarray(cls_targets).astype(np.int64)
    protos, labels = [], []
    for i in range(task_split[0], task_split[task_id - 1]):
        cls_feats = feats[targets == i]
        if len(cls_feats):
            protos.append(cls_feats.mean(axis=0))
            labels.append(i)
    if protos:
        return np.stack(protos).astype(np.float32), np.asarray(labels, np.int32)
    return np.zeros((0, feats.shape[-1]), np.float32), np.zeros((0,), np.int32)


def subsample_per_class(
    arrays: Sequence[np.ndarray],
    cls_targets: np.ndarray,
    reserve_per_class: int,
    num_classes: int = 20,
    rng: Optional[np.random.RandomState] = None,
) -> List[np.ndarray]:
    """reserve_per_class subsampling of the stored RoI tuple
    (cal_rois, nsrunner:825-842): the same random per-class mask applies
    to every array of the tuple."""
    rng = rng or np.random.RandomState(0)
    targets = np.asarray(cls_targets).astype(np.int64)
    masks = {}
    out = []
    for arr in arrays:
        parts = []
        for c in range(num_classes):
            cls_idx = np.where(targets == c)[0]
            if c not in masks:
                perm = rng.permutation(len(cls_idx))[:reserve_per_class]
                masks[c] = perm
            parts.append(arr[cls_idx[masks[c]]])
        out.append(np.concatenate(parts, axis=0))
    return out
