"""PASCAL VOC mAP (11-point / area modes).

Parity targets: mmdet/evaluation/metrics/voc_metric.py:16 (VOCMetric,
eval_mode='11points', IoU 0.5) and functional/mean_ap.py:525 (eval_map
TP/FP matching: detections sorted by score, matched greedily to the
best-IoU unclaimed gt; 'difficult' gts are ignored — a match to one is
neither TP nor FP and they don't count toward recall).

Counterpart of nsgp_repre_tpu/evaluation/voc_map.py, the port's own
numpy copy. It takes the numpy path of ``_tpfp_single`` only; the JAX
package's native path (native/libnsgp_native.so), which its tests hold
to this numpy path, is not loaded (ROADMAP.md, queue 1 item 2).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-6)


def _tpfp_single(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    gt_ignore: np.ndarray,
    iou_thr: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """TP/FP flags for one image, one class (dets pre-sorted by score)."""
    nd = len(det_boxes)
    tp = np.zeros(nd, np.float32)
    fp = np.zeros(nd, np.float32)
    if len(gt_boxes) == 0:
        fp[:] = 1
        return tp, fp
    ious = _iou_matrix(det_boxes, gt_boxes)
    claimed = np.zeros(len(gt_boxes), bool)
    for d in range(nd):
        best = ious[d].argmax()
        if ious[d, best] >= iou_thr:
            if gt_ignore[best]:
                continue  # neither tp nor fp
            if not claimed[best]:
                claimed[best] = True
                tp[d] = 1
            else:
                fp[d] = 1
        else:
            fp[d] = 1
    return tp, fp


def average_precision(recalls: np.ndarray, precisions: np.ndarray, mode: str) -> float:
    """11-point or area-under-PR AP (mean_ap.py average_precision)."""
    if mode == "11points":
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            mask = recalls >= t
            p = precisions[mask].max() if mask.any() else 0.0
            ap += p / 11.0
        return float(ap)
    # 'area' mode
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def eval_voc_map(
    detections: List[Dict[int, Tuple[np.ndarray, np.ndarray]]],
    annotations: List[dict],
    num_classes: int,
    iou_thr: float = 0.5,
    mode: str = "11points",
) -> Tuple[float, List[dict]]:
    """Compute mAP.

    Args:
        detections: per image {class: (boxes (N,4), scores (N,))}.
        annotations: per image dict with 'boxes' (G,4), 'labels' (G,),
            'difficult' (G,) arrays in original-image coordinates.
        mode: '11points' (VOC2007) or 'area'.

    Returns:
        (mAP over classes with gt, per-class results).
    """
    results = []
    for cls in range(num_classes):
        all_tp, all_fp, all_scores = [], [], []
        num_gt = 0
        for det, ann in zip(detections, annotations):
            cls_mask = ann["labels"] == cls
            g_boxes = ann["boxes"][cls_mask]
            g_ign = ann.get("difficult", np.zeros(len(ann["labels"]), np.int32))[
                cls_mask
            ].astype(bool)
            num_gt += int((~g_ign).sum())
            boxes, scores = det.get(cls, (np.zeros((0, 4), np.float32), np.zeros(0)))
            order = np.argsort(-scores, kind="stable")
            boxes, scores = boxes[order], scores[order]
            tp, fp = _tpfp_single(boxes, scores, g_boxes, g_ign, iou_thr)
            all_tp.append(tp)
            all_fp.append(fp)
            all_scores.append(scores)
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        tp = np.concatenate(all_tp) if all_tp else np.zeros(0)
        fp = np.concatenate(all_fp) if all_fp else np.zeros(0)
        order = np.argsort(-scores, kind="stable")
        tp, fp = np.cumsum(tp[order]), np.cumsum(fp[order])
        recalls = tp / max(num_gt, 1)
        precisions = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        ap = average_precision(recalls, precisions, mode) if num_gt > 0 else np.nan
        results.append(
            dict(
                num_gts=num_gt,
                num_dets=int(len(scores)),
                recall=float(recalls[-1]) if len(recalls) and num_gt else 0.0,
                ap=ap,
            )
        )
    aps = [r["ap"] for r in results if r["num_gts"] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    return mean_ap, results
