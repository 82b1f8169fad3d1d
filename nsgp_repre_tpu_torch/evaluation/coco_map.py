"""COCO-style bbox AP without pycocotools (not present in this image).

Parity target: mmdet/evaluation/metrics/coco_metric.py:23 (CocoMetric →
pycocotools COCOeval 'bbox'). This is a self-contained numpy
implementation of the COCOeval protocol: IoU thresholds 0.50:0.95:0.05,
101-point precision interpolation, maxDets=100, crowd/ignore handling,
area ranges (all/small/medium/large).

Counterpart of nsgp_repre_tpu/evaluation/coco_map.py, the port's own
copy. The per-image match runs in native/det_eval.cpp through the port's
loader (evaluation/native.py); :func:`_match_numpy`, the numpy matcher,
is the reference the tests hold it to.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .native import coco_match

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_with_crowd(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """COCO IoU: crowd gts use intersection-over-det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float32)
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _evaluate_img(det_boxes, det_scores, gt_boxes, gt_crowd, area_rng, max_dets):
    """Per-image/class match matrix over all IoU thresholds.

    Returns (dt_matches (T, D), dt_ignore (T, D), gt_ignore (G,), scores).
    """
    order = np.argsort(-det_scores, kind="stable")[:max_dets]
    det_boxes, det_scores = det_boxes[order], det_scores[order]
    dtm, dti, gti = coco_match(det_boxes, gt_boxes, gt_crowd, IOU_THRS, *area_rng)
    return dtm, dti, gti, det_scores


def _match_numpy(det_boxes, gt_boxes, gt_crowd, iou_thrs, area_lo, area_hi):
    """COCOeval's greedy match of one image and class (dets sorted by
    score) in numpy: the reference of native.coco_match, with its
    arguments and results, but gt_ignore with the ignored gts last (the
    evaluator only counts it)."""
    area_rng = (area_lo, area_hi)
    g_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    gt_ig = gt_crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
    # sort gts: non-ignored first (COCOeval convention)
    g_order = np.argsort(gt_ig, kind="stable")
    gt_boxes, gt_ig, gt_crowd = gt_boxes[g_order], gt_ig[g_order], gt_crowd[g_order]

    ious = _iou_with_crowd(det_boxes, gt_boxes, gt_crowd)
    T, D, G = len(iou_thrs), len(det_boxes), len(gt_boxes)
    dtm = np.zeros((T, D), np.int64) - 1
    gtm = np.zeros((T, G), np.int64) - 1
    for ti, thr in enumerate(iou_thrs):
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                if gtm[ti, g] >= 0 and not gt_crowd[g]:
                    continue
                if best_g >= 0 and not gt_ig[best_g] and gt_ig[g]:
                    break  # remaining gts are ignored; keep current match
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g >= 0:
                dtm[ti, d] = best_g
                gtm[ti, best_g] = d
    d_area = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
    dt_out_of_range = (d_area < area_rng[0]) | (d_area > area_rng[1])
    dt_ig = np.zeros((T, D), bool)
    for ti in range(T):
        matched_ig = np.array(
            [gt_ig[m] if m >= 0 else False for m in dtm[ti]], dtype=bool
        )
        dt_ig[ti] = matched_ig | ((dtm[ti] < 0) & dt_out_of_range)
    return dtm >= 0, dt_ig, gt_ig


def eval_coco_map(
    detections: List[Dict[int, Tuple[np.ndarray, np.ndarray]]],
    annotations: List[dict],
    num_classes: int,
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO bbox metrics.

    Args:
        detections: per image {class: (boxes xyxy, scores)}.
        annotations: per image dict: 'boxes' (G,4) xyxy, 'labels' (G,),
            optional 'iscrowd' (G,), optional 'ignore_boxes' (K,4)
            (crowd regions, label-agnostic — folded per class).

    Returns:
        {'mAP', 'mAP_50', 'mAP_75', 'mAP_s', 'mAP_m', 'mAP_l'}.
    """
    results = {}
    ap_per_area = {}
    for area_name in ("all", "small", "medium", "large"):
        rng = AREA_RANGES[area_name]
        precisions = np.full((len(IOU_THRS), len(RECALL_THRS), num_classes), -1.0)
        for cls in range(num_classes):
            matches, ignores, scores_all = [], [], []
            n_gt = 0
            for det, ann in zip(detections, annotations):
                mask = ann["labels"] == cls
                g_boxes = ann["boxes"][mask]
                crowd = ann.get("iscrowd")
                g_crowd = (
                    crowd[mask].astype(bool) if crowd is not None else np.zeros(mask.sum(), bool)
                )
                ig_extra = ann.get("ignore_boxes")
                if ig_extra is not None and len(ig_extra):
                    g_boxes = np.concatenate([g_boxes, ig_extra])
                    g_crowd = np.concatenate([g_crowd, np.ones(len(ig_extra), bool)])
                boxes, scores = det.get(
                    cls, (np.zeros((0, 4), np.float32), np.zeros(0))
                )
                dtm, dti, gti, s = _evaluate_img(
                    boxes, scores, g_boxes, g_crowd, rng, max_dets
                )
                matches.append(dtm)
                ignores.append(dti)
                scores_all.append(s)
                n_gt += int((~gti).sum())
            if n_gt == 0:
                continue
            scores = np.concatenate(scores_all)
            order = np.argsort(-scores, kind="stable")
            dtm = np.concatenate(matches, axis=1)[:, order]
            dti = np.concatenate(ignores, axis=1)[:, order]
            tps = dtm & ~dti
            fps = ~dtm & ~dti
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(len(IOU_THRS)):
                tp, fp = tp_cum[ti], fp_cum[ti]
                rc = tp / n_gt
                pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                # monotone precision envelope
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, RECALL_THRS, side="left")
                q = np.zeros(len(RECALL_THRS))
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precisions[ti, :, cls] = q
        valid = precisions > -1
        ap_per_area[area_name] = (
            float(precisions[valid].mean()) if valid.any() else 0.0
        )
        if area_name == "all":
            v50 = precisions[0][precisions[0] > -1]
            v75 = precisions[5][precisions[5] > -1]
            results["mAP_50"] = float(v50.mean()) if len(v50) else 0.0
            results["mAP_75"] = float(v75.mean()) if len(v75) else 0.0
            # per-class AP (area=all), nan for classes with no gt — the
            # incremental protocol's old/new retention split needs these
            # (pycocotools exposes the same via COCOeval.eval['precision'])
            per_class = np.full(num_classes, np.nan)
            per_class_50 = np.full(num_classes, np.nan)
            for cls in range(num_classes):
                p = precisions[:, :, cls]
                if (p > -1).any():
                    per_class[cls] = float(p[p > -1].mean())
                    p50 = precisions[0, :, cls]
                    per_class_50[cls] = (
                        float(p50[p50 > -1].mean()) if (p50 > -1).any() else 0.0
                    )
            results["per_class_mAP"] = per_class
            results["per_class_mAP_50"] = per_class_50
    results["mAP"] = ap_per_area["all"]
    results["mAP_s"] = ap_per_area["small"]
    results["mAP_m"] = ap_per_area["medium"]
    results["mAP_l"] = ap_per_area["large"]
    return results
