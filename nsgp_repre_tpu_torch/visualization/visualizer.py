"""Detection visualization.

Counterpart of nsgp_repre_tpu/visualization/visualizer.py, the port's own
copy (numpy and cv2 on the host): mmdet/visualization/local_visualizer.py
(DetLocalVisualizer) + LocalVisBackend — draw predicted/gt boxes on
images and save them under a vis directory (DetVisualizationHook
behavior).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

_PALETTE = [
    (255, 99, 71), (60, 179, 113), (65, 105, 225), (255, 215, 0),
    (186, 85, 211), (0, 206, 209), (255, 140, 0), (154, 205, 50),
    (219, 112, 147), (100, 149, 237), (244, 164, 96), (46, 139, 87),
    (199, 21, 133), (30, 144, 255), (189, 183, 107), (205, 92, 92),
    (72, 209, 204), (255, 105, 180), (107, 142, 35), (123, 104, 238),
]


def draw_detections(
    img: np.ndarray,
    pred: dict,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.3,
    thickness: int = 2,
) -> np.ndarray:
    """Draw dict(boxes, scores, labels) onto an RGB image copy."""
    import cv2

    out = img.copy()
    boxes = np.asarray(pred["boxes"])
    scores = np.asarray(pred.get("scores", np.ones(len(boxes))))
    labels = np.asarray(pred.get("labels", np.zeros(len(boxes), np.int32)))
    for box, score, label in zip(boxes, scores, labels):
        if score < score_thr:
            continue
        color = _PALETTE[int(label) % len(_PALETTE)]
        x1, y1, x2, y2 = [int(v) for v in box]
        cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
        name = (
            class_names[int(label)]
            if class_names is not None and int(label) < len(class_names)
            else str(int(label))
        )
        cv2.putText(
            out, f"{name} {score:.2f}", (x1, max(y1 - 4, 10)),
            cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA,
        )
    return out


class DetLocalVisualizer:
    """Save annotated images to <save_dir>/vis_data (LocalVisBackend)."""

    def __init__(self, save_dir: str = "./vis_data", class_names=None):
        self.save_dir = save_dir
        self.class_names = class_names
        os.makedirs(save_dir, exist_ok=True)

    def add_datasample(
        self,
        name: str,
        image: np.ndarray,
        pred: Optional[dict] = None,
        score_thr: float = 0.3,
        gt: Optional[dict] = None,
        draw_gt: bool = True,
        draw_pred: bool = True,
    ) -> str:
        """Save an annotated image. With both ``gt`` and ``pred`` given the
        panels are concatenated side by side — GT left, prediction right
        (DetLocalVisualizer.add_datasample,
        mmdet/visualization/local_visualizer.py: ``np.concatenate(
        (gt_img_data, pred_img_data), axis=1)``)."""
        import cv2

        panels = []
        if draw_gt and gt is not None:
            panels.append(
                draw_detections(image, gt, self.class_names, score_thr=-1.0)
            )
        if draw_pred and pred is not None:
            panels.append(
                draw_detections(image, pred, self.class_names, score_thr)
            )
        vis = np.concatenate(panels, axis=1) if len(panels) > 1 else (
            panels[0] if panels else image
        )
        path = osp.join(self.save_dir, f"{name}.jpg")
        cv2.imwrite(path, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
        return path
