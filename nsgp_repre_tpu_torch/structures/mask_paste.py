"""Host-side mask pasting + gt-mask preparation (numpy).

The mask head emits per-detection 28x28 probabilities over the detection
box (models/mask.py). Pasting them into full-image binary masks is a
host-side post-process, matching mmdet's
``FCNMaskHead.predict_by_feat`` → ``_do_paste_mask``
(mmdet/models/roi_heads/mask_heads/fcn_mask_head.py) which also runs as
a (GPU-side there) resize-per-box.

``normalize_gt_masks`` is the training-side inverse: it converts
full-image instance bitmaps into fixed-size box-normalized crops — the
static-shape gt representation models/mask.py trains against.

Counterpart of nsgp_repre_tpu/structures/mask_paste.py, the port's own
copy (numpy only; it runs on the host on either side).
"""
from __future__ import annotations

import numpy as np


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=False bilinear resize: cv2's, or the same rule in
    numpy where cv2 is not installed."""
    try:
        import cv2

        return cv2.resize(
            img.astype(np.float32), (out_w, out_h), interpolation=cv2.INTER_LINEAR
        )
    except ImportError:
        h, w = img.shape[:2]
        ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
        xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        ly = np.clip(ys - y0, 0, 1)[:, None]
        lx = np.clip(xs - x0, 0, 1)[None, :]
        v = (
            img[np.ix_(y0, x0)] * (1 - ly) * (1 - lx)
            + img[np.ix_(y0, x1)] * (1 - ly) * lx
            + img[np.ix_(y1, x0)] * ly * (1 - lx)
            + img[np.ix_(y1, x1)] * ly * lx
        )
        return v


def paste_masks(
    mask_probs: np.ndarray,
    boxes: np.ndarray,
    img_h: int,
    img_w: int,
    thr: float = 0.5,
) -> np.ndarray:
    """Paste (D, 28, 28) probabilities into (D, img_h, img_w) binaries.

    ``boxes`` are (D, 4) in the target image's coordinates.
    """
    D = mask_probs.shape[0]
    out = np.zeros((D, img_h, img_w), dtype=bool)
    for i in range(D):
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        x1i, y1i = max(x1i, 0), max(y1i, 0)
        x2i, y2i = min(x2i, img_w), min(y2i, img_h)
        if x2i <= x1i or y2i <= y1i:
            continue
        m = _bilinear_resize(mask_probs[i], y2i - y1i, x2i - x1i)
        out[i, y1i:y2i, x1i:x2i] = m >= thr
    return out


def normalize_gt_masks(
    bitmaps: np.ndarray, boxes: np.ndarray, size: int = 56
) -> np.ndarray:
    """Full-image instance bitmaps (G, H, W) → box-normalized crops
    (G, size, size) float32 — the static gt-mask format."""
    G = bitmaps.shape[0]
    H, W = bitmaps.shape[1:3]
    out = np.zeros((G, size, size), dtype=np.float32)
    for i in range(G):
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        x1i, y1i = max(x1i, 0), max(y1i, 0)
        x2i, y2i = min(max(x2i, x1i + 1), W), min(max(y2i, y1i + 1), H)
        crop = bitmaps[i, y1i:y2i, x1i:x2i].astype(np.float32)
        if crop.size == 0:
            continue
        out[i] = _bilinear_resize(crop, size, size)
    return out
