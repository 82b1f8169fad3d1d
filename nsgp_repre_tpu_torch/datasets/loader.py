"""Host-side image loading and keep-ratio resizing.

Counterpart of nsgp_repre_tpu/datasets/loader.py: ``load_image``,
``resize_keep_ratio`` and ``_round_up``. The training data pipeline
waits for queue 1, item 8 (ROADMAP.md). Decoding and resizing use cv2
when it is installed, else PIL; an image already at its target size is
returned as it is.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 HWC (bgr_to_rgb=True in the preprocessor cfg)."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _resize(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    if img.shape[:2] == (new_h, new_w):
        return img
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((new_w, new_h)))
    return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)


def resize_keep_ratio(
    img: np.ndarray, boxes: np.ndarray, scale: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray, Tuple[float, float]]:
    """mmdet Resize(keep_ratio=True): scale=(long, short) max bounds."""
    h, w = img.shape[:2]
    long_side, short_side = max(scale), min(scale)
    factor = min(long_side / max(h, w), short_side / min(h, w))
    new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
    out = _resize(img, new_w, new_h)
    w_scale, h_scale = new_w / w, new_h / h
    if len(boxes):
        boxes = boxes * np.array([w_scale, h_scale, w_scale, h_scale], np.float32)
    return out, boxes, (w_scale, h_scale)


def _round_up(x: int, m: int = 32) -> int:
    return int(math.ceil(x / m) * m)
