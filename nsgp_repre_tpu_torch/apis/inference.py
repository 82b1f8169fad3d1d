"""User-facing inference API.

Counterpart of nsgp_repre_tpu/apis/inference.py: ``Detector``,
``init_detector``, ``_pack_images`` and ``inference_detector``
(mmdet/apis/inference.py:26,122). ``DetInferencer`` and visualisation
wait (ROADMAP.md, "Predict options not ported").

The detector runs on ``cuda`` unless the caller passes a device. With
no device named and no CUDA device present, ``init_detector`` raises:
it never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..datasets.loader import _round_up, load_image, resize_keep_ratio
from ..engine.runner import detector_config_from_cfg
from ..engine.train import make_eval_step
from ..models.detector import FasterRCNN
from ..structures.sample import DetBatch, InstanceArray
from ..utils.checkpoint import load_checkpoint
from ..utils.config import Config, load_config
from ..utils.device import resolve_device


class Detector:
    """A model on its device plus its predict step."""

    def __init__(self, model: FasterRCNN, img_scale=(1000, 600), device="cuda"):
        self.model = model
        self.img_scale = img_scale
        self.device = torch.device(device)
        self._eval_step = make_eval_step(model)

    def predict_batch(self, batch: DetBatch) -> InstanceArray:
        return self._eval_step(batch)


def init_detector(
    config: Union[str, Config],
    checkpoint: Optional[str] = None,
    img_scale: Optional[Tuple[int, int]] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> Detector:
    """Build a detector from a config file (+ optional checkpoint).

    ``checkpoint`` is a reference mmdet ``.pth``/``.pt`` or a JAX ``.npz``
    (``params/...`` and ``batch_stats/...`` entries); without one the
    weights are a seeded random init.
    """
    dev = resolve_device(device)
    cfg = load_config(config) if isinstance(config, str) else config
    model = FasterRCNN(detector_config_from_cfg(cfg))
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint:
        load_checkpoint(model, checkpoint)
    model.to(dev).eval()
    scale = img_scale or tuple(cfg.get("img_scale", (1000, 600)))
    return Detector(model, scale, dev)


def _pack_images(detector: Detector, imgs: List[np.ndarray]) -> DetBatch:
    """Resize keep-ratio and pad each image onto one canvas, on the
    detector's device (uint8; the predict step normalizes)."""
    long_side, short_side = max(detector.img_scale), min(detector.img_scale)
    bw = _round_up(long_side)
    # square canvas when any image is portrait (inference.py:75-82)
    landscape = all(i.shape[1] >= i.shape[0] for i in imgs)
    bh = _round_up(short_side) if landscape else bw
    B = len(imgs)
    images = np.zeros((B, bh, bw, 3), np.uint8)
    img_shape = np.zeros((B, 2), np.int32)
    ori_shape = np.zeros((B, 2), np.int32)
    scale_factor = np.ones((B, 2), np.float32)
    for i, img in enumerate(imgs):
        resized, _, (ws, hs) = resize_keep_ratio(
            img, np.zeros((0, 4), np.float32), detector.img_scale
        )
        h, w = min(resized.shape[0], bh), min(resized.shape[1], bw)
        images[i, :h, :w] = resized[:h, :w]
        img_shape[i] = (h, w)
        ori_shape[i] = img.shape[:2]
        scale_factor[i] = (ws, hs)
    dev = detector.device
    cap = 1
    return DetBatch(
        images=torch.from_numpy(images).to(dev),
        img_shape=torch.from_numpy(img_shape).to(dev),
        ori_shape=torch.from_numpy(ori_shape).to(dev),
        scale_factor=torch.from_numpy(scale_factor).to(dev),
        gt=InstanceArray(
            boxes=torch.zeros((B, cap, 4), dtype=torch.float32, device=dev),
            labels=torch.full((B, cap), -1, dtype=torch.int32, device=dev),
            valid=torch.zeros((B, cap), dtype=torch.bool, device=dev),
        ),
    )


def inference_detector(
    detector: Detector,
    imgs: Union[str, np.ndarray, List[Union[str, np.ndarray]]],
    score_thr: float = 0.0,
) -> Union[dict, List[dict]]:
    """Run inference; returns dict(boxes, scores, labels) of numpy arrays
    per image in ORIGINAL image coordinates (rescale=True like the
    reference)."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    arrays = [load_image(i) if isinstance(i, str) else i for i in imgs]
    dets = detector.predict_batch(_pack_images(detector, arrays))
    boxes, scores = dets.boxes.cpu().numpy(), dets.scores.cpu().numpy()
    labels, valid = dets.labels.cpu().numpy(), dets.valid.cpu().numpy()
    out = []
    for i in range(len(arrays)):
        keep = valid[i] & (scores[i] >= score_thr)
        out.append(dict(boxes=boxes[i][keep], scores=scores[i][keep], labels=labels[i][keep]))
    return out[0] if single else out
