"""Host-side data pipeline → fixed-shape batches of CPU tensors.

Counterpart of nsgp_repre_tpu/datasets/loader.py (the mmdet pipeline:
LoadImageFromFile / LoadAnnotations / Resize(keep_ratio) /
RandomFlip(0.5) / Pad / PackDetInputs plus AspectRatioBatchSampler).
Every image lands on one of two canvases, landscape (H_s, W_l) or
portrait, and a batch holds one canvas; the batch plan (record order,
buckets, flips) is JAX's, so the same dataset and seed give the same
ids, flips and pixels in both packages. Batches are the port's
:class:`DetBatch` of CPU tensors; datasets/prefetch.py moves them to the
device. Normalization happens on the device (engine/train.py).

Decoding and resizing use cv2 when it is installed, else PIL; an image
already at its target size is returned as it is.
"""
from __future__ import annotations

import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..structures.sample import DetBatch, InstanceArray


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


def flip_horizontal(img: np.ndarray, boxes: np.ndarray):
    img = img[:, ::-1]
    w = img.shape[1]
    if len(boxes):
        boxes = boxes.copy()
        x1 = w - boxes[:, 2]
        x2 = w - boxes[:, 0]
        boxes[:, 0], boxes[:, 2] = x1, x2
    return img, boxes


def _round_up(x: int, m: int = 32) -> int:
    return int(math.ceil(x / m) * m)


# Shared decode pool: cv2 decode/resize and numpy copies release the GIL,
# so threads overlap the per-image work without worker processes.
_DECODE_POOL: Optional[ThreadPoolExecutor] = None
_DECODE_POOL_LOCK = threading.Lock()


def _decode_pool() -> ThreadPoolExecutor:
    global _DECODE_POOL
    if _DECODE_POOL is None:
        with _DECODE_POOL_LOCK:  # train/val prefetch workers race here
            if _DECODE_POOL is None:
                n = max(1, int(os.environ.get("NSGP_DECODE_THREADS", "16")))
                _DECODE_POOL = ThreadPoolExecutor(max_workers=n)
    return _DECODE_POOL


class BatchMeta(list):
    """The batch's ``img_ids`` plus the per-image ``flips``, so the
    teacher pseudo-label cache can key on ``(img_id, flip)``
    (engine/runner.py, ``teacher_label_cache``)."""

    def __init__(self, ids, flips):
        super().__init__(ids)
        self.flips = list(flips)


class DetLoader:
    """Batches a dataset into fixed-shape :class:`DetBatch` es of CPU tensors.

    Args:
        scale: mmdet resize scale, e.g. (1000, 600) VOC / (1333, 800) COCO.
        training: shuffle (``RandomState(seed + epoch)``), random flips,
            ``repeat`` and ``drop_last``; otherwise one pass in order.
        force_flip: overrides every record's flip decision (the teacher
            pseudo-label pre-pass enumerates both variants); the random
            draw is still consumed, so the plan is unchanged.
        num_shards, shard_id: data-parallel loading (JAX's, loader.py:127-146).
            ``batch_size`` stays the global batch; every process runs the
            same seeded plan (records, buckets, flips) and decodes only its
            contiguous ``local_batch = batch_size / num_shards`` rows of
            each batch, shard ``shard_id``. The ``BatchMeta`` ids and flips
            stay global. A last partial batch is padded to ``local_batch``
            on every shard, so a shard whose rows are all past its end
            still yields a batch (zero images, no gt) and joins the
            collectives.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        scale: Tuple[int, int] = (1000, 600),
        training: bool = True,
        gt_capacity: int = 100,
        flip_prob: float = 0.5,
        repeat: int = 1,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        num_shards: int = 1,
        shard_id: int = 0,
        force_flip: Optional[bool] = None,
    ):
        if batch_size % num_shards or not 0 <= shard_id < num_shards:
            raise ValueError(f"batch {batch_size} over {num_shards} shards, shard {shard_id}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.local_batch = batch_size // num_shards
        self.training = training
        self.gt_capacity = gt_capacity
        self.flip_prob = flip_prob if training else 0.0
        self.repeat = repeat if training else 1
        self.seed = seed
        self.epoch = 0
        self.drop_last = training if drop_last is None else drop_last
        self.force_flip = force_flip
        long_side, short_side = max(scale), min(scale)
        # fixed canvases: landscape (short, long), portrait (long, short)
        self.canvas = {
            "landscape": (_round_up(short_side), _round_up(long_side)),
            "portrait": (_round_up(long_side), _round_up(short_side)),
        }
        self.scale = scale

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) * self.repeat
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def _bucket_of(self, rec) -> str:
        return "landscape" if rec["width"] >= rec["height"] else "portrait"

    def _make_batch(self, items: List[tuple], bucket: str) -> DetBatch:
        """items: [(rec, flip)], this shard's rows of one batch; unused
        slots of a partial last batch stay zero images with no gt."""
        bh, bw = self.canvas[bucket]
        B = self.local_batch
        images = np.zeros((B, bh, bw, 3), np.uint8)
        img_shape = np.zeros((B, 2), np.int32)
        ori_shape = np.zeros((B, 2), np.int32)
        scale_factor = np.ones((B, 2), np.float32)
        boxes = np.zeros((B, self.gt_capacity, 4), np.float32)
        labels = np.full((B, self.gt_capacity), -1, np.int32)
        valid = np.zeros((B, self.gt_capacity), bool)

        def _one(i: int, rec, flip: bool):
            img = load_image(rec["img_path"])
            b = rec["boxes"].copy()
            img, b, (ws, hs) = resize_keep_ratio(img, b, self.scale)
            if flip:
                img, b = flip_horizontal(img, b)
            h, w = img.shape[:2]
            images[i, :h, :w] = img
            img_shape[i] = (h, w)
            ori_shape[i] = (rec["height"], rec["width"])
            scale_factor[i] = (ws, hs)
            n = min(len(b), self.gt_capacity)
            boxes[i, :n] = b[:n]
            labels[i, :n] = rec["labels"][:n]
            valid[i, :n] = True

        # each task writes its own row i: no aliasing between tasks
        list(_decode_pool().map(lambda t: _one(*t),
                                [(i, rec, flip) for i, (rec, flip) in enumerate(items)]))
        t = torch.from_numpy
        return DetBatch(
            images=t(images), img_shape=t(img_shape), ori_shape=t(ori_shape),
            scale_factor=t(scale_factor),
            gt=InstanceArray(boxes=t(boxes), labels=t(labels), valid=t(valid)),
        )

    def _emit(self, items: List[tuple], bucket: str):
        """This shard's rows of the planned batch ``items``, and the global ids."""
        ids = BatchMeta([rec["img_id"] for rec, _ in items], [f for _, f in items])
        lo = self.shard_id * self.local_batch
        return self._make_batch(items[lo:lo + self.local_batch], bucket), ids

    def __iter__(self) -> Iterator[Tuple[DetBatch, BatchMeta]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        order = np.concatenate([np.arange(len(self.dataset)) for _ in range(self.repeat)])
        if self.training:
            rng.shuffle(order)
        buckets: dict = {"landscape": [], "portrait": []}
        for idx in order:
            rec = self.dataset[int(idx)]
            # consumed whatever force_flip says, so the plan is unchanged
            r = rng.rand()
            flip = (self.force_flip if self.force_flip is not None
                    else bool(self.training and r < self.flip_prob))
            b = self._bucket_of(rec)
            buckets[b].append((rec, flip))
            if len(buckets[b]) == self.batch_size:
                yield self._emit(buckets[b], b)
                buckets[b] = []
        if not self.drop_last:
            for b, items in buckets.items():
                if items:
                    yield self._emit(items, b)
