"""Benchmark utilities.

Counterpart of nsgp_repre_tpu/utils/benchmark.py (mmdet/utils/
benchmark.py): ``InferenceBenchmark`` (images/s of a detector's predict
over one batch, data loading excluded, model_zoo protocol
docs/en/model_zoo.md:13), ``DataLoaderBenchmark`` (batches and images
per second of a loader) and ``DatasetBenchmark`` (per-item pipeline rate,
benchmark.py:406). On the GPU the timed loop ends in
``torch.cuda.synchronize``, so it counts the work the card did, not the
launches queued.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class InferenceBenchmark:
    """Pure-inference images/s of ``detector.predict_batch`` on one batch
    (apis/inference.py::Detector)."""

    def __init__(self, detector, max_iter: int = 200, num_warmup: int = 5):
        self.detector = detector
        self.max_iter = max_iter
        self.num_warmup = num_warmup

    def run(self, batch) -> dict:
        B = batch.images.shape[0]
        out = None
        for _ in range(self.num_warmup):
            out = self.detector.predict_batch(batch)
        if out is not None:
            _sync(out.boxes)
        t0 = time.perf_counter()
        for _ in range(self.max_iter):
            out = self.detector.predict_batch(batch)
        _sync(out.boxes)
        dt = time.perf_counter() - t0
        fps = B * self.max_iter / dt
        return dict(fps=round(fps, 2), times_per_img_ms=round(1000.0 / fps, 3))


class DataLoaderBenchmark:
    """Host data-pipeline throughput (batches/s, images/s) of a loader
    that yields (batch, image ids)."""

    def __init__(self, loader, max_iter: Optional[int] = None):
        self.loader = loader
        self.max_iter = max_iter

    def run(self) -> dict:
        t0 = time.perf_counter()
        n_batches = 0
        n_imgs = 0
        for batch, ids in self.loader:
            n_batches += 1
            n_imgs += len(ids)
            if self.max_iter and n_batches >= self.max_iter:
                break
        dt = time.perf_counter() - t0
        return dict(batches_per_sec=round(n_batches / dt, 2), imgs_per_sec=round(n_imgs / dt, 2))


class DatasetBenchmark:
    """Per-item dataset pipeline rate (decode, resize, flip, pack), no
    batching: times ``dataset[idx]`` over shuffled indices after a
    warm-up (benchmark.py:406)."""

    def __init__(self, dataset, max_iter: int = 2000, num_warmup: int = 5,
                 shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.max_iter = max_iter
        self.num_warmup = num_warmup
        self.shuffle = shuffle
        self.seed = seed

    def run(self) -> dict:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(idx)
        total = min(self.max_iter + self.num_warmup, n)
        for i in range(min(self.num_warmup, total)):
            self.dataset[int(idx[i])]
        t0 = time.perf_counter()
        count = 0
        for i in range(self.num_warmup, total):
            self.dataset[int(idx[i])]
            count += 1
        dt = max(time.perf_counter() - t0, 1e-9)
        return dict(items_per_sec=round(count / dt, 2),
                    ms_per_item=round(1000.0 * dt / max(count, 1), 6))
