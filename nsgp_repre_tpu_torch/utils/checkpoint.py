"""Checkpoint I/O shared with the JAX package.

Counterpart of nsgp_repre_tpu/utils/checkpoint.py, holding only
``load_pytree_flat``: a JAX ``.npz`` checkpoint is a flat dict keyed by
'/'-joined pytree paths (``params/backbone/conv1/kernel``,
``batch_stats/backbone/bn1/mean``). The artifact files wait for slice
(d) (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def load_pytree_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
