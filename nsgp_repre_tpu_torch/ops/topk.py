"""Exact top-k with JAX's tie order.

Counterpart of nsgp_repre_tpu/ops/topk.py::fast_top_k in its exact mode
(``approx=False``). ``jax.lax.top_k`` returns equal values lowest index
first; ``torch.topk`` promises no order among ties, and bf16 RPN logits
tie often. A stable descending sort keeps the lowest index first. The
approximate mode of the JAX function exists only on the TPU.
"""
from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, ties → lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
