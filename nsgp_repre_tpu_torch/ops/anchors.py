"""Static anchor generation.

Parity target: mmdet AnchorGenerator
(mmdet/models/task_modules/prior_generators/anchor_generator.py:18) with
the Faster R-CNN RPN settings ``scales=[8], ratios=[0.5, 1, 2],
strides=[4, 8, 16, 32, 64]``. A verbatim numpy copy of
nsgp_repre_tpu/ops/anchors.py; the detector moves the anchors to its
device once per feature-map shape.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class AnchorGenerator:
    """Per-level grid anchors, corner format, centered mmdet-style.

    mmdet uses ``center_offset=0``: the base anchor for stride ``s`` is
    centered at (0, 0) and shifted by ``(x*s, y*s)`` over the grid.
    """

    def __init__(
        self,
        strides: Sequence[int] = (4, 8, 16, 32, 64),
        ratios: Sequence[float] = (0.5, 1.0, 2.0),
        scales: Sequence[float] = (8.0,),
        center_offset: float = 0.0,
    ):
        self.strides = list(strides)
        self.ratios = np.asarray(ratios, dtype=np.float32)
        self.scales = np.asarray(scales, dtype=np.float32)
        self.center_offset = center_offset
        self.base_anchors = [self._base_anchors(s) for s in self.strides]

    @property
    def num_base_priors(self) -> int:
        return len(self.ratios) * len(self.scales)

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def _base_anchors(self, stride: int) -> np.ndarray:
        w = h = float(stride)
        cx = self.center_offset * w
        cy = self.center_offset * h
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        # mmdet ordering: (ratios outer loop? actually scales inner) —
        # ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack(
            [cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs],
            axis=-1,
        ).astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """Anchors for each level.

        Args:
            featmap_sizes: list of (h, w) per level.
        Returns:
            list of (h*w*num_base, 4) float32 arrays.
        """
        assert len(featmap_sizes) == self.num_levels
        out = []
        for (fh, fw), stride, base in zip(featmap_sizes, self.strides, self.base_anchors):
            sx = np.arange(fw, dtype=np.float32) * stride
            sy = np.arange(fh, dtype=np.float32) * stride
            shift_x, shift_y = np.meshgrid(sx, sy)  # (fh, fw)
            shifts = np.stack(
                [shift_x, shift_y, shift_x, shift_y], axis=-1
            ).reshape(-1, 1, 4)
            anchors = (shifts + base[None, :, :]).reshape(-1, 4)
            out.append(anchors.astype(np.float32))
        return out

    def valid_flags(
        self,
        featmap_sizes: Sequence[Tuple[int, int]],
        pad_shape: Tuple[int, int],
    ) -> List[np.ndarray]:
        """Which anchor centers lie inside the (unpadded) image region."""
        out = []
        for (fh, fw), stride in zip(featmap_sizes, self.strides):
            vh = min(int(np.ceil(pad_shape[0] / stride)), fh)
            vw = min(int(np.ceil(pad_shape[1] / stride)), fw)
            fy = np.zeros(fh, dtype=bool)
            fx = np.zeros(fw, dtype=bool)
            fy[:vh] = True
            fx[:vw] = True
            flags = (fy[:, None] & fx[None, :]).reshape(-1, 1)
            out.append(np.repeat(flags, self.num_base_priors, axis=1).reshape(-1))
        return out
