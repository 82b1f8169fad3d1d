"""Building-block layers.

Counterpart of nsgp_repre_tpu/models/layers.py. Parameters keep mmdet /
torchvision names and layouts (conv weights (O, I, kh, kw), linear
weights (out, in)) so a reference state dict loads with
``load_state_dict``. Feature maps are NCHW tensors in ``channels_last``
memory, so ``x.permute(0, 2, 3, 1)`` is the contiguous NHWC map the
kernels take.

Every layer computes in the dtype of its input (the detector's compute
dtype) with f32 parameters cast at use, and rounds where the JAX layers
round: the conv or matmul result is rounded to the compute dtype before
the (rounded) bias is added. The covariance taps of the JAX layers feed
the NSGP covariance pass of slice (c) (ROADMAP.md, queue 1) and are not
ported yet; the training step of slice (b) does not need them.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.rpn_head_cuda import conv3x3


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) → NHWC view."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


class CovConv(nn.Conv2d):
    """2D conv with the JAX package's rounding points and a fused path.

    ``fused=True`` (inference only) evaluates a 3x3/s1/p1 conv with the
    hand-written conv3x3 kernel (plain version on CPU tensors), as
    CovConv's forward-only fused path does in JAX (layers.py:105-132).
    """

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        dt = x.dtype
        if (
            fused
            and self.kernel_size == (3, 3)
            and self.stride == (1, 1)
            and self.padding == (1, 1)
            and self.dilation == (1, 1)
            and self.groups == 1
        ):
            bias = self.bias if self.bias is not None else self.weight.new_zeros(self.out_channels)
            w = self.weight.permute(2, 3, 1, 0)  # HWIO
            return nchw(conv3x3(nhwc(x).contiguous(), w, bias))
        y = F.conv2d(x, self.weight.to(dt), None, self.stride, self.padding, self.dilation,
                     self.groups)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


class CovDense(nn.Linear):
    """Linear layer in the input's dtype; ``row_chw=(C, H, W)`` takes an
    NHWC-flattened input and permutes the weight's input columns from
    torch's (C, H, W) order instead of transposing the activation
    (layers.py:228-253)."""

    def forward(self, x: torch.Tensor, row_chw=None) -> torch.Tensor:
        w = self.weight
        if row_chw is not None:
            c, h, ww = row_chw
            w = w.reshape(self.out_features, c, h, ww).permute(0, 2, 3, 1).reshape(
                self.out_features, -1)
        y = F.linear(x, w.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class FrozenBatchNorm(nn.Module):
    """BatchNorm in permanent eval mode (mmdet ``norm_eval=True``) with the
    JAX rounding points (layers.py:284-285): ``inv = rsqrt(var + eps) *
    scale`` in f32, then ``x * inv + (bias - mean * inv)`` with both
    factors rounded to the input dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
