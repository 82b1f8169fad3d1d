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
the (rounded) bias is added.

Covariance taps (layers.py:92-96, :237-242 in JAX; the reference's
forward hooks, nsrunner_roi_replay.py:876-916): while a
:class:`CovCollector` is entered, every ``CovConv`` and ``CovDense`` of
its model adds the covariance of its batch-mean input to the collector,
summed over calls. A conv's input is unfolded into (c, kh, kw) patches
(``F.unfold``'s order, the rows of the (O, I·kh·kw) weight); a linear
layer's is a rank-1 outer product. With no collector a layer pays one
attribute test. Under data parallel (parallel/mesh.py) the batch mean is
averaged over the ranks before the outer product, which gives the global
batch's mean because every rank's tapped tensor has the same leading size
(engine/train.py::make_cov_step checks the batch's); the sums are not
reduced afterwards.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.rpn_head_cuda import conv3x3
from ..parallel.mesh import all_reduce_mean
from ..utils.convert import jax_path_from_port


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

    cov_tap = None  # set by CovCollector while it is entered

    def input_cov(self, x: torch.Tensor) -> torch.Tensor:
        """(I·kh·kw)² covariance of the batch-mean input's patches, f32;
        the mean is the global batch's under data parallel."""
        xm = all_reduce_mean(x.float().mean(dim=0, keepdim=True))
        p = F.unfold(xm, self.kernel_size, self.dilation, self.padding, self.stride)[0]
        return p @ p.T

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        if self.cov_tap is not None:
            self.cov_tap(self, self.input_cov(x))
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

    cov_tap = None  # set by CovCollector while it is entered

    def input_cov(self, x: torch.Tensor) -> torch.Tensor:
        """in² outer product of the batch-mean input row, f32; the mean is
        the global batch's under data parallel."""
        xm = all_reduce_mean(x.float().mean(dim=0, keepdim=True))
        return xm.T @ xm

    def forward(self, x: torch.Tensor, row_chw=None) -> torch.Tensor:
        if self.cov_tap is not None:
            if row_chw is not None:
                raise ValueError("the covariance tap takes the torch-order input path")
            self.cov_tap(self, self.input_cov(x))
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


class CovCollector:
    """The covariance pass's collector (JAX's mutable ``'cov'``
    collection): ``with CovCollector(detector) as cov:`` taps every
    ``CovConv``/``CovDense`` of ``model`` until the block ends, and
    ``cov.result()`` gives the sums keyed as JAX's
    ``cov_collection_to_param_names`` keys them (``backbone/layer2_0/conv1/kernel``).
    While it is entered the RPN head takes its unfused path and the bbox
    head its torch-order path, as in JAX, so that every layer sees the
    input the JAX layer sees."""

    def __init__(self, model: nn.Module):
        self.layers = {m: name for name, m in model.named_modules()
                       if isinstance(m, (CovConv, CovDense))}
        self.n_tasks = len(model.config.task_split) - 1  # places the background classifier
        self.sums: Dict[nn.Module, torch.Tensor] = {}

    def _add(self, layer: nn.Module, cov: torch.Tensor) -> None:
        self.sums[layer] = cov if layer not in self.sums else self.sums[layer] + cov

    def __enter__(self) -> "CovCollector":
        for m in self.layers:
            m.cov_tap = self._add
        return self

    def __exit__(self, *exc) -> None:
        for m in self.layers:
            del m.cov_tap

    def result(self) -> Dict[str, torch.Tensor]:
        return {jax_path_from_port(f"{self.layers[m]}.weight", self.n_tasks): c
                for m, c in self.sums.items()}
