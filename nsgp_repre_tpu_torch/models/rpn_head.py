"""RPN head: shared 3x3 conv + ReLU, 1x1 objectness and 1x1 deltas.

Counterpart of nsgp_repre_tpu/models/rpn_head.py (``__call__``,
``_fused`` and ``at_positions``). Module names follow mmdet
(``rpn_conv``, ``rpn_cls``, ``rpn_reg``). Inputs and outputs are NHWC,
as in the JAX package.

``_fused`` runs the forward-only RPN head kernel: on predict and on the
sparse-loss train path, where the dense head only feeds the proposals
(data, no gradient). ``at_positions`` evaluates the same three layers at
gathered 3x3 patches for the sparse RPN loss; gradients reach the
weights and the features through it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.rpn_head_cuda import rpn_head
from .layers import CovConv, nchw, nhwc


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256, num_base_priors: int = 3):
        super().__init__()
        self.num_base_priors = num_base_priors
        self.feat_channels = feat_channels
        self.rpn_conv = CovConv(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = CovConv(feat_channels, num_base_priors, 1)
        self.rpn_reg = CovConv(feat_channels, num_base_priors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor], fused: bool = False
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """NHWC levels → per-level (cls (B,H,W,A), deltas (B,H,W,4A)).

        ``fused=True`` (inference only) runs the fused RPN head kernel,
        one launch per level (plain version for CPU tensors)."""
        if fused:
            return self._fused(feats)
        cls_out, reg_out = [], []
        for f in feats:
            y = torch.relu(self.rpn_conv(nchw(f)))
            cls_out.append(nhwc(self.rpn_cls(y)))
            reg_out.append(nhwc(self.rpn_reg(y)))
        return cls_out, reg_out

    def packed_1x1(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(F, 5A) packed cls∥reg kernel and (5A,) bias. The TPU kernel pads
        these to 128 lanes (rpn_head.py:85-91); the CUDA kernel does not."""
        A, Fc = self.num_base_priors, self.feat_channels
        wcr = torch.cat([self.rpn_cls.weight.reshape(A, Fc), self.rpn_reg.weight.reshape(4 * A, Fc)]).t()
        bcr = torch.cat([self.rpn_cls.bias, self.rpn_reg.bias])
        return wcr, bcr

    @torch.no_grad()
    def _fused(self, feats):
        """The forward-only kernel on detached inputs: its outputs carry no
        gradient (rpn_head.py:92-95 in JAX stops it the same way)."""
        A = self.num_base_priors
        w1 = self.rpn_conv.weight.detach().permute(2, 3, 1, 0)  # HWIO
        wcr, bcr = (t.detach() for t in self.packed_1x1())
        cls_out, reg_out = [], []
        for f in feats:
            out = rpn_head(f.detach().contiguous(), w1, self.rpn_conv.bias.detach(), wcr, bcr)
            cls_out.append(out[..., :A])
            reg_out.append(out[..., A:5 * A])
        return cls_out, reg_out

    def at_positions(self, patches: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Head outputs at gathered patches (rpn_head.py:100-127).

        patches: (M, 3, 3, C) input windows centred on the sampled output
        positions, taps outside the map zeroed by the caller (the dense
        conv's zero padding). Returns cls logits (M, A) and deltas
        (M, 4A) in the patch dtype, rounded where JAX rounds: the kernels
        are cast to the patch dtype, each matmul is done in that dtype and
        the bias is added in it.
        """
        dt = patches.dtype
        M = patches.shape[0]
        k = self.rpn_conv.weight.to(dt).permute(2, 3, 1, 0)  # (3, 3, C, F) as in JAX
        h = patches.reshape(M, -1) @ k.reshape(-1, k.shape[-1])
        h = torch.relu(h + self.rpn_conv.bias.to(dt))
        Fc = h.shape[-1]
        cls = h @ self.rpn_cls.weight.reshape(-1, Fc).t().to(dt)
        cls = cls + self.rpn_cls.bias.to(dt)
        reg = h @ self.rpn_reg.weight.reshape(-1, Fc).t().to(dt)
        reg = reg + self.rpn_reg.bias.to(dt)
        return cls, reg
