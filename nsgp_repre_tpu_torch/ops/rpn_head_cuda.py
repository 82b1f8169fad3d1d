"""Forward-only 3x3 conv and fused RPN head (kernels in csrc/conv3x3.cu).

Counterparts of nsgp_repre_tpu/ops/rpn_head_pallas.py: ``conv3x3_fused``
(FPN output convs at batch 1) and ``rpn_head_fused`` (3x3 conv + bias +
ReLU + one packed 1x1 matmul: A objectness logits then 4A deltas).

Both take the JAX package's NHWC layout and HWIO weights. On a CPU tensor
the wrapper runs the plain PyTorch version below; on a CUDA tensor it
launches the kernel or raises. Rounding: the f32 conv sum is rounded to
the map's dtype before the (rounded) bias is added, as at
rpn_head_pallas.py:135,148-149. The bf16 kernel reads its weight K-major,
in the layout :func:`conv_weight_kmajor` makes.

Both kernels are forward only. A call with grad mode on and an input
that requires grad raises, on either device: a gradient that silently
stops here would train the rest of the model on a wrong loss.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _ext

KSTEP = 64  # channels per K step of the bf16 kernel (csrc/conv3x3.cu BK)
HIDDEN_CHUNK = 256  # hidden channels per block of the fused head; F is a multiple of it
MAX_PACKED = 128  # packed 1x1 columns the fused head takes (the TPU kernel's lane padding)


def _conv3x3_plain(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool):
    """f (B,H,W,C), w (3,3,C,F) HWIO, b (F,) → (B,H,W,F) in f.dtype."""
    dt = f.dtype
    acc = F.conv2d(
        f.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), padding=1
    )
    h = acc.to(dt) + b.to(dt)[:, None, None]
    if relu:
        h = torch.relu(h)
    return h.permute(0, 2, 3, 1)


def conv3x3_plain(f, w, b, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the conv3x3 kernel."""
    return _conv3x3_plain(f, w, b, relu).contiguous()


def rpn_head_plain(f, w1, b1, wcr, bcr) -> torch.Tensor:
    """Plain PyTorch version of the fused RPN head kernel.

    f (B,H,W,C); w1 (3,3,C,F); b1 (F,); wcr (F,P) packed cls∥reg 1x1
    kernels; bcr (P,). Returns (B,H,W,P) in f.dtype.
    """
    dt = f.dtype
    h = _conv3x3_plain(f, w1, b1, relu=True)
    out = torch.matmul(h.float(), wcr.to(dt).float())
    return (out.to(dt) + bcr.to(dt)).contiguous()


def conv_weight_kmajor(w: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """HWIO (3,3,C,F) → K-major (F, 9*Cp) in ``dtype`` (default w's), the B
    operand of the bf16 kernel.

    Column k = (ky*3 + kx)*Cp + c holds w[ky, kx, c]; Cp is C rounded up
    to the kernel's 64-channel K step, and the columns c >= C are zero
    (the kernel's loads of those channels are zero-filled too). So
    ``im2col(f) @ conv_weight_kmajor(w).T`` is the conv, with im2col's
    rows ordered the same way.
    """
    C, Fo = w.shape[2], w.shape[3]
    Cp = -(-C // KSTEP) * KSTEP
    wk = (torch.empty if Cp == C else torch.zeros)((Fo, 3, 3, Cp), dtype=dtype or w.dtype,
                                                    device=w.device)
    wk[..., :C].copy_(w.permute(3, 0, 1, 2))
    return wk.reshape(Fo, 9 * Cp)


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward only (no backward kernel): call it under torch.no_grad() "
            "on inputs that do not require grad"
        )


def _launch(f, w, b, wcr: Optional[torch.Tensor], bcr: Optional[torch.Tensor],
            relu: bool, name: str) -> torch.Tensor:
    """Check the arguments, allocate the output and launch the kernel."""
    _ext.require_cuda(f, "f")
    B, H, W, C = f.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be (3,3,{C},F), got {tuple(w.shape)}")
    Fo = w.shape[3]
    if tuple(b.shape) != (Fo,):
        raise ValueError(f"b must be ({Fo},), got {tuple(b.shape)}")
    bf16 = f.dtype == torch.bfloat16
    # bf16: the tensor map needs 16-byte pixel rows and a 16-byte aligned base
    if C % (8 if bf16 else 16):
        raise ValueError(f"{name} kernel needs C % {8 if bf16 else 16} == 0, got C={C}")
    if bf16 and f.data_ptr() % 16:
        raise ValueError(f"{name} kernel loads the map by TMA: f must be 16-byte aligned")
    P = 0
    part = None
    if wcr is not None:
        P = wcr.shape[1]
        if Fo % HIDDEN_CHUNK:
            raise ValueError(f"{name} kernel takes the hidden width F in chunks of "
                             f"{HIDDEN_CHUNK}, got F={Fo}")
        if tuple(wcr.shape) != (Fo, P) or bcr is None or tuple(bcr.shape) != (P,):
            raise ValueError(f"wcr (F,P) / bcr (P,) mismatch: {tuple(wcr.shape)}, "
                             f"{None if bcr is None else tuple(bcr.shape)}")
        if not 0 < P <= MAX_PACKED:
            raise ValueError(f"{name} kernel packs 1 to {MAX_PACKED} 1x1 columns, got {P}")
        wcr = wcr.to(device=f.device, dtype=f.dtype).contiguous()
        bcr = bcr.to(device=f.device, dtype=torch.float32).contiguous()
        if Fo > HIDDEN_CHUNK:  # each chunk's f32 partial 1x1 sums, added by a second launch
            part = torch.empty((Fo // HIDDEN_CHUNK, B * H * W, P), device=f.device,
                               dtype=torch.float32)
    elif bf16 and Fo % 128:
        raise ValueError(f"{name} kernel needs F % 128 == 0 in bf16, got F={Fo}")
    w = w.to(device=f.device)
    w = conv_weight_kmajor(w, f.dtype) if bf16 else w.to(f.dtype).contiguous()
    b = b.to(device=f.device, dtype=torch.float32).contiguous()
    out = torch.empty((B, H, W, P or Fo), device=f.device, dtype=f.dtype)
    if out.numel():
        rc = _ext.lib().nsgp_conv3x3(
            f.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if wcr is None else wcr.data_ptr(), None if bcr is None else bcr.data_ptr(),
            None if part is None else part.data_ptr(),
            out.data_ptr(), B, H, W, C, Fo, P, int(relu), _ext.DTYPE_CODE[f.dtype],
            _ext.stream_ptr(f),
        )
        _ext.check(rc, name)
        _ext.LAUNCHES[name] += 1
    return out


def conv3x3(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """3x3/s1/p1 conv + bias (+ReLU) on an NHWC map; f32 accumulation."""
    _forward_only("conv3x3", f, w, b)
    if not f.is_cuda:
        return conv3x3_plain(f, w, b, relu)
    return _launch(f, w, b, None, None, relu, "conv3x3")


def rpn_head(f: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             wcr: torch.Tensor, bcr: torch.Tensor) -> torch.Tensor:
    """One level of the fused RPN head: (B,H,W,C) → (B,H,W,P). The card
    takes F a multiple of 256 (256 for the FPN head, 1024 and 2048 for the
    C4 and DC5 heads) and P <= 128; above F = 256 it is two launches (the
    chunks' partial 1x1 sums, then their sum in chunk order), counted as
    one call."""
    _forward_only("rpn_head", f, w1, b1, wcr, bcr)
    if not f.is_cuda:
        return rpn_head_plain(f, w1, b1, wcr, bcr)
    return _launch(f, w1, b1, wcr, bcr, True, "rpn_head")
