"""Plain PyTorch reference of the two-stage detectors the benchmark runs.

Faster R-CNN R-50-FPN with the NSGP-RePRE task-2 terms (teacher
pseudo-labels, prototype replay, EWC, the null-space-projected SGD step)
and Mask R-CNN R-50-FPN, written from mmdet's published description as
functions of one dict of float32 tensors keyed by mmdet's parameter names.
It imports nothing of the program under test: no kernel, no cache, no
batching beyond the batch itself.

Every matrix product and convolution takes its operands, and every layer
(convolution, product, frozen BN, residual and pyramid sum) its output,
through ``lp``: the identity for the reference proper (float32, TF32
off), or a fake-quantiser for the control (:func:`fp8`), which computes
the same network as the program computes it in bf16, with float8 in
bf16's place: activations stored in e4m3 between layers, their
gradients in e5m2, products accumulated in f32.

Semantics followed where mmdet leaves a choice open, as the configs
state them: static shapes (``rpn_max_per_img`` proposals, ``rcnn_num``
sampled RoIs and ``max_per_img`` detections per image, padded, with
validity masks); sampling decided by given uniform priorities (a prior
is sampled iff its priority clears the k-th largest of its pool, the
RoIs gathered in priority order); greedy NMS with ties to the lowest
index and a per-image coordinate offset per class or level; RoIAlign
``aligned=True`` with a 2x2 sample grid; frozen BatchNorm.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
NEG, IGNORE = -1, -2
BIG = 1.0e6
NEG_SCORE = -1.0e10


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to a float8 type with one per-tensor scale (amax to its largest
    finite value), back in f32."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).to(torch.float32) * s


class _FP8(torch.autograd.Function):
    """fp8 training's rounding: operands in e4m3 going forward, their
    gradients in e5m2 coming back."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


@contextlib.contextmanager
def no_tf32():
    """Exact float32 products on the card while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def conv(P: Params, name: str, x, lp, stride=1, padding=0, bias=True):
    w = P[name + ".weight"]
    b = P.get(name + ".bias") if bias else None
    return lp(F.conv2d(lp(x), lp(w), b, stride, padding))


def linear(P: Params, name: str, x, lp):
    return lp(F.linear(lp(x), lp(P[name + ".weight"]), P[name + ".bias"]))


def frozen_bn(P: Params, name: str, x):
    inv = torch.rsqrt(P[name + ".running_var"] + 1e-5) * P[name + ".weight"]
    shift = P[name + ".bias"] - P[name + ".running_mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def backbone(P: Params, cfg: dict, x, lp, bn=frozen_bn):
    """ResNet-50 'pytorch' style (stride in the 3x3), frozen BN; the
    outputs of the four stages. ``frozen_stages`` cuts the gradient after
    the last frozen stage."""
    y = torch.relu(lp(bn(P, "backbone.bn1", conv(P, "backbone.conv1", x, lp, 2, 3, False))))
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    outs = []
    for s, n in enumerate(cfg["backbone_blocks"]):
        for b in range(n):
            p = f"backbone.layer{s + 1}.{b}"
            stride = 2 if (b == 0 and s > 0) else 1
            z = torch.relu(lp(bn(P, p + ".bn1", conv(P, p + ".conv1", y, lp, bias=False))))
            z = torch.relu(lp(bn(P, p + ".bn2", conv(P, p + ".conv2", z, lp, stride, 1, False))))
            z = lp(bn(P, p + ".bn3", conv(P, p + ".conv3", z, lp, bias=False)))
            idn = y if b > 0 else lp(bn(P, p + ".downsample.1",
                                        conv(P, p + ".downsample.0", y, lp, stride, bias=False)))
            y = torch.relu(lp(z + idn))
        if s + 1 == cfg["frozen_stages"]:
            y = y.detach()
        outs.append(y)
    return outs


def fpn(P: Params, feats, lp):
    """Laterals, nearest 2x top-down (cropped), 3x3 outputs, P6 = P5[::2, ::2]."""
    lat = [conv(P, f"neck.lateral_convs.{i}.conv", f, lp) for i, f in enumerate(feats)]
    for i in range(len(lat) - 1, 0, -1):
        h, w = lat[i - 1].shape[2:]
        lat[i - 1] = lp(lat[i - 1] + F.interpolate(lat[i], scale_factor=2, mode="nearest")[:, :, :h, :w])
    outs = [conv(P, f"neck.fpn_convs.{i}.conv", l, lp, padding=1) for i, l in enumerate(lat)]
    outs.append(outs[-1][:, :, ::2, ::2])
    return outs


def extract(P: Params, cfg: dict, images_u8, lp):
    mean = torch.tensor(cfg["pixel_mean"], device=images_u8.device)
    std = torch.tensor(cfg["pixel_std"], device=images_u8.device)
    x = ((images_u8.float() - mean) / std).permute(0, 3, 1, 2).contiguous()
    return fpn(P, backbone(P, cfg, x, lp), lp)


def rpn_head(P: Params, feats, lp):
    """Per level (B, H*W*A) logits and (B, H*W*A, 4) deltas, anchors fastest."""
    cls, reg = [], []
    for f in feats:
        y = torch.relu(conv(P, "rpn_head.rpn_conv", f, lp, padding=1))
        c = conv(P, "rpn_head.rpn_cls", y, lp)
        r = conv(P, "rpn_head.rpn_reg", y, lp)
        B = f.shape[0]
        cls.append(c.permute(0, 2, 3, 1).reshape(B, -1))
        reg.append(r.permute(0, 2, 3, 1).reshape(B, -1, 4))
    return cls, reg


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def anchors(cfg: dict, sizes, device) -> torch.Tensor:
    """mmdet grid anchors, centre offset 0, level by level, (y, x, a) order."""
    out = []
    ratios = np.asarray(cfg["anchor_ratios"], np.float32)
    scales = np.asarray(cfg["anchor_scales"], np.float32)
    for (fh, fw), s in zip(sizes, cfg["anchor_strides"]):
        hr = np.sqrt(ratios)
        wr = np.float32(1.0) / hr
        ws = (float(s) * wr[:, None] * scales[None, :]).reshape(-1)
        hs = (float(s) * hr[:, None] * scales[None, :]).reshape(-1)
        base = np.stack([0.0 - 0.5 * ws, 0.0 - 0.5 * hs, 0.0 + 0.5 * ws, 0.0 + 0.5 * hs], -1)
        sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * s, np.arange(fh, dtype=np.float32) * s)
        shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
        out.append((shifts + base.astype(np.float32)[None]).reshape(-1, 4).astype(np.float32))
    return torch.from_numpy(np.concatenate(out)).to(device)


def anchor_valid(cfg: dict, sizes, img_shape) -> torch.Tensor:
    A = len(cfg["anchor_ratios"]) * len(cfg["anchor_scales"])
    shape = img_shape.float()
    div = float(cfg["pad_size_divisor"])
    ph = (torch.ceil(shape[:, 0] / div) * div)[:, None, None]
    pw = (torch.ceil(shape[:, 1] / div) * div)[:, None, None]
    out = []
    for (fh, fw), s in zip(sizes, cfg["anchor_strides"]):
        gy = torch.arange(fh, device=shape.device)[None, :, None]
        gx = torch.arange(fw, device=shape.device)[None, None, :]
        f = (gy < torch.ceil(ph / s)) & (gx < torch.ceil(pw / s))
        out.append(f.reshape(shape.shape[0], -1).repeat_interleave(A, dim=1))
    return torch.cat(out, 1)


def iou(b1, b2, eps=1e-6):
    """(..., M, 4) x (..., N, 4) -> (..., M, N) IoU."""
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    rb = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(a1[..., :, None] + a2[..., None, :] - inter, min=eps)


def encode(p, g, stds=(1.0, 1.0, 1.0, 1.0), eps=1e-6):
    px, py = (p[..., 0] + p[..., 2]) * 0.5, (p[..., 1] + p[..., 3]) * 0.5
    pw = torch.clamp(p[..., 2] - p[..., 0], min=eps)
    ph = torch.clamp(p[..., 3] - p[..., 1], min=eps)
    gx, gy = (g[..., 0] + g[..., 2]) * 0.5, (g[..., 1] + g[..., 3]) * 0.5
    gw, gh = g[..., 2] - g[..., 0], g[..., 3] - g[..., 1]
    d = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(torch.clamp(gw, min=eps) / pw),
                     torch.log(torch.clamp(gh, min=eps) / ph)], -1)
    return d / d.new_tensor(stds)


def decode(rois, deltas, stds=(1.0, 1.0, 1.0, 1.0), max_hw=None):
    """deltas (..., K*4) against rois (..., 4) -> (..., K*4), clipped to max_hw."""
    k = deltas.shape[-1] // 4
    d = deltas.reshape(deltas.shape[:-1] + (k, 4)) * deltas.new_tensor(stds)
    r = abs(math.log(16.0 / 1000.0))
    dw, dh = torch.clamp(d[..., 2], -r, r), torch.clamp(d[..., 3], -r, r)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gx, gy = px + pw * d[..., 0], py + ph * d[..., 1]
    gw, gh = pw * torch.exp(dw), ph * torch.exp(dh)
    b = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], -1)
    if max_hw is not None:
        h, w = max_hw
        zero = torch.zeros((), device=b.device)
        b = torch.stack([torch.minimum(torch.maximum(b[..., 0], zero), w),
                         torch.minimum(torch.maximum(b[..., 1], zero), h),
                         torch.minimum(torch.maximum(b[..., 2], zero), w),
                         torch.minimum(torch.maximum(b[..., 3], zero), h)], -1)
    return b.reshape(deltas.shape)


def top_k(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# NMS: greedy, ties to the lowest index, IoU > thr suppresses
# ---------------------------------------------------------------------------

def pair_iou(a, b, eps=1e-6):
    """a (M, 4) against b (N, 4) -> (M, N), the greedy walk's IoU."""
    a = a[:, None, :]
    aa = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    ab = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    return inter / torch.clamp(aa + ab - inter, min=eps)


def nms(boxes, scores, groups, valid, thr: float, max_out: int):
    """Per image: offset each group to its own region, sort the valid boxes
    by score (stable), build the suppression bits on the device and walk
    them on the host. Returns keep indices (B, max_out) int64 and validity."""
    B = boxes.shape[0]
    dev = boxes.device
    boxes = boxes.float()
    masked = torch.where(valid[..., None], boxes, torch.zeros((), device=dev))
    shift = (masked.amax(dim=(1, 2)) + 1.0)[:, None] * groups.float()
    boxes = boxes + shift[..., None]
    keep = torch.zeros((B, max_out), dtype=torch.int64)
    kv = torch.zeros((B, max_out), dtype=torch.bool)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=dev)
    for b in range(B):
        idx = torch.nonzero(valid[b]).flatten()
        if idx.numel() == 0:
            continue
        order = idx[torch.sort(scores[b, idx].float(), descending=True, stable=True)[1]]
        bx = boxes[b, order]
        n = bx.shape[0]
        n8 = (n + 7) // 8
        bits = torch.empty((n, n8), dtype=torch.uint8, device=dev)
        for r0 in range(0, n, 2048):
            m = pair_iou(bx[r0:r0 + 2048], bx) > thr
            m = F.pad(m, (0, n8 * 8 - n)).reshape(m.shape[0], n8, 8)
            bits[r0:r0 + 2048] = (m.to(torch.uint8) * weights).sum(-1, dtype=torch.uint8)
        bits = bits.cpu().numpy()
        order = order.cpu().numpy()
        removed = np.zeros(n8, np.uint8)
        k = 0
        for i in range(n):
            if (removed[i >> 3] >> (i & 7)) & 1:
                continue
            keep[b, k] = int(order[i])
            kv[b, k] = True
            k += 1
            if k == max_out:
                break
            removed |= bits[i]
    return keep.to(dev), kv.to(dev)


# ---------------------------------------------------------------------------
# assignment and sampling
# ---------------------------------------------------------------------------

def max_iou_assign(priors, gt_boxes, gt_valid, pos_thr, neg_thr, min_pos, low_quality,
                   prior_valid=None):
    ov = iou(gt_boxes, priors)  # (B, G, N)
    ov = torch.where(gt_valid[..., :, None], ov, torch.full_like(ov, -1.0))
    mx, arg = ov.max(dim=-2)
    out = torch.full_like(arg, IGNORE)
    out = torch.where((mx >= 0) & (mx < neg_thr), torch.full_like(out, NEG), out)
    out = torch.where(mx >= pos_thr, arg, out)
    if low_quality:
        gmax = ov.max(dim=-1, keepdim=True).values
        claim = (ov == gmax) & (gmax >= min_pos) & gt_valid[..., :, None]
        ids = torch.arange(gt_boxes.shape[-2], device=ov.device)[:, None]
        by = torch.where(claim, ids, torch.full_like(ids, -1)).max(dim=-2).values
        out = torch.where(by >= 0, by, out)
    if prior_valid is not None:
        out = torch.where(prior_valid, out, torch.full_like(out, IGNORE))
    return out


def _kth(u, mask, k_max, k):
    """Per row: the k-th largest priority among ``mask`` (k clipped to [1, k_max])."""
    m = torch.where(mask, u, torch.full_like(u, float("-inf")))
    k_max = min(k_max, m.shape[-1])
    top = top_k(m, k_max)[0]
    return torch.gather(top, -1, torch.clamp(k, 1, k_max).long() - 1)


def sample_masks(assigned, num, pos_fraction, u):
    is_pos, is_neg = assigned >= 0, assigned == NEG
    max_pos = int(num * pos_fraction)
    n_pos = is_pos.sum(-1, keepdim=True)
    pos = is_pos & (u >= _kth(u, is_pos, max_pos, torch.clamp(n_pos, max=max_pos))) & (n_pos != 0)
    k_neg = torch.minimum(torch.clamp(num - pos.sum(-1, keepdim=True), min=0),
                          is_neg.sum(-1, keepdim=True))
    neg = is_neg & (u >= _kth(u, is_neg, num, k_neg)) & (k_neg != 0)
    return pos, neg


def sample_gather(assigned, num, pos_fraction, u, u2):
    pos, neg = sample_masks(assigned, num, pos_fraction, u)
    key = torch.where(pos, 2.0 * BIG + u2, torch.where(neg, BIG + u2, u2 - BIG))
    v, i = top_k(key, num)
    valid = v > 0.0
    return torch.where(valid, i, torch.zeros_like(i)), valid, v > 2.0 * BIG - 1.0


# ---------------------------------------------------------------------------
# RoIAlign (mmdet routing, aligned, 2x2 samples per bin, mean over samples)
# ---------------------------------------------------------------------------

def roi_align(feats, rois, bidx, cfg: dict, out_size: int, ss: int, chunk: int = 128):
    """feats: L NCHW maps; rois (R, 4); bidx (R,) -> (R, C, out, out),
    differentiable in the maps."""
    strides = cfg["roi_strides"]
    L = len(strides)
    B, C = feats[0].shape[:2]
    dev = rois.device
    hw = [(f.shape[2], f.shape[3]) for f in feats[:L]]
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, C) for f in feats[:L]])
    area = (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])
    scale = torch.sqrt(torch.clamp(area, min=0.0))
    lvl = torch.clamp(torch.floor(torch.log2(scale / torch.full_like(scale, cfg["roi_finest_scale"])
                                             + 1e-6)), 0, L - 1).long()
    offs, o = [], 0
    for h, w in hw:
        offs.append(o)
        o += B * h * w
    tab = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)[lvl]
    sc = tab([1.0 / s for s in strides], torch.float32)
    H = tab([float(h) for h, _ in hw], torch.float32)
    W = tab([float(w) for _, w in hw], torch.float32)
    base = tab(offs, torch.int64) + bidx.long() * tab([h * w for h, w in hw], torch.int64)
    x1, y1 = rois[:, 0] * sc - 0.5, rois[:, 1] * sc - 0.5
    bw = (rois[:, 2] - rois[:, 0]) * sc
    bh = (rois[:, 3] - rois[:, 1]) * sc
    bw = bw / torch.full_like(bw, out_size)
    bh = bh / torch.full_like(bh, out_size)
    n = out_size * ss
    k = torch.arange(n, device=dev)
    frac = (k % ss).float() + 0.5
    g = (k // ss).float() + frac / torch.full_like(frac, ss)
    ys = y1[:, None] + g[None] * bh[:, None]
    xs = x1[:, None] + g[None] * bw[:, None]
    out = []
    for r0 in range(0, rois.shape[0], chunk):
        sl = slice(r0, r0 + chunk)
        y = ys[sl][:, :, None].expand(-1, n, n)
        x = xs[sl][:, None, :].expand(-1, n, n)
        hh, ww = H[sl][:, None, None], W[sl][:, None, None]
        outside = (y < -1.0) | (y > hh) | (x < -1.0) | (x > ww)
        y = torch.minimum(torch.clamp(y, min=0.0), hh - 1.0)
        x = torch.minimum(torch.clamp(x, min=0.0), ww - 1.0)
        y0, x0 = torch.floor(y), torch.floor(x)
        yb, xb = torch.minimum(y0 + 1.0, hh - 1.0), torch.minimum(x0 + 1.0, ww - 1.0)
        ly, lx = y - y0, x - x0
        wi = ww.long()
        bs = base[sl][:, None, None]
        acc = 0.0
        for yy, xx, wt in ((y0, x0, (1 - ly) * (1 - lx)), (y0, xb, (1 - ly) * lx),
                           (yb, x0, ly * (1 - lx)), (yb, xb, ly * lx)):
            wt = torch.where(outside, torch.zeros_like(wt), wt)
            rows = flat[(bs + yy.long() * wi + xx.long()).reshape(-1)]
            acc = acc + rows.reshape(wt.shape + (C,)) * wt[..., None]
        acc = acc.reshape(-1, out_size, ss, out_size, ss, C).mean(dim=(2, 4))
        out.append(acc.permute(0, 3, 1, 2))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# RPN, RoI head, losses
# ---------------------------------------------------------------------------

def bce(logits, t):
    return torch.clamp(logits, min=0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def proposals(cfg: dict, cls, reg, anc, sizes, img_shape):
    """Per level top ``rpn_nms_pre`` by sigmoid score, decoded and clipped,
    then level-aware NMS: (boxes (B, P, 4), valid (B, P), scores)."""
    B = cls[0].shape[0]
    A = len(cfg["anchor_ratios"]) * len(cfg["anchor_scales"])
    hw = img_shape.float()
    max_hw = (hw[:, 0].view(B, 1, 1), hw[:, 1].view(B, 1, 1))
    bl, sl, ll, off = [], [], [], 0
    for li, ((h, w), c, r) in enumerate(zip(sizes, cls, reg)):
        n = h * w * A
        s, i = top_k(torch.sigmoid(c.detach()), min(cfg["rpn_nms_pre"], n))
        d = torch.gather(r.detach(), 1, i[..., None].expand(-1, -1, 4))
        bl.append(decode(anc[off:off + n][i], d, max_hw=max_hw))
        sl.append(s)
        ll.append(torch.full_like(i, li))
        off += n
    boxes, scores, lv = torch.cat(bl, 1), torch.cat(sl, 1), torch.cat(ll, 1)
    ok = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    keep, kv = nms(boxes, scores, lv, ok, cfg["rpn_nms_iou"], cfg["rpn_max_per_img"])
    return torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)), kv, torch.gather(scores, 1, keep)


def rpn_losses(cfg: dict, cls, reg, anc, sizes, img_shape, gt, u):
    c = torch.cat(cls, 1)
    r = torch.cat(reg, 1)
    B = c.shape[0]
    valid = anchor_valid(cfg, sizes, img_shape)
    a = max_iou_assign(anc[None].expand(B, -1, -1), gt["boxes"], gt["valid"],
                       cfg["rpn_pos_iou_thr"], cfg["rpn_neg_iou_thr"], cfg["rpn_min_pos_iou"], True,
                       valid)
    pos, neg = sample_masks(a, cfg["rpn_num"], cfg["rpn_pos_fraction"], u)
    g = torch.gather(gt["boxes"], 1, torch.clamp(a, min=0)[..., None].expand(-1, -1, 4))
    tgt = encode(anc[None].expand(B, -1, -1), g)
    avg = torch.clamp((pos | neg).float().sum(), min=1.0)
    return {"loss_rpn_cls": (bce(c, pos.float()) * (pos | neg).float()).sum() / avg,
            "loss_rpn_bbox": ((r - tgt).abs() * pos[..., None].float()).sum() / avg}


def bbox_head(P: Params, cfg: dict, x, lp, task_id: int, prefix="roi_head.bbox_head"):
    """(R, C, 7, 7) or (R, C*49) -> (cls (R, nc + 1), reg (R, 4 nc))."""
    x = torch.relu(linear(P, prefix + ".shared_fcs.0", x.reshape(x.shape[0], -1), lp))
    x = torch.relu(linear(P, prefix + ".shared_fcs.1", x, lp))
    split = cfg["task_split"]
    T = len(split) - 1
    cls, reg = [], []
    for i in range(T):
        c = linear(P, f"{prefix}.fc_cls.{i}", x, lp)
        r = linear(P, f"{prefix}.fc_reg.{i}", x, lp)
        if i + 1 > task_id:
            c, r = torch.full_like(c, NEG_SCORE), torch.zeros_like(r)
        cls.append(c)
        reg.append(r)
    cls.append(linear(P, f"{prefix}.fc_cls.{T}", x, lp))
    return torch.cat(cls, -1), torch.cat(reg, -1)


def sample_rois(cfg: dict, props, pvalid, gt, u, u2):
    B = props.shape[0]
    cand = torch.cat([gt["boxes"], props], 1)
    cv = torch.cat([gt["valid"], pvalid], 1)
    a = max_iou_assign(cand, gt["boxes"], gt["valid"], cfg["rcnn_pos_iou_thr"],
                       cfg["rcnn_neg_iou_thr"], cfg["rcnn_min_pos_iou"], False, cv)
    idx, ok, pos = sample_gather(a, cfg["rcnn_num"], cfg["rcnn_pos_fraction"], u, u2)
    S = idx.shape[1]
    rois = torch.gather(cand, 1, idx[..., None].expand(B, S, 4))
    g = torch.clamp(torch.gather(a, 1, idx), min=0)
    nc = cfg["num_classes"]
    labels = torch.where(pos & ok, torch.gather(gt["labels"].long(), 1, g), torch.full_like(g, nc))
    tgt = encode(rois, torch.gather(gt["boxes"], 1, g[..., None].expand(B, S, 4)),
                 cfg["rcnn_target_stds"])
    tgt = torch.where(pos[..., None], tgt, torch.zeros_like(tgt))
    bidx = torch.arange(B, device=props.device).repeat_interleave(S)
    return rois.reshape(-1, 4), bidx, labels.reshape(-1), ok.reshape(-1), pos.reshape(-1), \
        tgt.reshape(-1, 4)


def cls_reg_losses(cfg: dict, cls, reg, labels, ok, pos, tgt):
    nc = cfg["num_classes"]
    w = ok.float()
    avg = torch.clamp(w.sum(), min=1.0)
    ll = torch.gather(torch.log_softmax(cls, -1), 1, labels[:, None])[:, 0]
    sel = torch.gather(reg.reshape(-1, nc, 4), 1,
                       torch.clamp(labels, 0, nc - 1)[:, None, None].expand(-1, 1, 4))[:, 0]
    return {"loss_cls": (-ll * w).sum() / avg,
            "loss_bbox": ((sel - tgt).abs() * pos[:, None].float()).sum() / avg}


# ---------------------------------------------------------------------------
# mask branch
# ---------------------------------------------------------------------------

def mask_head(P: Params, cfg: dict, x, lp):
    for i in range(cfg["mask_convs"]):
        x = torch.relu(conv(P, f"roi_head.mask_head.convs.{i}.conv", x, lp, padding=1))
    x = torch.relu(lp(F.conv_transpose2d(lp(x), lp(P["roi_head.mask_head.upsample.weight"]),
                                         P["roi_head.mask_head.upsample.bias"], stride=2)))
    return conv(P, "roi_head.mask_head.conv_logits", x, lp)  # (R, nc, 28, 28)


def mask_targets(rois, bidx, gt, size: int):
    """Each RoI's IoU-argmax gt crop (box-normalised, S x S) resampled
    bilinearly over the RoI at ``size`` x ``size`` cell centres, zero
    outside the crop, thresholded at 0.5."""
    gb = gt["boxes"][bidx]
    ov = iou(rois[:, None, :], gb)[:, 0]
    ov = torch.where(gt["valid"][bidx], ov, torch.full_like(ov, -1.0))
    g = torch.argmax(ov, 1)
    crop = gt["masks"][bidx, g].float()
    box = gb[torch.arange(len(g), device=g.device), g]
    S = crop.shape[-1]
    gw = torch.clamp(box[:, 2:3] - box[:, 0:1], min=1e-4)
    gh = torch.clamp(box[:, 3:4] - box[:, 1:2], min=1e-4)
    c = torch.arange(size, dtype=torch.float32, device=rois.device) + 0.5
    frac = c / torch.full_like(c, size)
    ys = rois[:, 1:2] + frac * (rois[:, 3:4] - rois[:, 1:2])
    xs = rois[:, 0:1] + frac * (rois[:, 2:3] - rois[:, 0:1])
    cy = (ys - box[:, 1:2]) / gh * S - 0.5
    cx = (xs - box[:, 0:1]) / gw * S - 0.5
    y0, x0 = torch.floor(cy), torch.floor(cx)
    ly, lx = cy - y0, cx - x0
    n = torch.arange(len(g), device=g.device)[:, None, None]

    def at(iy, ix):
        v = crop[n, torch.clamp(iy.long(), 0, S - 1)[:, :, None],
                 torch.clamp(ix.long(), 0, S - 1)[:, None, :]]
        inside = ((iy >= 0) & (iy <= S - 1))[:, :, None] & ((ix >= 0) & (ix <= S - 1))[:, None, :]
        return torch.where(inside, v, torch.zeros_like(v))

    t = (at(y0, x0) * ((1 - ly)[:, :, None] * (1 - lx)[:, None, :])
         + at(y0, x0 + 1) * ((1 - ly)[:, :, None] * lx[:, None, :])
         + at(y0 + 1, x0) * (ly[:, :, None] * (1 - lx)[:, None, :])
         + at(y0 + 1, x0 + 1) * (ly[:, :, None] * lx[:, None, :]))
    return (t > 0.5).float()


def mask_loss(P: Params, cfg: dict, feats, rois, bidx, labels, pos, gt, lp):
    nc = cfg["num_classes"]
    x = roi_align(feats, rois, bidx, cfg, cfg["mask_roi_out_size"], cfg["roi_sampling_ratio"], 32)
    logits = mask_head(P, cfg, x, lp)
    M = logits.shape[-1]
    lab = torch.clamp(labels, 0, nc - 1)
    ml = torch.gather(logits, 1, lab[:, None, None, None].expand(-1, 1, M, M))[:, 0]
    t = mask_targets(rois, bidx, gt, M)
    w = pos.float()
    return (bce(ml, t).mean(dim=(1, 2)) * w).sum() / torch.clamp(w.sum(), min=1.0)


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------

def level_sizes(feats):
    return [(int(f.shape[2]), int(f.shape[3])) for f in feats]


@torch.no_grad()
def predict(P: Params, cfg: dict, images, img_shape, scale_factor, lp=identity,
            task_id: Optional[int] = None, rescale: bool = True, max_out: Optional[int] = None):
    """Padded detections: boxes (B, D, 4), labels, valid, scores, in pick
    order; ``max_out`` keeps more than ``max_per_img`` (greedy NMS keeps
    the same first ``max_per_img``)."""
    task_id = cfg["task_id"] if task_id is None else task_id
    feats = extract(P, cfg, images, lp)
    sizes = level_sizes(feats)
    anc = anchors(cfg, sizes, images.device)
    cls, reg = rpn_head(P, feats, lp)
    props, pv, _ = proposals(cfg, cls, reg, anc, sizes, img_shape)
    B, R = props.shape[:2]
    nc = cfg["num_classes"]
    bidx = torch.arange(B, device=props.device).repeat_interleave(R)
    x = roi_align(feats, props.reshape(-1, 4), bidx, cfg, cfg["roi_out_size"],
                  cfg["roi_sampling_ratio"])
    cs, rg = bbox_head(P, cfg, x, lp, task_id)
    hw = img_shape.float()
    boxes = decode(props, rg.reshape(B, R, -1), cfg["rcnn_target_stds"],
                   (hw[:, 0].view(B, 1, 1), hw[:, 1].view(B, 1, 1))).reshape(B, R, nc, 4)
    if rescale:
        s = scale_factor.float()
        boxes = boxes / torch.cat([s, s], 1)[:, None, None, :]
    probs = torch.softmax(cs.reshape(B, R, -1), -1)[..., :nc]
    fb, fs = boxes.reshape(B, -1, 4), probs.reshape(B, -1)
    fl = torch.arange(nc, device=props.device).repeat(B, R)
    ok = (fs > cfg["score_thr"]) & pv.repeat_interleave(nc, 1)
    keep, kv = nms(fb, fs, fl, ok, cfg["nms_iou"], max_out or cfg["max_per_img"])
    return {"boxes": torch.gather(fb, 1, keep[..., None].expand(-1, -1, 4)),
            "labels": torch.gather(fl, 1, keep), "valid": kv, "scores": torch.gather(fs, 1, keep)}


def merge_pseudo(cfg: dict, gt, dets):
    """(rpn_gt, roi_gt): the gt slots, then the teacher's detections that
    overlap no real gt by more than ``pseudo_iou_skip`` and clear the RPN or
    RoI score threshold (box 0, label -1, invalid otherwise)."""
    ov = iou(dets["boxes"], gt["boxes"])
    ov = torch.where(gt["valid"][:, None, :], ov, torch.zeros_like(ov))
    base = dets["valid"] & (ov.max(2).values <= cfg["pseudo_iou_skip"])

    def cat(keep):
        return {"boxes": torch.cat([gt["boxes"], torch.where(keep[..., None], dets["boxes"], 0.0)], 1),
                "labels": torch.cat([gt["labels"].long(), torch.where(keep, dets["labels"].long(), -1)], 1),
                "valid": torch.cat([gt["valid"], keep], 1)}

    return cat(base & (dets["scores"] > cfg["rpn_thresh"])), cat(base & (dets["scores"] > cfg["roi_thresh"]))


EWC_NAME = re.compile(r"backbone\.(bn1|layer\d+\.\d+\.(bn\d|downsample\.1))\.(weight|bias)")


def train_losses(P: Params, cfg: dict, batch, u, lp=identity, teacher=None, replay=None, ewc=None):
    """The loss terms of one step on ``batch`` (uint8 images, img_shape,
    gt). ``teacher``: the teacher's detections (merged into the RPN and RoI
    gt sets); ``replay``: (prototypes (P, C*49), labels); ``ewc``: name ->
    (importance (T, ...), old value (T, ...))."""
    gt = batch["gt"]
    rpn_gt = roi_gt = gt
    if teacher is not None:
        rpn_gt, roi_gt = merge_pseudo(cfg, gt, teacher)
    feats = extract(P, cfg, batch["images"], lp)
    sizes = level_sizes(feats)
    anc = anchors(cfg, sizes, feats[0].device)
    cls, reg = rpn_head(P, feats, lp)
    losses = rpn_losses(cfg, cls, reg, anc, sizes, batch["img_shape"], rpn_gt, u["rpn"])
    props, pv, _ = proposals(cfg, cls, reg, anc, sizes, batch["img_shape"])
    rois, bidx, labels, ok, pos, tgt = sample_rois(cfg, props, pv, roi_gt, u["roi"], u["roi2"])
    x = roi_align(feats, rois, bidx, cfg, cfg["roi_out_size"], cfg["roi_sampling_ratio"])
    cs, rg = bbox_head(P, cfg, x, lp, cfg["task_id"])
    losses.update(cls_reg_losses(cfg, cs, rg, labels, ok, pos, tgt))
    if cfg.get("mask_convs") and roi_gt.get("masks") is not None:
        losses["loss_mask"] = mask_loss(P, cfg, feats, rois, bidx, labels, pos, roi_gt, lp)
    if replay is not None:
        c, _ = bbox_head(P, cfg, replay[0], lp, cfg["task_id"])
        pre = cfg["task_split"][cfg["task_id"]]
        s = torch.cat([c[:, :pre], c[:, -1:]], -1)
        logp = torch.log_softmax(torch.softmax(s, -1), -1)
        losses["replay_loss_cls"] = -torch.gather(logp, 1, replay[1].long()[:, None]).mean()
    if ewc:
        losses["ewc_loss"] = cfg["ewc_weight"] * sum(
            (imp * (P[k][None] - old) ** 2).sum() for k, (imp, old) in ewc.items())
    return losses


def trainable(cfg: dict, names) -> List[str]:
    """Every parameter but the frozen stem and stages, the BN statistics and
    the heads of future tasks."""
    frozen = ["backbone.conv1.", "backbone.bn1."] + [
        f"backbone.layer{s}." for s in range(1, cfg["frozen_stages"] + 1)]
    for i in range(len(cfg["task_split"]) - 1):
        if i + 1 > cfg["task_id"]:
            frozen += [f"roi_head.bbox_head.fc_cls.{i}.", f"roi_head.bbox_head.fc_reg.{i}."]
    return [n for n in names if not n.endswith(("running_mean", "running_var"))
            and not any(n.startswith(f) for f in frozen)]


def lr_at(opt: dict, step: int) -> float:
    """LinearLR warm-up and MultiStepLR decay, in float32."""
    f = np.float32
    warm = f(opt["warmup_start_factor"]) + f(1.0 - opt["warmup_start_factor"]) * min(
        f(step) / f(opt["warmup_iters"]), f(1.0))
    epoch = f(step) // f(opt["steps_per_epoch"])
    decay = f(1.0)
    for m in opt["milestones"]:
        decay = decay * (f(opt["gamma"]) if epoch >= m else f(1.0))
    return float(f(f(opt["lr"]) * warm) * decay)


def sgd_nscl_step(P: Params, names, grads: Params, bufs: Params, step: int, opt: dict,
                  transforms: Params):
    """SGD with momentum and L2 decay whose update is right-multiplied by the
    layer's projection (update.reshape(O, -1) @ P)."""
    lr = lr_at(opt, step)
    for n in names:
        p = P[n]
        g = grads.get(n)
        g = (torch.zeros_like(p) if g is None else g) + opt["weight_decay"] * p
        bufs[n] = g.clone() if step == 0 else opt["momentum"] * bufs[n] + g
        d = bufs[n] * (-lr)
        T = transforms.get(n)
        if T is not None and d.dim() in (2, 4):
            d = (d.reshape(d.shape[0], -1) @ T).reshape(d.shape)
        P[n] = p + d


def calibrate_bn(P: Params, cfg: dict, images_u8, generator: torch.Generator):
    """Give each frozen BN the statistics of its own input on ``images_u8``
    (in forward order) and a random affine in [0.5, 1.5) x [-0.5, 0.5), so
    activations stay in range through the 16 blocks of seeded weights. The
    last BN of each residual branch is scaled by ``cfg["branch_gain"]``:
    with full-size branches a seeded ResNet-50 is chaotic, and a 0.4%
    perturbation at the input grows to ~50% at layer4, so that two
    precisions of one network would compute unrelated detections."""
    gain = cfg.get("branch_gain", 1.0)

    def bn(P_, name, x):
        P_[name + ".running_mean"] = x.mean(dim=(0, 2, 3))
        P_[name + ".running_var"] = x.var(dim=(0, 2, 3))
        c = x.shape[1]
        dev = x.device
        g = gain if name.endswith(".bn3") else 1.0
        P_[name + ".weight"] = (torch.rand(c, generator=generator, device=dev) + 0.5) * g
        P_[name + ".bias"] = (torch.rand(c, generator=generator, device=dev) - 0.5) * g
        return frozen_bn(P_, name, x)

    mean = torch.tensor(cfg["pixel_mean"], device=images_u8.device)
    std = torch.tensor(cfg["pixel_std"], device=images_u8.device)
    with torch.no_grad(), no_tf32():
        x = ((images_u8.float() - mean) / std).permute(0, 3, 1, 2).contiguous()
        backbone(P, cfg, x, identity, bn=bn)
