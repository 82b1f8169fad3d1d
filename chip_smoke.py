#!/usr/bin/env python3
"""Run the PyTorch port (nsgp_repre_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each of which raises on a failed check (exit code 1):

1. toolchain: the card's name and power limit, torch.version.cuda, nvcc,
   whether ``import triton`` works;
2. build: the CUDA kernels from nsgp_repre_tpu_torch/csrc, timed;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the same seeded inputs at the shapes the batch-1 predict path gives it
   (608x1024 canvas), in bf16 and in f32, with the tolerance stated beside
   each check; kernel, plain-version and library times from CUDA events,
   and the least time the card could take for the same work; the conv
   kernels also at batch 16 (the train step's rpn_head), each bf16 conv
   called twice for the same bits; proposal NMS also at the train step's
   16 images; the RoIAlign forward also at the train step's 8,192 RoIs and
   predict batch 16's 16,000, two calls bit for bit; the row gather (no
   caller) on a table of 400,000 4-KB rows;
4. slice: full-width Faster R-CNN R-50-FPN (15+5 VOC config, task 1) built
   by ``init_detector`` with seeded weights and driven by
   ``inference_detector``: bf16 at batch 1 (every predict kernel must
   launch) and at batch 16, the batch-1 f32 result on the card against
   the same weights on the CPU through the plain versions, latency and
   throughput;
5. training kernels: the anchor assignment and the RoIAlign backward
   against their plain versions at the batch-16 training shapes, the
   backward on proposal-like and sampler-like RoIs (hot tiles) at ss = 2
   and 1, two calls bit for bit, with device time per level;
6. train: the same model and weights trained by ``make_train_step`` with
   the optimizer ``build_train_optimizer`` builds from the config (bf16,
   batch 16, seeded images and boxes): every training kernel launches
   once per step, losses stay finite, frozen parameters stay bit-equal
   and trainable ones move; the f32 batch-1 loss terms and gradients on
   the card against the CPU; step time, img/s, peak memory, one profiled
   step.

The last lines are the card line, one JSON object listing the kernels,
and ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

CONFIG = "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_1.py"
IMAGE_HW = (600, 1000)  # keep-ratio resize to (1000, 600) is the identity → 608x1024 canvas
CANVAS = (608, 1024)
STRIDES = (4, 8, 16, 32, 64)
C = 256
A = 3
SEED = 0

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores (the f32
# kernels do not use TF32).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    "conv3x3": "nsgp_repre_tpu/ops/rpn_head_pallas.py:153",
    "rpn_head": "nsgp_repre_tpu/ops/rpn_head_pallas.py:141",
    "nms": "nsgp_repre_tpu/ops/nms_pallas.py:32",
    "roi_align": "nsgp_repre_tpu/ops/roi_align_pallas.py:305",
    "roi_align_bwd": "nsgp_repre_tpu/ops/roi_align_pallas.py:600",
    "assign": "nsgp_repre_tpu/ops/assign_pallas.py:44",
    "gather": "nsgp_repre_tpu/ops/gather_pallas.py:27",
}
SOURCES = {
    "conv3x3": "nsgp_repre_tpu_torch/csrc/conv3x3.cu",
    "rpn_head": "nsgp_repre_tpu_torch/csrc/conv3x3.cu",
    "nms": "nsgp_repre_tpu_torch/csrc/nms.cu",
    "roi_align": "nsgp_repre_tpu_torch/csrc/roi_align.cu",
    "roi_align_bwd": "nsgp_repre_tpu_torch/csrc/roi_align.cu",
    "assign": "nsgp_repre_tpu_torch/csrc/assign.cu",
    "gather": "nsgp_repre_tpu_torch/csrc/gather.cu",
}
KERNELS = ("conv3x3", "rpn_head", "nms", "roi_align", "roi_align_bwd", "assign", "gather")
# launches of each kernel in one predict: batch 1 runs the fused FPN
# convs (P2-P5) and the fused RPN head (P2-P6); every batch runs
# proposal + multiclass NMS and one RoIAlign; the row gather has no caller
EXPECTED_B1 = {"conv3x3": 4, "rpn_head": 5, "nms": 2, "roi_align": 1, "roi_align_bwd": 0,
               "assign": 0, "gather": 0}
EXPECTED_B16 = {"conv3x3": 0, "rpn_head": 0, "nms": 2, "roi_align": 1, "roi_align_bwd": 0,
                "assign": 0, "gather": 0}
# launches in one train step (sparse RPN loss, any batch): the forward-only
# RPN head on P2-P6, the anchor assignment, proposal NMS, and RoIAlign
# forward and backward once each
EXPECTED_TRAIN = {"conv3x3": 0, "rpn_head": 5, "nms": 1, "roi_align": 1, "roi_align_bwd": 1,
                  "assign": 1, "gather": 0}
TRAIN_BATCH = 16  # _base_/datasets/voc_task_base.py:11
GT_CAPACITY = 64  # nsgp_repre_tpu/engine/runner.py:252
STEPS_PER_EPOCH = 1000  # read only by the MultiStepLR milestones (epochs 8, 11)
IOU_FLOPS = 13  # one IoU: 4 min/max, 2 sub, 2 clamps, 1 mul, 2 add/sub, 1 max, 1 div


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: " + out.stderr


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call of ``fn`` (CUDA events around
    ``iters`` back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call of ``fn``: the device-side events
    (kernels, copies) torch.profiler records over ``iters`` calls after a
    warm-up call, summed, without the host's launch gaps between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity")
                and not getattr(e, "is_user_annotation", False))
    check("device_ms", total > 0, "no device time recorded")
    return total / 1e3 / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(name: str, ok: bool, detail) -> None:
    if not ok:
        raise AssertionError(f"{name}: {detail}")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def level_shapes():
    return [(-(-CANVAS[0] // s), -(-CANVAS[1] // s)) for s in STRIDES]


def proposal_like_boxes(torch, g, n, canvas=CANVAS):
    """Seeded boxes shaped like decoded proposals: centers on the canvas,
    log-uniform sides 8..600 px, aspect 0.5..2, clipped to the canvas."""
    H, W = canvas
    cx = torch.rand(n, generator=g) * W
    cy = torch.rand(n, generator=g) * H
    side = torch.exp(torch.rand(n, generator=g) * (6.4 - 2.08) + 2.08)
    asp = torch.exp((torch.rand(n, generator=g) - 0.5) * 1.386)
    w, h = side * asp.sqrt(), side / asp.sqrt()
    b = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    b[:, 0::2] = b[:, 0::2].clamp(0, W)
    b[:, 1::2] = b[:, 1::2].clamp(0, H)
    return b


def nms_work(torch, nms_cuda, shifted, s, valid, ki, kv, max_out: int):
    """Bytes and IoU operations this data needs, over all images: each
    candidate up to the last pick is tested against every box kept
    before it."""
    _, order, nv = nms_cuda.sort_candidates(shifted, s, valid)
    B, N = s.shape
    nbytes = flops = 0
    for b in range(B):
        pos = torch.empty_like(order[b])
        pos[order[b].long()] = torch.arange(N, dtype=pos.dtype, device=pos.device)
        kept_pos = pos[ki[b][kv[b]].long()].sort().values
        stop = (int(kept_pos[-1]) + 1) if int(kv[b].sum()) == max_out else int(nv[b])
        pairs = int((stop - 1 - kept_pos).clamp(min=0).sum())
        flops += 17 * pairs  # IoU: 6 min/max/sub + 2 clamps + 3 mul + 3 add/sub + max, div, compare
        nbytes += N * 16 + N * 4 + 4 + max_out * 4 + 4
    return nbytes, flops


def sampler_like_boxes(torch, g, batch: int, per_image: int, canvas=CANVAS):
    """Seeded RoIs shaped like the RoI sampler's output, image by image: a
    quarter jittered around the image's 1-8 ground-truth boxes (i % 8 + 1
    of them; the positives, which pile onto a few map tiles), the rest
    proposal-like. Returns (batch * per_image, 4) and the batch indices."""
    H, W = canvas
    q = per_image // 4
    out = []
    for i in range(batch):
        gt = proposal_like_boxes(torch, g, i % 8 + 1, canvas)
        base = gt[torch.randint(0, len(gt), (q,), generator=g)]
        size = (base[:, 2:] - base[:, :2]).repeat(1, 2)
        pos = base + torch.randn(q, 4, generator=g) * 0.1 * size
        pos[:, 0::2] = pos[:, 0::2].clamp(0, W)
        pos[:, 1::2] = pos[:, 1::2].clamp(0, H)
        out += [pos, proposal_like_boxes(torch, g, per_image - q, canvas)]
    bidx = torch.arange(batch, dtype=torch.int32).repeat_interleave(per_image)
    return torch.cat(out), bidx


def roi_align_fwd_phase(torch, dev, g):
    """The RoIAlign forward against its plain version at the main path's
    sizes: 1000 proposals of one image (predict batch 1), 512 sampled RoIs
    on each of 16 images (the train step), 1000 proposals on each of 16
    (predict batch 16). bf16 and f32 at the first two, bf16 at the third;
    two calls bit for bit; kernel time (events and profiler), plain time,
    bound. The entry keyed ("roi_align", dtype) is the batch-1 one, with
    the others under ``by_size``."""
    from nsgp_repre_tpu_torch.ops import roi_align, roi_align_cuda

    shapes = level_shapes()[:4]
    gd = torch.Generator(device=dev).manual_seed(SEED + 9)
    results = {}
    for B, per_image, label in ((1, 1000, "predict batch 1"), (TRAIN_BATCH, 512, "train batch 16"),
                                (16, 1000, "predict batch 16")):
        R = B * per_image
        if label == "train batch 16":
            rois, bidx = sampler_like_boxes(torch, g, B, per_image)
        else:
            rois = proposal_like_boxes(torch, g, R)
            bidx = torch.arange(B, dtype=torch.int32).repeat_interleave(per_image)
        rois, bidx = rois.to(dev), bidx.to(dev)
        if B == 1:
            feats32 = [torch.randn(1, h, wd, C, generator=g).to(dev) for h, wd in shapes]
        else:
            feats32 = [torch.randn(B, h, wd, C, generator=gd, device=dev) for h, wd in shapes]
        lin, wts = roi_align.sample_taps(shapes, B, rois, bidx, STRIDES[:4])
        rows = int(torch.unique(lin[wts != 0]).numel())
        del lin, wts
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            if dt == torch.float32 and label == "predict batch 16":
                continue
            size = 2 if dt == torch.bfloat16 else 4
            feats = [f.to(dt) for f in feats32]
            run = lambda: roi_align_cuda.multilevel_roi_align(  # noqa: E731
                feats, rois, bidx, strides=STRIDES[:4])
            plain = lambda: roi_align.multilevel_roi_align(  # noqa: E731
                feats, rois, bidx, strides=STRIDES[:4])
            got, again, ref = run(), run(), plain().to(dt)
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            del got, again, ref
            if dt == torch.float32:
                # the same f32 tap products, summed in another order
                tol, tol_desc = 1e-5 * max(1.0, scale), "1e-5 * max(1, max|plain|)"
            else:
                # one bf16 rounding of f32 sums that differ in order only
                tol, tol_desc = 2 ** -7 * scale, "2**-7 * max|plain|"
            check(f"roi_align {dt_name} {label}", err <= tol, f"max_abs_err {err} > {tol_desc}")
            # one block per RoI, no atomics: a call gives the same bits every time
            check(f"roi_align {dt_name} {label}", same, "two calls of the kernel differ")
            # outputs written, RoIs and indices read, the distinct map rows the taps need
            nbytes = R * 49 * C * size + R * 16 + R * 4 + rows * C * size
            flops = R * 49 * 4 * (4 * 2 + 1) * C + R * 49 * C
            bms, bby = bound(nbytes, flops, dt_name)
            entry = dict(
                kernel="roi_align", dtype=dt_name, case=label, R=R, launches_per_call=1,
                kernel_ms=time_ms(torch, run, 20), device_ms=device_ms(torch, run, 5),
                plain_ms=time_ms(torch, plain, 3 if B == 1 else 1, warmup=1),
                library_ms=None, max_abs_err=err, tol=tol_desc, bit_identical_reruns=same,
                bound_ms=bms, bound_by=bby, bytes=nbytes, flops=flops, feature_rows_touched=rows)
            log(entry)
            if B == 1:
                results[("roi_align", dt_name)] = entry
                entry["by_size"] = {}
            else:
                results[("roi_align", dt_name)]["by_size"][label] = {
                    k: entry[k] for k in ("R", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
                                          "max_abs_err")}
        del feats32, feats
        torch.cuda.empty_cache()
    return results


def conv_phase(torch, dev, g, batch: int):
    """conv3x3 (the FPN output convs, P2-P5) and rpn_head (P2-P6) on
    ``batch`` seeded maps of the canvas's levels, bf16 and f32: each kernel
    against its plain version, two calls of each bit for bit, and, but for
    f32 at batch > 1, kernel, plain and library times and the bound.
    Results are keyed (kernel, dtype) at batch 1, (kernel, dtype, batch)
    otherwise."""
    import torch.nn.functional as F

    from nsgp_repre_tpu_torch.ops import rpn_head_cuda as rh

    results = {}
    w = torch.randn(3, 3, C, C, generator=g, device=g.device) / (9 * C) ** 0.5
    b = torch.randn(C, generator=g, device=g.device) * 0.1
    wcr = torch.randn(C, 5 * A, generator=g, device=g.device) / C ** 0.5
    bcr = torch.randn(5 * A, generator=g, device=g.device) * 0.1
    maps32 = [torch.randn(batch, h, wd, C, generator=g, device=g.device) for h, wd in level_shapes()]
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        size = 2 if dt == torch.bfloat16 else 4
        maps = [m.to(dev, dt) for m in maps32]
        wd, bd, wcrd, bcrd = w.to(dev), b.to(dev), wcr.to(dev), bcr.to(dev)
        w_oihw = wd.permute(3, 2, 0, 1).to(dt).contiguous()
        wcr_oihw = wcrd.t().reshape(5 * A, C, 1, 1).to(dt).contiguous()
        for name in ("conv3x3", "rpn_head"):
            levels = maps[:4] if name == "conv3x3" else maps

            def kernel(x):
                return (rh.conv3x3(x, wd, bd) if name == "conv3x3"
                        else rh.rpn_head(x, wd, bd, wcrd, bcrd))

            def plain(x):
                return (rh.conv3x3_plain(x, wd, bd) if name == "conv3x3"
                        else rh.rpn_head_plain(x, wd, bd, wcrd, bcrd))

            err, tol_ok, same, tol_desc = 0.0, True, True, ""
            for x in levels:
                got, again, ref = kernel(x), kernel(x), plain(x)
                torch.cuda.synchronize()
                same &= torch.equal(got, again)
                e = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                if dt == torch.float32:
                    # the same f32 products summed in another order over
                    # K = 2304 terms (cuDNN with TF32 off in the plain version)
                    tol, tol_desc = 1e-4 * max(1.0, scale), "1e-4 * max(1, max|plain|)"
                else:
                    # both round the same f32 sums to bf16 at the same
                    # points; another summation order can flip a rounding
                    # (and, in the head, a hidden value feeding the 1x1)
                    tol, tol_desc = 2 ** -6 * scale, "2**-6 * max|plain|"
                tol_ok &= e <= tol
                err = max(err, e)
                del got, again, ref
            label = f"{name} {dt_name} batch {batch}"
            check(label, tol_ok, f"max_abs_err {err} > {tol_desc}")
            # no split-K, no atomics: a call gives the same bits every time
            check(label, same, "two calls of the kernel differ")
            entry = dict(kernel=name, dtype=dt_name, batch=batch, max_abs_err=err, tol=tol_desc,
                         bit_identical_reruns=same)
            if dt == torch.float32 and batch > 1:
                log(entry)
                continue
            nchw = [x.permute(0, 3, 1, 2) for x in levels]  # channels_last views

            def run_library():
                for x in nchw:
                    y = F.conv2d(x, w_oihw, bd.to(dt), padding=1)
                    if name == "rpn_head":
                        F.conv2d(torch.relu(y), wcr_oihw, bcrd.to(dt))

            P = 5 * A if name == "rpn_head" else 0
            out_ch = P if name == "rpn_head" else C
            nbytes = sum(x.numel() * size + x.numel() // C * out_ch * size for x in levels)
            nbytes += len(levels) * (9 * C * C * size + C * 4 + C * P * size + P * 4)
            flops = sum(2 * (x.numel() // C) * (9 * C * C + C * P) for x in levels)
            bms, bby = bound(nbytes, flops, dt_name)
            run_kernel = lambda: [kernel(x) for x in levels]  # noqa: E731
            entry.update(
                launches=len(levels),
                kernel_ms=time_ms(torch, run_kernel, 10),
                # the same calls without the host's gaps: what they cost the card
                device_ms=device_ms(torch, run_kernel, 5),
                device_ms_by_level=[device_ms(torch, lambda x=x: kernel(x), 5) for x in levels],
                library_device_ms=device_ms(torch, run_library, 5),
                plain_ms=time_ms(torch, lambda: [plain(x) for x in levels], 5 if batch == 1 else 2,
                                 warmup=1),
                library_ms=time_ms(torch, run_library, 10),
                library_call=("F.conv2d 3x3" if name == "conv3x3"
                              else "F.conv2d 3x3 + relu + F.conv2d 1x1"),
                bound_ms=bms, bound_by=bby, bytes=nbytes, flops=flops,
            )
            results[(name, dt_name) if batch == 1 else (name, dt_name, batch)] = entry
            log(entry)
    return results


def gather_phase(torch, dev):
    """The row gather (no caller in either package) against its plain
    version, bit for bit, at the TPU kernel's measured shape class: an f32
    table of hundreds of thousands of 4-KB rows, some indices out of range."""
    from nsgp_repre_tpu_torch.ops import gather_cuda

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    N, Cg, M = 400_000, 1024, 600_000
    table = torch.randn(N, Cg, generator=g, device=dev)
    idx = torch.randint(-N // 100, N + N // 100, (M,), generator=g, device=dev, dtype=torch.int32)
    got, ref = gather_cuda.gather_rows(table, idx), gather_cuda.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    check("gather", same, "kernel and plain rows differ")
    del got, ref
    clamped = idx.clamp(0, N - 1).long()
    rows = int(torch.unique(clamped).numel())
    # the distinct rows it must read, its indices, the rows it writes
    nbytes = rows * Cg * 4 + M * 4 + M * Cg * 4
    bms, bby = bound(nbytes, 0, "float32")
    entry = dict(
        kernel="gather", dtype="float32", table=[N, Cg], indices=M, distinct_rows=rows,
        out_of_range=int(((idx < 0) | (idx >= N)).sum()), launches_per_predict=0,
        kernel_ms=time_ms(torch, lambda: gather_cuda.gather_rows(table, idx), 20),
        plain_ms=time_ms(torch, lambda: gather_cuda.gather_rows_plain(table, idx), 5),
        library_ms=time_ms(torch, lambda: torch.index_select(table, 0, clamped), 20),
        library_call="torch.index_select on the clamped indices",
        max_abs_err=0.0, tol="bit-identical rows", bound_ms=bms, bound_by=bby, bytes=nbytes)
    log(entry)
    return {("gather", "float32"): entry}


def kernel_phase(torch, dev):
    from nsgp_repre_tpu_torch.ops import _ext, nms, nms_cuda

    g = torch.Generator().manual_seed(SEED)
    shapes = level_shapes()
    results = {}

    results.update(conv_phase(torch, dev, g, 1))
    results.update(conv_phase(torch, dev, torch.Generator(device=dev).manual_seed(SEED + 7),
                              TRAIN_BATCH))

    # ---- nms: proposals (5 levels, 8304 boxes, IoU 0.7, 1000 kept) and
    # multiclass (1000 x 20 boxes, IoU 0.5, 100 kept), batch 1 ----
    ks = [min(2000, h * wd * A) for h, wd in shapes]
    cases = []
    n = sum(ks)
    boxes = proposal_like_boxes(torch, g, n)
    lvls = torch.cat([torch.full((k,), i, dtype=torch.int32) for i, k in enumerate(ks)])
    cases.append(("proposals", boxes, torch.rand(n, generator=g), lvls,
                  (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1]), 0.7, 1000))
    rois = proposal_like_boxes(torch, g, 1000)
    mboxes = (rois[:, None, :] + torch.randn(1000, 20, 4, generator=g) * 4).reshape(-1, 4)
    mscores = torch.softmax(torch.randn(1000, 21, generator=g) * 3, -1)[:, :20].reshape(-1)
    labels = torch.arange(20, dtype=torch.int32).repeat(1000)
    cases.append(("multiclass", mboxes, mscores, labels, mscores > 0.05, 0.5, 100))
    nms_err_free = True
    k_ms = p_ms = 0.0
    nbytes = flops = 0
    for label, bx, sc, ids, valid, thr, max_out in cases:
        bx, ids, valid = bx[None].to(dev), ids[None].to(dev), valid[None].to(dev)
        for score_kind in ("float32", "bfloat16"):
            # bf16-valued scores tie often: exercises the tie order
            s = sc[None].to(dev)
            if score_kind == "bfloat16":
                s = s.to(torch.bfloat16).float()
            shifted = nms.offset_boxes(bx, ids, valid)
            ki, kv = nms_cuda.nms_kernel(shifted, s, valid, thr, max_out)
            pi, pv = nms.nms(shifted, s, valid, thr, max_out)
            same = torch.equal(kv, pv) and torch.equal(ki[kv], pi[pv])
            nms_err_free &= same
            log(dict(kernel="nms", case=label, scores=score_kind, kept=int(kv.sum()),
                     identical_keep_lists=same))
        k_ms += time_ms(torch, lambda: nms_cuda.nms_kernel(shifted, s, valid, thr, max_out), 20)
        p_ms += time_ms(torch, lambda: nms.nms(shifted, s, valid, thr, max_out), 2, warmup=1)
        nb, fl = nms_work(torch, nms_cuda, shifted, s, valid, ki, kv, max_out)
        nbytes += nb
        flops += fl
    check("nms", nms_err_free, "kernel and plain keep lists differ")
    bms, bby = bound(nbytes, flops, "float32")
    results[("nms", "float32")] = dict(
        kernel="nms", dtype="float32", launches_per_predict=2, kernel_ms=k_ms, plain_ms=p_ms,
        library_ms=None, max_abs_err=0.0, tol="identical keep lists", bound_ms=bms,
        bound_by=bby, bytes=nbytes, flops=flops)
    log(results[("nms", "float32")])

    # ---- nms at the train step's proposal call: 16 images x 8304 candidates ----
    B = TRAIN_BATCH
    boxes = proposal_like_boxes(torch, g, B * n).reshape(B, n, 4).to(dev)
    s = torch.rand(B, n, generator=g).to(dev)
    ids = lvls[None].expand(B, n).contiguous().to(dev)
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    shifted = nms.offset_boxes(boxes, ids, valid)
    ki, kv = nms_cuda.nms_kernel(shifted, s, valid, 0.7, 1000)
    pi, pv = nms.nms(shifted[:1], s[:1], valid[:1], 0.7, 1000)  # the plain version: one image
    same = torch.equal(kv[:1], pv) and torch.equal(ki[:1][kv[:1]], pi[pv])
    check("nms train shape", same, "kernel and plain keep lists differ (image 0)")
    nbytes, flops = nms_work(torch, nms_cuda, shifted, s, valid, ki, kv, 1000)
    bms, bby = bound(nbytes, flops, "float32")
    run = lambda: nms_cuda.nms_kernel(shifted, s, valid, 0.7, 1000)  # noqa: E731
    results[("nms", "float32", TRAIN_BATCH)] = dict(
        kernel="nms", dtype="float32", batch=B, candidates_per_image=n, launches_per_step=1,
        kernel_ms=time_ms(torch, run, 10), device_ms=device_ms(torch, run, 5),
        kept_per_image=kv.sum(1).tolist(), identical_keep_lists_image0=same,
        bound_ms=bms, bound_by=bby, bytes=nbytes, flops=flops)
    log(results[("nms", "float32", TRAIN_BATCH)])

    results.update(roi_align_fwd_phase(torch, dev, g))
    _ext.reset_launches()  # comparison launches are not main-path launches
    return results


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def seeded_images(n: int, seed: int):
    """Seeded uint8 RGB images of IMAGE_HW: coarse random blocks plus noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    H, W = IMAGE_HW
    out = []
    for _ in range(n):
        coarse = rng.randint(0, 255, (H // 16 + 1, W // 16 + 1, 3)).astype(np.float32)
        img = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:H, :W]
        img += rng.randn(H, W, 3).astype(np.float32) * 20
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def condition_weights(torch, model, images_batch):
    """Make the seeded random R-50 behave like a trained one where the
    checks need it: each frozen BN gets the statistics of its own input on
    the seeded images (so activations neither explode nor vanish through
    16 residual blocks) and a random affine, and the objectness and class
    weights are scaled up so scores separate instead of near-tying
    (with N(0, 0.01) heads every score sits near 1/2 or 1/16)."""
    from nsgp_repre_tpu_torch.engine.train import normalize_images
    from nsgp_repre_tpu_torch.models.layers import FrozenBatchNorm

    g = torch.Generator().manual_seed(SEED + 1)

    def calibrate(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3)))
        c = bn.weight.numel()
        bn.weight.copy_((torch.rand(c, generator=g) + 0.5).to(bn.weight.device))
        bn.bias.copy_((torch.rand(c, generator=g) - 0.5).to(bn.bias.device))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    with torch.no_grad():
        model.extract_feat(normalize_images(images_batch))
        for h in hooks:
            h.remove()
        model.rpn_head.rpn_cls.weight.mul_(20.0)
        for fc in model.bbox_head.fc_cls:
            fc.weight.mul_(10.0)


def match_fraction(card: dict, cpu: dict, iou_min: float = 0.99) -> float:
    """Share of the card's detections with a CPU detection of the same
    label at IoU >= iou_min."""
    import numpy as np

    cb, cl = card["boxes"], card["labels"]
    if len(cb) == 0:
        return 1.0 if len(cpu["boxes"]) == 0 else 0.0
    pb, pl = cpu["boxes"], cpu["labels"]
    lt = np.maximum(cb[:, None, :2], pb[None, :, :2])
    rb = np.minimum(cb[:, None, 2:], pb[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.maximum(area(cb)[:, None] + area(pb)[None, :] - inter, 1e-6)
    ok = ((iou >= iou_min) & (cl[:, None] == pl[None, :])).any(1)
    return float(ok.mean())


def check_detections(name, dets, n_images, num_active=15):
    import numpy as np

    check(name, len(dets) == n_images, f"{len(dets)} results for {n_images} images")
    total = 0
    for d in dets:
        b, s, l = d["boxes"], d["scores"], d["labels"]
        total += len(b)
        check(name, b.shape[1:] == (4,) and len(b) <= 100, f"boxes {b.shape}")
        check(name, np.isfinite(b).all() and np.isfinite(s).all(), "non-finite output")
        check(name, ((s > 0.05) & (s <= 1.0)).all(), "score outside (0.05, 1]")
        check(name, ((l >= 0) & (l < num_active)).all(), "label of a future task")
        H, W = IMAGE_HW
        check(name, (b[:, [0, 2]] >= 0).all() and (b[:, [0, 2]] <= W).all()
              and (b[:, [1, 3]] >= 0).all() and (b[:, [1, 3]] <= H).all(), "box off the image")
    check(name, total > 0, "no detections")
    return total


def profile_call(torch, fn, label: str) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    sum of device time against the host-clock wall time, and the idle
    share. A profile without device time fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only (kernels, copies), so nothing counts twice
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total", 0) or 0
        # a user annotation (the optimizer's record_function scope) spans
        # kernels that are counted on their own
        span = getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer.")
        if e.device_type == DeviceType.CUDA and d > 0 and not span \
                and not e.key.startswith("Activity"):
            rows.append((d / 1e3, e.count, e.key[:80]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(f"profile {label}", busy > 0, "no device time recorded")
    log({"phase": f"profile {label}", "wall_ms": wall, "device_ms": busy,
         "idle_share": 1 - busy / wall,
         "top": [{"ms": ms, "calls": n, "name": k} for ms, n, k in rows[:15]],
         # the port's own kernels (csrc/*.cu, all in anonymous namespaces)
         "port_kernels": [{"ms": ms, "calls": n, "name": k} for ms, n, k in rows if k.startswith(
             ("(anonymous namespace)::", "void (anonymous namespace)::"))]})


def slice_phase(torch, card: str):
    import copy

    from nsgp_repre_tpu_torch.apis.inference import _pack_images, inference_detector, init_detector
    from nsgp_repre_tpu_torch.ops import _ext
    from nsgp_repre_tpu_torch.utils.config import load_config

    cfg16 = load_config(CONFIG)
    check("config", cfg16.get("compute_dtype") == "bfloat16", cfg16.get("compute_dtype"))
    cfg32 = copy.deepcopy(cfg16)
    cfg32["compute_dtype"] = "float32"
    imgs = seeded_images(16, SEED)

    t0 = time.perf_counter()
    det32 = init_detector(cfg32, device="cuda", seed=SEED)
    check("model", tuple(det32.model.config.backbone_blocks) == (3, 4, 6, 3), "not R-50")
    condition_weights(torch, det32.model, _pack_images(det32, imgs[:1]).images)
    state = {k: v.detach().cpu().clone() for k, v in det32.model.state_dict().items()}
    det16 = init_detector(cfg16, device="cuda", seed=SEED)
    det16.model.load_state_dict(state)
    log({"phase": "init", "seconds": time.perf_counter() - t0,
         "params": sum(p.numel() for p in det16.model.parameters())})

    # ---- bf16, batch 1: the main path; every kernel must launch ----
    inference_detector(det16, imgs[0])  # warm-up (allocator, cuDNN plans)
    torch.cuda.synchronize()
    _ext.reset_launches()
    out1 = inference_detector(det16, imgs[0])
    torch.cuda.synchronize()
    launches_b1 = dict(_ext.LAUNCHES)
    log({"phase": "predict bf16 batch 1", "launches": launches_b1,
         "detections": len(out1["boxes"])})
    check("batch-1 launches", launches_b1 == EXPECTED_B1, f"{launches_b1} != {EXPECTED_B1}")
    check_detections("bf16 batch 1", [out1], 1)

    # ---- bf16, batch 16: library convs, NMS and RoIAlign kernels ----
    inference_detector(det16, imgs)
    torch.cuda.synchronize()
    _ext.reset_launches()
    out16 = inference_detector(det16, imgs)
    torch.cuda.synchronize()
    launches_b16 = dict(_ext.LAUNCHES)
    log({"phase": "predict bf16 batch 16", "launches": launches_b16,
         "detections": sum(len(o["boxes"]) for o in out16)})
    check("batch-16 launches", launches_b16 == EXPECTED_B16, f"{launches_b16} != {EXPECTED_B16}")
    check_detections("bf16 batch 16", out16, 16)

    # ---- f32, batch 1: card (kernels) against CPU (plain versions) ----
    torch.set_num_threads(os.cpu_count() or 1)
    det_cpu = init_detector(cfg32, device="cpu", seed=SEED)
    det_cpu.model.load_state_dict(state)
    card32 = inference_detector(det32, imgs[0])
    t0 = time.perf_counter()
    cpu32 = inference_detector(det_cpu, imgs[0])
    cpu_s = time.perf_counter() - t0
    check_detections("f32 card batch 1", [card32], 1)
    frac = match_fraction(card32, cpu32)
    log({"phase": "f32 batch 1, card vs cpu", "card_detections": len(card32["boxes"]),
         "cpu_detections": len(cpu32["boxes"]), "matched_fraction": frac,
         "cpu_seconds": cpu_s})
    # 95%, not 100%: the card's convs and the CPU's sum in other orders,
    # and f32 differences of ~1e-6 can reorder near-tied scores at the
    # 2000-per-level top-k cut and in NMS, which swaps a few proposals and
    # the detections built on them; a wrong kernel moves most detections.
    check("f32 card vs cpu", frac >= 0.95, f"matched {frac:.3f} < 0.95")

    # ---- bf16 latency (batch 1) and throughput (batch 16) ----
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        inference_detector(det16, imgs[0])
        lat.append((time.perf_counter() - t0) * 1e3)
    thr = []
    for _ in range(5):
        t0 = time.perf_counter()
        inference_detector(det16, imgs)
        thr.append(16 / (time.perf_counter() - t0))
    log({"phase": "speed", "card": card, "dtype": "bfloat16",
         "batch1_latency_ms_median": statistics.median(lat), "batch1_latency_ms_all": lat,
         "batch16_img_per_s_median": statistics.median(thr), "batch16_img_per_s_all": thr,
         "measured": "host clock around inference_detector (pack, H2D, predict, D2H)"})
    profile_call(torch, lambda: inference_detector(det16, imgs[0]), "predict bf16 batch 1")
    profile_call(torch, lambda: inference_detector(det16, imgs), "predict bf16 batch 16")
    return launches_b1, state


# ---------------------------------------------------------------------------
# training kernels, at the batch-16 training shapes
# ---------------------------------------------------------------------------

def train_kernel_phase(torch, dev):
    import numpy as np

    from nsgp_repre_tpu_torch.ops import _ext, assign_cuda, roi_align, roi_align_cuda
    from nsgp_repre_tpu_torch.ops.anchors import AnchorGenerator

    g = torch.Generator().manual_seed(SEED + 2)
    shapes = level_shapes()
    results = {}
    B, G = TRAIN_BATCH, GT_CAPACITY

    # ---- assign: the anchors of the 608x1024 canvas, 1-8 valid gts per image ----
    anchors = torch.from_numpy(np.concatenate(AnchorGenerator().grid_anchors(shapes))).to(dev)
    N = anchors.shape[0]
    check("anchors", N == 155_520, N)
    n_valid = torch.arange(B) % 8 + 1
    gt_valid = (torch.arange(G)[None] < n_valid[:, None]).to(dev)
    prior_valid = (torch.rand(B, N, generator=g) > 0.02).to(dev)
    gt = proposal_like_boxes(torch, g, B * G).reshape(B, G, 4).to(dev)
    tied = gt.clone()
    tied[:, 1] = tied[:, 0]  # a duplicated gt: argmax and claim ties
    tied[:, 2] = anchors[5000:5000 + B]  # a gt equal to an anchor (IoU exactly 1)
    thr = (0.7, 0.3, 0.3)
    assign_err = 0.0  # assigned and max_overlaps must be exact; the targets' error
    for case, boxes in (("random", gt), ("ties", tied)):
        got = assign_cuda.rpn_assign_targets(anchors, boxes, gt_valid, prior_valid, *thr)
        ref = assign_cuda.rpn_assign_targets_plain(anchors, boxes, gt_valid, prior_valid, *thr)
        torch.cuda.synchronize()
        same_assigned = torch.equal(got[0], ref[0])
        same_iou = torch.equal(got[1], ref[1])
        tgt_err = (got[2] - ref[2]).abs().max().item()
        tgt_scale = max(1.0, ref[2].abs().max().item())
        assign_err = max(assign_err, tgt_err)
        log(dict(kernel="assign", case=case, positives=int((got[0] >= 0).sum()),
                 identical_assigned=same_assigned, bit_equal_max_overlaps=same_iou,
                 tgt_max_abs_err=tgt_err))
        check(f"assign {case}", same_assigned and same_iou,
              "assigned or max_overlaps differ from the plain version")
        # the targets: the same f32 operations; logf may round an ulp apart
        check(f"assign {case} targets", tgt_err <= 1e-5 * tgt_scale,
              f"tgt max_abs_err {tgt_err} > 1e-5 * max(1, max|plain|)")
    # the work this data needs: the kernel skips padded gt slots
    V = int(n_valid.sum())
    flops = V * N * (2 * IOU_FLOPS + 3) + B * N * 16
    nbytes = N * 16 + B * G * 17 + B * N * 1 + B * N * (4 + 4 + 16)
    bms, bby = bound(nbytes, flops, "float32")
    args = (anchors, gt, gt_valid, prior_valid, *thr)
    results[("assign", "float32")] = dict(
        kernel="assign", dtype="float32", launches_per_step=1,
        kernel_ms=time_ms(torch, lambda: assign_cuda.rpn_assign_targets(*args), 20),
        plain_ms=time_ms(torch, lambda: assign_cuda.rpn_assign_targets_plain(*args), 3),
        library_ms=None, max_abs_err=assign_err,
        tol="identical assigned, bit-equal max_overlaps, tgt within 1e-5 * max(1, max|plain|)",
        bound_ms=bms, bound_by=bby, bytes=nbytes, flops=flops, valid_gts=V,
        flops_if_padded_slots_counted=B * G * N * (2 * IOU_FLOPS + 3) + B * N * 16)
    log(results[("assign", "float32")])

    # ---- roi_align_bwd: 512 RoIs per image over P2-P5 of 16 images, on two
    # RoI sets (proposal-like; sampler-like, whose positives pile onto hot
    # tiles), at ss = 2 (the student) and ss = 1 (the teacher's grid) ----
    R = 512 * B
    level_hw = shapes[:4]
    rows = B * sum(h * w for h, w in level_hw)
    sets = {"proposals": (proposal_like_boxes(torch, g, R),
                          torch.arange(B, dtype=torch.int32).repeat_interleave(512)),
            "sampler": sampler_like_boxes(torch, g, B, 512)}
    g32 = torch.randn(R, 7, 7, C, generator=g)
    for set_name, (rois, bidx) in sets.items():
        rois, bidx = rois.to(dev), bidx.to(dev)
        lvl = roi_align.map_roi_levels(rois, 4)
        for ss in (2, 1):
            # the binning pass's footprints against their plain rule
            kf = roi_align_cuda.roi_footprints(level_hw, rois, STRIDES[:4], sampling_ratio=ss)
            pf = roi_align.roi_footprints(level_hw, rois, STRIDES[:4], sampling_ratio=ss)
            check(f"roi footprints {set_name} ss={ss}",
                  all(torch.equal(a, b) for a, b in zip(kf, pf)), "kernel and plain rule differ")
            for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
                size = 2 if dt == torch.bfloat16 else 4
                gout = g32.to(dev, dt)

                def kernel(gout=gout, dt=dt, rois=rois, bidx=bidx, ss=ss):
                    return roi_align_cuda.multilevel_roi_align_backward(
                        gout, rois, bidx, level_hw, B, dt, strides=STRIDES[:4], sampling_ratio=ss)

                def plain(gout=gout, dt=dt, rois=rois, bidx=bidx, ss=ss):
                    return roi_align.multilevel_roi_align_backward(
                        gout, rois, bidx, level_hw, B, dt, strides=STRIDES[:4], sampling_ratio=ss)

                got, again, ref = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, ref))
                scale = max(y.float().abs().max().item() for y in ref)
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                del got, again, ref
                if dt == torch.float32:
                    # f32 sums of the same tap products, in another order
                    tol, tol_desc = 1e-5 * max(1.0, scale), "1e-5 * max(1, max|plain|)"
                else:
                    # one bf16 rounding of f32 sums that differ in order only
                    tol, tol_desc = 2 ** -7 * scale, "2**-7 * max|plain|"
                label = f"roi_align_bwd {dt_name} {set_name} ss={ss}"
                check(label, err <= tol, f"max_abs_err {err} > {tol_desc}")
                # each output summed by one thread in RoI order, no atomics
                check(label, same, "two calls of the kernel differ")
                flops = R * 49 * ss * ss * 4 * 2 * C + R * 49 * C
                nbytes = R * 49 * C * size + R * 16 + R * 4 + rows * C * size
                bms, bby = bound(nbytes, flops, dt_name)
                entry = dict(
                    kernel="roi_align_bwd", dtype=dt_name, rois=set_name, sampling_ratio=ss,
                    launches_per_step=1, max_abs_err=err, tol=tol_desc, bit_identical_reruns=same,
                    library_ms=None, bound_ms=bms, bound_by=bby, bytes=nbytes, flops=flops,
                    level_grad_rows=rows, rois_by_level=torch.bincount(lvl, minlength=4).tolist())
                if dt == torch.bfloat16 or (set_name == "proposals" and ss == 2):
                    entry.update(kernel_ms=time_ms(torch, kernel, 10),
                                 device_ms=device_ms(torch, kernel, 5),
                                 plain_ms=time_ms(torch, plain, 2, warmup=1))
                if dt == torch.bfloat16 and ss == 2:
                    # the RoIs of one level at a time: the tiles of that level
                    # (the other levels' blocks find no RoI and write zeros)
                    def one_level(i, gout=gout, dt=dt, rois=rois, bidx=bidx):
                        m = lvl == i
                        gm, rm, bm = gout[m], rois[m], bidx[m]
                        return device_ms(
                            torch, lambda: roi_align_cuda.multilevel_roi_align_backward(
                                gm, rm, bm, level_hw, B, dt, strides=STRIDES[:4]), 5)

                    entry["device_ms_by_level"] = [one_level(i) for i in range(4)]
                log(entry)
                key = ("roi_align_bwd", dt_name)
                if set_name == "proposals" and ss == 2:
                    results[key] = entry
                    entry["cases"] = {}
                else:
                    main = results[key]
                    main["max_abs_err"] = max(main["max_abs_err"], err)
                    main["cases"][f"{set_name} ss={ss}"] = {
                        k: entry[k] for k in ("kernel_ms", "device_ms", "plain_ms", "bound_ms",
                                              "max_abs_err", "device_ms_by_level") if k in entry}
    _ext.reset_launches()  # comparison launches are not main-path launches
    return results


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def capture_hidden(torch, model):
    """Record, on the host, the sparse RPN head's pre-ReLU hidden values
    (M, F) at the sampled positions as ``at_positions`` computes them; the
    method is wrapped on this instance until its attribute is deleted."""
    head, store = model.rpn_head, []

    def at_positions(patches, _orig=head.at_positions):
        with torch.no_grad():
            k = head.rpn_conv.weight.to(patches.dtype).permute(2, 3, 1, 0)
            h = patches.reshape(patches.shape[0], -1) @ k.reshape(-1, k.shape[-1])
            store.append((h + head.rpn_conv.bias.to(patches.dtype)).float().cpu())
        return _orig(patches)

    head.at_positions = at_positions
    return store


def train_phase(torch, card: str, state):
    import copy

    from nsgp_repre_tpu_torch.apis.inference import init_detector
    from nsgp_repre_tpu_torch.engine.runner import build_train_optimizer
    from nsgp_repre_tpu_torch.engine.train import TrainState, make_train_step
    from nsgp_repre_tpu_torch.ops import _ext
    from nsgp_repre_tpu_torch.testing import demo_det_batch, split_loss_and_grads
    from nsgp_repre_tpu_torch.utils.config import load_config

    cfg16 = load_config(CONFIG)
    model = init_detector(cfg16, device="cuda", seed=SEED).model
    model.load_state_dict(state)
    batch = demo_det_batch(TRAIN_BATCH, *CANVAS, num_instances=tuple(range(1, 9)),
                           num_classes=15, gt_capacity=GT_CAPACITY, seed=SEED, device="cuda")
    opt = build_train_optimizer(cfg16, model, STEPS_PER_EPOCH)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    check("trainable mask", 0 < len(trainable) < len(before), f"{len(trainable)} of {len(before)}")
    step = make_train_step(model, opt)
    st = TrainState(opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def finite(metrics, label):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).item()]
        check(f"train {label}", not bad, f"non-finite {bad}")

    for i in range(2):  # warm-up: allocator, cuDNN plans
        st, metrics = step(st, batch, gen)
        finite(metrics, f"warm-up step {i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, launches = [], [], None
    for i in range(10):
        _ext.reset_launches()
        t0 = time.perf_counter()
        st, metrics = step(st, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        step_launches = dict(_ext.LAUNCHES)
        check(f"train step {i} launches", step_launches == EXPECTED_TRAIN,
              f"{step_launches} != {EXPECTED_TRAIN}")
        launches = step_launches
        finite(metrics, f"step {i}")
        losses.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated()
    frozen_moved = [n for n in before if n not in trainable
                    and not torch.equal(before[n], model.get_parameter(n).detach())]
    still = [n for n in trainable if torch.equal(before[n], model.get_parameter(n).detach())]
    check("frozen parameters", not frozen_moved, f"moved: {frozen_moved[:5]}")
    check("trainable parameters", not still, f"did not move: {still[:5]}")
    med = statistics.median(times)
    log({"phase": "train bf16 batch 16", "card": card, "launches_per_step": launches,
         "step_ms_median": med, "step_ms_all": times, "img_per_s": TRAIN_BATCH / med * 1e3,
         "max_memory_allocated_bytes": peak, "steps_taken": st.step,
         "lr_last": float(opt.lr()), "losses_first": losses[0], "losses_last": losses[-1],
         "frozen_params": len(before) - len(trainable), "trainable_params": len(trainable),
         "measured": "host clock around make_train_step's step, ending in torch.cuda.synchronize"})
    profile_call(torch, lambda: step(st, batch, gen), "train bf16 batch 16 (one step)")
    del model, opt, st, step
    torch.cuda.empty_cache()

    # ---- f32, batch 1: card (kernels) against CPU (plain versions) ----
    cfg32 = copy.deepcopy(cfg16)
    cfg32["compute_dtype"] = "float32"
    on_card = init_detector(cfg32, device="cuda", seed=SEED).model
    on_card.load_state_dict(state)
    on_cpu = init_detector(cfg32, device="cpu", seed=SEED).model
    on_cpu.load_state_dict(state)
    b1 = demo_det_batch(1, *CANVAS, num_instances=(6,), num_classes=15, gt_capacity=GT_CAPACITY,
                        seed=SEED + 3)
    n_anchors = sum(h * w * A for h, w in level_shapes())
    pg = torch.Generator().manual_seed(SEED + 4)
    n_cand = GT_CAPACITY + on_card.config.rpn_max_per_img
    pri = {"rpn": torch.rand(1, n_anchors, generator=pg), "roi": torch.rand(1, n_cand, generator=pg),
           "roi2": torch.rand(1, n_cand, generator=pg)}
    hidden_card, hidden_cpu = capture_hidden(torch, on_card), capture_hidden(torch, on_cpu)
    _ext.reset_launches()
    got_l, got_g, props = split_loss_and_grads(on_card, b1, pri)
    torch.cuda.synchronize()
    f32_launches = dict(_ext.LAUNCHES)
    t0 = time.perf_counter()
    ref_l, ref_g, _ = split_loss_and_grads(on_cpu, b1, pri, proposals=props)
    cpu_s = time.perf_counter() - t0
    del on_card.rpn_head.at_positions, on_cpu.rpn_head.at_positions
    # the sparse RPN head's ReLUs that the two devices decide differently:
    # the same sampled positions on both sides (same priorities, assign
    # identical), so the pre-ReLU values compare element by element
    hc, hp = hidden_card[0], hidden_cpu[0]
    check("sparse-head positions", hc.shape == hp.shape, f"{tuple(hc.shape)} != {tuple(hp.shape)}")
    flipped = (hc > 0) != (hp > 0)
    flips = int(flipped.sum())
    relu_witness = {"hidden_values": hp.numel(), "relu_flips": flips,
                    "min_abs_hidden_cpu": hp.abs().min().item(),
                    "max_abs_hidden_cpu": hp.abs().max().item(),
                    "flipped_card": hc[flipped][:8].tolist(), "flipped_cpu": hp[flipped][:8].tolist()}
    check("f32 launches", all(f32_launches[k] == EXPECTED_TRAIN[k]
                              for k in ("assign", "roi_align", "roi_align_bwd")), f32_launches)

    def grad_rel(a, b):
        return {k: (a[k] - b[k]).abs().max().item() / max(b[k].abs().max().item(), 1e-12)
                for k in b}

    # the f32 noise floor of these gradients: the CPU run again with every
    # weight scaled by (1 + 1e-7 N(0, 1)), about an ulp; through the 16
    # blocks of the trunk this alone moves layer2's gradients by ~2%
    gen = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for p in on_cpu.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    _, noisy_g, _ = split_loss_and_grads(on_cpu, b1, pri, proposals=props)
    group = lambda k: ".".join(k.split(".")[:2])
    floor = {}
    for k, v in grad_rel(noisy_g, ref_g).items():
        floor[group(k)] = max(floor.get(group(k), 0.0), v)
    # acc as an absolute difference (one RoI of 512 that flips moves it by
    # 1/512), the losses relative to their size
    loss_rel = {k: abs(got_l[k] - ref_l[k]) / (1.0 if k == "acc" else max(abs(ref_l[k]), 1e-3))
                for k in ref_l}
    check("f32 gradients", got_g.keys() == ref_g.keys(), "different parameters got gradients")
    card_rel = grad_rel(got_g, ref_g)
    # each gradient within 4x its module group's noise floor: cuDNN and the
    # CPU sum the f32 convs in other orders, forward and backward, and the
    # RoIAlign backward sums its taps in another order than index_add_,
    # each an ulp-sized perturbation. The sampled anchors and RoIs are the same (same
    # priorities, the card's proposals on both sides). rpn_conv alone may
    # also take 5e-3 of its largest magnitude for each ReLU of the sparse
    # head that the two devices decided differently (counted above): a
    # flip adds or drops one sampled position's share (~1/256) of its
    # gradient; with no flip it gets no slack.
    def tol(k):
        slack = 5e-3 * flips if k.startswith("rpn_head.rpn_conv.") else 0.0
        return 4 * floor[group(k)] + slack

    ratio = {k: v / tol(k) for k, v in card_rel.items()}
    worst = sorted(ratio.items(), key=lambda kv: -kv[1])[:5]
    by_group = {}
    for k, v in card_rel.items():
        by_group[group(k)] = max(by_group.get(group(k), 0.0), v)
    log({"phase": "train f32 batch 1, card vs cpu", "losses_card": got_l, "losses_cpu": ref_l,
         "loss_rel_err": loss_rel, "grad_rel_err_by_group": by_group, "noise_floor_by_group": floor,
         "sparse_head_relu": relu_witness,
         "worst_err_over_tolerance": [(k, r, card_rel[k]) for k, r in worst],
         "params_with_grad": len(ref_g), "cpu_seconds": cpu_s})
    # loss terms within 1e-3 relative (the same sums, reordered)
    for k, v in loss_rel.items():
        lim = 2.0 / on_card.config.rcnn_num if k == "acc" else 1e-3
        check(f"f32 {k}", v <= lim, f"card {got_l[k]} cpu {ref_l[k]}")
    check("f32 gradients", worst[0][1] <= 1.0, f"worst (name, err/tol, err) {worst}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU", file=sys.stderr)
        return 2
    try:
        from nsgp_repre_tpu_torch.ops import _ext
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        log(card)
        try:
            import triton

            triton_info = f"import triton: ok ({triton.__version__})"
        except Exception as e:  # noqa: BLE001 — recorded, not needed
            triton_info = f"import triton: fails ({type(e).__name__}: {e})"
        nvcc = _ext.nvcc_path()
        nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                timeout=60).stdout.strip().splitlines()
        log({"phase": "toolchain", "torch": torch.__version__, "torch.version.cuda": torch.version.cuda,
             "nvcc": nvcc, "nvcc_version": nvcc_v[-2:] if nvcc_v else None, "triton": triton_info,
             "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
             "device_count": torch.cuda.device_count()})

        t0 = time.perf_counter()
        _ext.build(verbose=True)
        _ext.lib()
        log({"phase": "build", "seconds": time.perf_counter() - t0})

        dev = torch.device("cuda")
        results = kernel_phase(torch, dev)
        results.update(gather_phase(torch, dev))
        launches_b1, state = slice_phase(torch, card)
        results.update(train_kernel_phase(torch, dev))
        launches_train = train_phase(torch, card, state)

        kernels = []
        for name in KERNELS:
            r = results[(name, "bfloat16")] if (name, "bfloat16") in results else results[(name, "float32")]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                # each main path counted from zero: one batch-1 predict, one train step
                "launches": launches_b1[name] + launches_train[name],
                "launches_by_path": {"predict_batch1": launches_b1[name],
                                     "train_step": launches_train[name]},
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "dtype": r["dtype"],
            })
            if "device_ms" in r:  # device time beside the eager calls
                kernels[-1]["device_ms"] = r["device_ms"]
            for k in ("by_size", "cases"):  # roi_align at train / batch-16 sizes; roi_align_bwd's sets
                if k in r:
                    kernels[-1][k] = r[k]
            if name == "nms":  # the train step's call: 16 images
                r16 = results[("nms", "float32", TRAIN_BATCH)]
                kernels[-1]["batch16"] = {k: r16[k] for k in ("bound_ms", "device_ms")} | {
                    "ms": r16["kernel_ms"]}
            if "library_device_ms" in r:  # the conv kernels, also at batch 16
                kernels[-1]["library_device_ms"] = r["library_device_ms"]
                r16 = results[(name, "bfloat16", TRAIN_BATCH)]  # 16 images (the train step's rpn_head)
                kernels[-1]["batch16"] = {k: r16[k] for k in (
                    "plain_ms", "library_ms", "device_ms", "library_device_ms", "bound_ms",
                    "max_abs_err")} | {"ms": r16["kernel_ms"]}
        log(card)
        log({"kernels": kernels})
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
