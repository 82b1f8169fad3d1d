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
   called twice for the same bits; NMS, two calls bit for bit, also at the
   train step's proposal call (16 images x 8,304) and predict batch 16's
   multiclass call (16 x 20,000), every image against the plain version,
   with the IoUs its walk evaluated (counted on the card); the RoIAlign
   forward also at the train step's 8,192 RoIs and
   predict batch 16's 16,000, two calls bit for bit; the row gather (no
   caller) on a table of 400,000 4-KB rows;
4. slice: full-width Faster R-CNN R-50-FPN (15+5 VOC config, task 1) built
   by ``init_detector`` with seeded weights and driven by
   ``inference_detector``: bf16 at batch 1 (every predict kernel must
   launch) and at batch 16, the batch-1 f32 result on the card against
   the same weights on the CPU through the plain versions, latency and
   throughput;
5. training kernels: the anchor assignment (two calls bit for bit, its
   device time) and the RoIAlign backward
   against their plain versions at the batch-16 training shapes, the
   backward on proposal-like and sampler-like RoIs (hot tiles) at ss = 2
   and 1, two calls bit for bit, with device time per level;
6. train: the same model and weights trained by ``make_train_step`` with
   the optimizer ``build_train_optimizer`` builds from the config (bf16,
   batch 16, seeded images and boxes): every training kernel launches
   once per step, losses stay finite, frozen parameters stay bit-equal
   and trainable ones move; the f32 batch-1 loss terms and gradients on
   the card against the CPU; step time, img/s, peak memory, one profiled
   step;
7. task chain, from the slice phase's task-1 weights: the covariance pass over
   2 batches, the NSGP projections on the host (timed), the RoI store
   over 13 batches, the prototypes, the EWC importance over 2 batches;
   then task 2 (15+5 task-2 config: teacher in the step, projections,
   prototypes, EWC): the assign kernel at the merged 164 gt slots against
   its plain version, 2 + 10 steps (launches per step, finite terms, EWC
   nonzero once the weights move), the teacher's detections fed in (the
   same terms bit for bit), frozen parameters and the teacher bit-equal,
   2 raw-replay steps, and the f32 batch-1 task-2 loss and gradients on
   the card against the CPU; each path's launches, step time, peak
   memory, profiles of each pass;
8. runner: tools/torch_train.py's NullSpaceRunner over a synthetic VOC2007
   tree (16 trainval and 16 test images, 600x1000, as binary PPM) at full
   width and depth: task 1 of the 15+5 configs from the predict phase's
   weights (a ``best_*.npz`` written by the port's checkpoint writer),
   then task 2 from task 1's dir (projections, EWC terms, prototypes, the
   teacher's pseudo-label pre-pass, 3 steps fed its cached detections),
   each with validation and the task-end passes; the files of both work
   dirs, the checkpoint keys (JAX paths) and round trip, the teacher
   bit-equal to task 1's best checkpoint, each train()'s launches against
   the batches its passes ran, tools/torch_test.py's detections and mAP
   against the runner's, and a resumed task-2 runner; each stage's
   seconds, the loop's steps/s against the bare step, the loader's share
   of the loop, the decode and copy time of a batch, val img/s and peak
   memory.

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
CONFIG2 = "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_2.py"
CONFIG2_RAW = "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_2_rawreplay.py"
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
# the task chain's paths, as the JAX code implies them: a task-2 step runs
# the teacher's predict at batch 16 (library convs under
# infer_fused_max_batch=1; proposal and multiclass NMS, one RoIAlign) and
# then the student's step; fed teacher_dets, the student's step alone; the
# covariance pass is the loss forward with the taps on (the RPN head
# unfused, no backward); the RoI store is a predict-style RPN and one
# RoIAlign; the importance step is the task-1 loss and its backward
EXPECTED_TEACHER = {"conv3x3": 0, "rpn_head": 0, "nms": 2, "roi_align": 1, "roi_align_bwd": 0,
                    "assign": 0, "gather": 0}
EXPECTED_TASK2 = {k: EXPECTED_TRAIN[k] + EXPECTED_TEACHER[k] for k in EXPECTED_TRAIN}
EXPECTED_COV = {"conv3x3": 0, "rpn_head": 0, "nms": 1, "roi_align": 1, "roi_align_bwd": 0,
                "assign": 1, "gather": 0}
EXPECTED_EXTRACT = {"conv3x3": 0, "rpn_head": 0, "nms": 1, "roi_align": 1, "roi_align_bwd": 0,
                    "assign": 0, "gather": 0}
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


def device_ms(torch, fn, iters: int, only: str = "") -> float:
    """Mean device time of one call of ``fn``: the device-side events
    (kernels, copies) torch.profiler records over ``iters`` calls after a
    warm-up call, summed, without the host's launch gaps between them;
    with ``only``, the events whose name holds it. A profile that comes
    back without device events (seen once in many back-to-back profiles
    on the H100 host) is taken again, up to three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity")
                    and not getattr(e, "is_user_annotation", False) and only in e.key)
        if total > 0:
            break
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
    before it. Also the pairs that makes (reckoned from the keep list)."""
    _, order, nv = nms_cuda.sort_candidates(shifted, s, valid)
    B, N = s.shape
    nbytes = pairs = 0
    for b in range(B):
        pos = torch.empty_like(order[b])
        pos[order[b].long()] = torch.arange(N, dtype=pos.dtype, device=pos.device)
        kept_pos = pos[ki[b][kv[b]].long()].sort().values
        stop = (int(kept_pos[-1]) + 1) if int(kv[b].sum()) == max_out else int(nv[b])
        pairs += int((stop - 1 - kept_pos).clamp(min=0).sum())
        nbytes += N * 16 + N * 4 + 4 + max_out * 4 + 4
    # IoU: 6 min/max/sub + 2 clamps + 3 mul + 3 add/sub + max, div, compare
    return nbytes, 17 * pairs, pairs


def nms_case(torch, nms, nms_cuda, shifted, s, valid, thr: float, max_out: int, label: str):
    """The NMS kernel on one batched call against the plain version on
    every image (valid slots and the zeros of unused ones), two calls bit
    for bit, with its times, bound, and the IoUs its walk evaluated,
    counted on the card by the walk's counting instantiation."""
    ki, kv = nms_cuda.nms_kernel(shifted, s, valid, thr, max_out)
    again = nms_cuda.nms_kernel(shifted, s, valid, thr, max_out)
    ci, cv, ious = nms_cuda.count_ious(shifted, s, valid, thr, max_out)
    pi, pv = nms.nms(shifted, s, valid, thr, max_out)
    torch.cuda.synchronize()
    same = torch.equal(kv, pv) and torch.equal(ki, pi)
    check(f"nms {label}", same, "kernel and plain keep lists differ")
    rerun = all(torch.equal(x, y) for x, y in ((again[0], ki), (again[1], kv), (ci, ki), (cv, kv)))
    check(f"nms {label}", rerun, "two calls of the kernel (or its counting build) differ")
    nbytes, flops, pairs = nms_work(torch, nms_cuda, shifted, s, valid, ki, kv, max_out)
    bms, bby = bound(nbytes, flops, "float32")
    run = lambda: nms_cuda.nms_kernel(shifted, s, valid, thr, max_out)  # noqa: E731
    B, N = s.shape
    entry = dict(
        kernel="nms", dtype="float32", case=label, batch=B, candidates_per_image=N,
        iou_threshold=thr, max_out=max_out, kernel_ms=time_ms(torch, run, 10),
        # the whole call (the wrapper's sort included), and csrc/nms.cu's kernels alone
        device_ms=device_ms(torch, run, 5), nms_kernels_device_ms=device_ms(torch, run, 5, "::nms_"),
        valid_per_image=valid.sum(1).tolist(),
        kept_per_image=kv.sum(1).tolist(), identical_keep_lists_all_images=same,
        bit_identical_reruns=rerun, bound_ms=bms, bound_by=bby, bytes=nbytes, flops=flops,
        ious_evaluated=ious, greedy_pairs_reckoned=pairs,
        upper_triangle_pairs=B * N * (N - 1) // 2)
    log(entry)
    return entry


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
    k_ms = p_ms = d_ms = 0.0
    nbytes = flops = 0
    for label, bx, sc, ids, valid, thr, max_out in cases:
        bx, ids, valid = bx[None].to(dev), ids[None].to(dev), valid[None].to(dev)
        shifted = nms.offset_boxes(bx, ids, valid)
        for score_kind in ("float32", "bfloat16"):
            # bf16-valued scores tie often: exercises the tie order
            s = sc[None].to(dev)
            if score_kind == "bfloat16":
                s = s.to(torch.bfloat16).float()
            r = nms_case(torch, nms, nms_cuda, shifted, s, valid, thr, max_out,
                         f"batch 1 {label} {score_kind} scores")
        # the batch-1 row: each case's call on bf16-valued scores
        k_ms += r["kernel_ms"]
        d_ms += r["device_ms"]
        p_ms += time_ms(torch, lambda: nms.nms(shifted, s, valid, thr, max_out), 2, warmup=1)
        nbytes += r["bytes"]
        flops += r["flops"]
    bms, bby = bound(nbytes, flops, "float32")
    results[("nms", "float32")] = dict(
        kernel="nms", dtype="float32", launches_per_predict=2, kernel_ms=k_ms, device_ms=d_ms,
        plain_ms=p_ms,
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
    results[("nms", "float32", TRAIN_BATCH)] = nms_case(
        torch, nms, nms_cuda, shifted, s, valid, 0.7, 1000, "train call")

    # ---- nms at predict batch 16's multiclass call: 1000 RoIs x 20 classes
    # on each of 16 images, bf16-valued scores (ties), score > 0.05 valid ----
    gm = torch.Generator().manual_seed(SEED + 11)  # its own: later phases keep their inputs
    rois = proposal_like_boxes(torch, gm, B * 1000).reshape(B, 1000, 1, 4)
    mboxes = (rois + torch.randn(B, 1000, 20, 4, generator=gm) * 4).reshape(B, -1, 4).to(dev)
    mscores = torch.softmax(torch.randn(B, 1000, 21, generator=gm) * 3, -1)[..., :20]
    s = mscores.reshape(B, -1).to(torch.bfloat16).float().to(dev)
    labels = torch.arange(20, dtype=torch.int32).repeat(B, 1000).to(dev)
    valid = s > 0.05
    shifted = nms.offset_boxes(mboxes, labels, valid)
    results[("nms", "float32", "multiclass16")] = nms_case(
        torch, nms, nms_cuda, shifted, s, valid, 0.5, 100, "predict batch 16 multiclass")

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
    share; the copies' share of the device time (the host-to-device copy
    of pageable images varies with the host) and the call's peak memory.
    A profile without device time fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    copies = sum(r[0] for r in rows if r[2].startswith(("Memcpy", "Memset")))
    check(f"profile {label}", busy > 0, "no device time recorded")
    log({"phase": f"profile {label}", "wall_ms": wall, "device_ms": busy,
         "copies_ms": copies, "kernels_ms": busy - copies, "idle_share": 1 - busy / wall,
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
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
        again = assign_cuda.rpn_assign_targets(anchors, boxes, gt_valid, prior_valid, *thr)
        ref = assign_cuda.rpn_assign_targets_plain(anchors, boxes, gt_valid, prior_valid, *thr)
        torch.cuda.synchronize()
        same_assigned = torch.equal(got[0], ref[0])
        same_iou = torch.equal(got[1], ref[1])
        # atomicMax on bits: a max, whatever order the blocks fold in
        rerun = all(torch.equal(x, y) for x, y in zip(got, again))
        check(f"assign {case}", rerun, "two calls of the kernel differ")
        tgt_err = (got[2] - ref[2]).abs().max().item()
        tgt_scale = max(1.0, ref[2].abs().max().item())
        assign_err = max(assign_err, tgt_err)
        log(dict(kernel="assign", case=case, positives=int((got[0] >= 0).sum()),
                 identical_assigned=same_assigned, bit_equal_max_overlaps=same_iou,
                 bit_identical_reruns=rerun, tgt_max_abs_err=tgt_err))
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
        device_ms=device_ms(torch, lambda: assign_cuda.rpn_assign_targets(*args), 10),
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

def capture_hidden(torch, model, follow=None):
    """Record, on the host, the sparse RPN head's pre-ReLU hidden values
    (M, F) at the sampled positions as ``at_positions`` computes them; the
    method is wrapped on this instance until its attribute is deleted.
    With ``follow`` (the card's record of the same calls), the hidden ReLU
    decides as it did there: where the two put a value on opposite sides
    of zero, it takes the card's value, h + (h_card - h).detach(), so its
    gradient stays this model's (as follow_relus does for the bbox head)."""
    head, store = model.rpn_head, []

    def at_positions(patches, _orig=head.at_positions):
        dt = patches.dtype
        k = head.rpn_conv.weight.to(dt).permute(2, 3, 1, 0)
        h = patches.reshape(patches.shape[0], -1) @ k.reshape(-1, k.shape[-1])
        h = h + head.rpn_conv.bias.to(dt)
        store.append(h.detach().float().cpu())
        if follow is None:
            return _orig(patches)
        hc = follow[(len(store) - 1) % len(follow)].to(h.device, dt)
        h = torch.relu(h + torch.where((hc > 0) != (h > 0), (hc - h).detach(), torch.zeros_like(h)))
        Fc = h.shape[-1]
        cls = h @ head.rpn_cls.weight.reshape(-1, Fc).t().to(dt) + head.rpn_cls.bias.to(dt)
        reg = h @ head.rpn_reg.weight.reshape(-1, Fc).t().to(dt) + head.rpn_reg.bias.to(dt)
        return cls, reg

    head.at_positions = at_positions
    return store


def capture_fc(torch, model):
    """Record, on the host, the bbox head's shared-FC outputs (the inputs of
    its two ReLUs), call by call, until the returned hooks are removed."""
    store = []
    hooks = [fc.register_forward_hook(
        lambda m, a, y, k=k: store.append((k, y.detach().float().cpu())))
        for k, fc in enumerate(model.bbox_head.shared_fcs)]
    return store, hooks


def follow_relus(torch, model, calls):
    """Make ``model``'s bbox-head ReLUs decide as they did in ``calls``
    (capture_fc's record of the same calls on the card): where the two
    put a shared-FC output on opposite sides of zero, the output takes the
    card's value, y + (y_card - y).detach(), so its gradient stays this
    model's. The flips, which the returned list counts call by call over
    all runs, are thereby taken out of the comparison exactly. Returns
    (counts, hooks)."""
    by_fc = {k: [y for kk, y in calls if kk == k] for k in (0, 1)}
    seen, counts = {0: 0, 1: 0}, []

    def hook(m, args, y, k):
        yc = by_fc[k][seen[k] % len(by_fc[k])].to(y.device)
        seen[k] += 1
        mask = (yc > 0) != (y > 0)
        counts.append(int(mask.sum()))
        return y + torch.where(mask, (yc - y).detach(), torch.zeros_like(y))

    hooks = [fc.register_forward_hook(lambda m, a, y, k=k: hook(m, a, y, k))
             for k, fc in enumerate(model.bbox_head.shared_fcs)]
    return counts, hooks


def train_phase(torch, card: str, state):
    import copy

    from nsgp_repre_tpu_torch.apis.inference import init_detector
    from nsgp_repre_tpu_torch.engine.runner import build_train_optimizer
    from nsgp_repre_tpu_torch.engine.train import TrainState, make_train_step
    from nsgp_repre_tpu_torch.ops import _ext
    from nsgp_repre_tpu_torch.testing import demo_det_batch
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
    card_vs_cpu(torch, "train", on_card, on_cpu, b1, GT_CAPACITY, {}, {})
    return launches, med


def card_vs_cpu(torch, label, on_card, on_cpu, b1, gt_slots, card_kw, cpu_kw):
    """The f32 batch-1 loss terms and gradients of ``on_card`` (kernels)
    against ``on_cpu`` (plain versions), the same weights and priorities:
    testing.split_loss_and_grads with ``card_kw`` / ``cpu_kw`` (a task-2
    loss's merged gt sets, prototypes and EWC terms, on each device), the
    card's proposals fed to the CPU. The loss terms within 1e-3, every
    gradient within 4x its module group's f32 noise floor. The ReLUs of
    the sparse RPN head and of the bbox head on the CPU follow the card's
    decisions where the two differ (capture_hidden, follow_relus; the
    flips are counted and printed), so a near-tie that the devices round
    to opposite sides moves no gradient. Returns the card's launches."""
    from nsgp_repre_tpu_torch.ops import _ext
    from nsgp_repre_tpu_torch.testing import split_loss_and_grads

    n_anchors = sum(h * w * A for h, w in level_shapes())
    pg = torch.Generator().manual_seed(SEED + 4)
    n_cand = gt_slots + on_card.config.rpn_max_per_img
    pri = {"rpn": torch.rand(1, n_anchors, generator=pg), "roi": torch.rand(1, n_cand, generator=pg),
           "roi2": torch.rand(1, n_cand, generator=pg)}
    hidden_card = capture_hidden(torch, on_card)
    hidden_cpu = capture_hidden(torch, on_cpu, follow=hidden_card)
    fc_card, hooks = capture_fc(torch, on_card)
    _ext.reset_launches()
    got_l, got_g, props = split_loss_and_grads(on_card, b1, pri, **card_kw)
    torch.cuda.synchronize()
    f32_launches = dict(_ext.LAUNCHES)
    for h in hooks:
        h.remove()
    # the CPU follows the card's bbox-head ReLU decisions (the same RoIs on
    # both: the card's proposals, the same draws), in this run and in the
    # noise-floor run below
    fc_flips, hooks = follow_relus(torch, on_cpu, fc_card)
    t0 = time.perf_counter()
    ref_l, ref_g, _ = split_loss_and_grads(on_cpu, b1, pri, proposals=props, **cpu_kw)
    cpu_s = time.perf_counter() - t0
    bbox_flips = sum(fc_flips)
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
    check(f"{label} f32 launches", all(f32_launches[k] == EXPECTED_TRAIN[k]
                                       for k in ("assign", "roi_align", "roi_align_bwd")),
          f32_launches)

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
    _, noisy_g, _ = split_loss_and_grads(on_cpu, b1, pri, proposals=props, **cpu_kw)
    for h in hooks:
        h.remove()
    del on_card.rpn_head.at_positions, on_cpu.rpn_head.at_positions
    group = lambda k: ".".join(k.split(".")[:2])
    floor = {}
    for k, v in grad_rel(noisy_g, ref_g).items():
        floor[group(k)] = max(floor.get(group(k), 0.0), v)
    # acc as an absolute difference (one RoI of 512 that flips moves it by
    # 1/512), the losses relative to their size
    loss_rel = {k: abs(got_l[k] - ref_l[k]) / (1.0 if k == "acc" else max(abs(ref_l[k]), 1e-3))
                for k in ref_l}
    check(f"{label} f32 gradients", got_g.keys() == ref_g.keys(),
          "different parameters got gradients")
    card_rel = grad_rel(got_g, ref_g)
    # each gradient within 4x its module group's noise floor: cuDNN and the
    # CPU sum the f32 convs in other orders, forward and backward, and the
    # RoIAlign backward sums its taps in another order than index_add_,
    # each an ulp-sized perturbation. The sampled anchors and RoIs are the
    # same (same priorities, the card's proposals on both sides), and the
    # heads' ReLUs decide alike (followed above, in the noise run too).
    def tol(k):
        return 4 * floor[group(k)]

    # a group whose gradients the jitter left unchanged has a zero floor:
    # it must then match exactly
    ratio = {k: v / tol(k) if tol(k) > 0 else (0.0 if v == 0 else float("inf"))
             for k, v in card_rel.items()}
    worst = sorted(ratio.items(), key=lambda kv: -kv[1])[:5]
    by_group = {}
    for k, v in card_rel.items():
        by_group[group(k)] = max(by_group.get(group(k), 0.0), v)
    log({"phase": f"{label} f32 batch 1, card vs cpu", "losses_card": got_l, "losses_cpu": ref_l,
         "loss_rel_err": loss_rel, "grad_rel_err_by_group": by_group, "noise_floor_by_group": floor,
         "sparse_head_relu": relu_witness, "bbox_head_relu_flips_followed": bbox_flips,
         "worst_err_over_tolerance": [(k, r, card_rel[k]) for k, r in worst],
         "params_with_grad": len(ref_g), "cpu_seconds": cpu_s})
    # loss terms within 1e-3 relative (the same sums, reordered)
    for k, v in loss_rel.items():
        lim = 2.0 / on_card.config.rcnn_num if k == "acc" else 1e-3
        check(f"{label} f32 {k}", v <= lim, f"card {got_l[k]} cpu {ref_l[k]}")
    check(f"{label} f32 gradients", worst[0][1] <= 1.0, f"worst (name, err/tol, err) {worst}")
    return f32_launches


# ---------------------------------------------------------------------------
# task chain: the task-end passes of task 1, then task-2 steps
# ---------------------------------------------------------------------------

def run_path(torch, label, expected, fn):
    """One call of ``fn`` counted from zero: its kernel launches must be
    ``expected``. Returns (result, launches)."""
    from nsgp_repre_tpu_torch.ops import _ext

    _ext.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    check(f"{label} launches", launches == expected, f"{launches} != {expected}")
    return out, launches


def assign_at_merged_g(torch, model, gts, img_shape):
    """The assign kernel at the task-2 step's merged gt capacity (64 gt
    slots + 100 teacher detections) against its plain version on the same
    card tensors: assigned and max_overlaps bit-equal, targets within 1e-5."""
    from nsgp_repre_tpu_torch.ops import assign_cuda

    feats = [torch.empty(1, h, w, 1, device="cuda") for h, w in level_shapes()]
    anchors, sizes = model._anchors(feats)
    valid = model._anchor_valid(sizes, img_shape.cuda())
    cfg = model.config
    args = (anchors, gts.boxes, gts.valid, valid, cfg.rpn_pos_iou_thr, cfg.rpn_neg_iou_thr,
            cfg.rpn_min_pos_iou)
    got = assign_cuda.rpn_assign_targets(*args)
    ref = assign_cuda.rpn_assign_targets_plain(*args)
    torch.cuda.synchronize()
    same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    tgt_err = (got[2] - ref[2]).abs().max().item()
    entry = {"phase": "assign at the merged gt capacity", "gt_slots": int(gts.boxes.shape[1]),
             "valid_gts": gts.valid.sum(1).tolist(), "positives": int((got[0] >= 0).sum()),
             "identical_assigned_and_max_overlaps": same, "tgt_max_abs_err": tgt_err,
             "device_ms": device_ms(torch, lambda: assign_cuda.rpn_assign_targets(*args), 5)}
    log(entry)
    check("assign G=164", same and gts.boxes.shape[1] == GT_CAPACITY + cfg.max_per_img,
          "assigned or max_overlaps differ from the plain version")
    check("assign G=164 targets", tgt_err <= 1e-5 * max(1.0, ref[2].abs().max().item()),
          f"tgt max_abs_err {tgt_err}")


def task_chain_phase(torch, card: str, task1):
    """Task 1's end passes on the task-1 weights ``task1`` (covariances
    over 2 batches, the NSGP projections on the host, the RoI store,
    prototypes, EWC importance over 2 batches), then task 2 (teacher in
    the step, projections, prototypes, EWC): 2 + 10 steps, one step fed
    the teacher's detections, 2 raw-replay steps, and the f32 batch-1
    task-2 loss and gradients card against CPU. Returns the launches per
    path.

    ``task1`` is the slice phase's task-1 model (seeded, its BNs
    calibrated and its classifier scaled), on which predict finds 100
    detections per image. The train phase's 12 steps on noise images
    leave a saturated classifier whose detections on these images
    flipped between ~1,000 and none from one run to the next (that phase
    is not bit-reproducible on the card), which would leave the teacher's
    pseudo-labels empty in some runs."""
    import copy

    import numpy as np

    from nsgp_repre_tpu_torch.apis.inference import Detector, _pack_images, init_detector
    from nsgp_repre_tpu_torch.engine import ewc, nsgp, optim, replay
    from nsgp_repre_tpu_torch.engine.pseudo import merge_pseudo_labels
    from nsgp_repre_tpu_torch.engine.runner import (build_teacher, build_train_optimizer,
                                                    translate_ignore_keys)
    from nsgp_repre_tpu_torch.engine.train import (TrainState, make_cov_step, make_importance_step,
                                                   make_roi_extract_step, make_teacher_step,
                                                   make_train_step, normalize_images, task_losses)
    from nsgp_repre_tpu_torch.models.layers import CovConv, CovDense
    from nsgp_repre_tpu_torch.ops import _ext
    from nsgp_repre_tpu_torch.testing import demo_det_batch
    from nsgp_repre_tpu_torch.utils.config import load_config

    paths = {}

    def batch_of(seed, n=TRAIN_BATCH):
        """The train phase's seeded boxes on the predict phase's seeded
        images: on the train phase's noise images the task-1 model detects
        nothing, and the teacher's pseudo-labels would merge nothing."""
        b = demo_det_batch(n, *CANVAS, num_instances=tuple(range(1, 9)), num_classes=15,
                           gt_capacity=GT_CAPACITY, seed=seed, device="cuda")
        packed = _pack_images(Detector(None, IMAGE_HW[::-1], "cpu"), seeded_images(n, seed))
        return b.replace(images=packed.images.cuda(), img_shape=packed.img_shape.cuda(),
                         ori_shape=packed.ori_shape.cuda(),
                         scale_factor=packed.scale_factor.cuda())

    cfg1 = load_config(CONFIG)
    model = init_detector(cfg1, device="cuda", seed=SEED).model
    model.load_state_dict(task1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    batches = [batch_of(SEED), batch_of(SEED + 1)]

    # ---- 1. covariances over 2 batches (loss forward, taps on, no backward) ----
    cov_step = make_cov_step(model)
    total = None
    for i, b in enumerate(batches):
        cov, paths["cov_step"] = run_path(torch, f"cov step {i}", EXPECTED_COV,
                                          lambda b=b: cov_step(b, gen))
        total = nsgp.accumulate_cov(total, cov)
    bad = [k for k, v in total.items() if not torch.isfinite(v).all()]
    check("covariances", not bad and len(total) == sum(
        isinstance(m, (CovConv, CovDense)) for m in model.modules()), f"non-finite {bad[:3]}")
    log({"phase": "task chain: covariances", "layers": len(total),
         "largest": max((tuple(v.shape) for v in total.values()), key=lambda t: t[0]),
         "bytes": sum(v.numel() * 4 for v in total.values())})
    profile_call(torch, lambda: cov_step(batches[0], gen), "cov step bf16 batch 16")

    # ---- 2. the NSGP projections, on the host ----
    patterns = translate_ignore_keys(cfg1.get("ignore_keys", ["rpn", "roi_head"]))
    t0 = time.perf_counter()
    transforms = nsgp.build_transforms(total, ignore_patterns=patterns)
    build_s = time.perf_counter() - t0
    del total
    # a projection's trace is the kept dimension k; a backbone one is
    # divided by its Frobenius norm sqrt(k), so its trace is sqrt(k)
    kept = {k: round(float(torch.trace(P)) ** (2 if k.startswith("backbone") else 1))
            for k, P in transforms.items()}
    log({"phase": "task chain: build_transforms", "host_seconds": build_s,
         "projections": len(transforms), "largest": max(P.shape[0] for P in transforms.values()),
         "kept_dims_by_layer": kept,
         "measured": "host clock around nsgp.build_transforms (float64 numpy eigh on the host)"})
    check("projections", all(torch.isfinite(P).all() for P in transforms.values())
          and len(transforms) > 50, len(transforms))

    # ---- 3. the RoI store over 13 batches (65 RoIs: the raw replay draws 64) ----
    extract = make_roi_extract_step(model)
    stored = []
    for i in range(13):
        b = batches[i] if i < 2 else batch_of(SEED + i)
        out, paths["roi_extract"] = run_path(torch, f"roi extract {i}", EXPECTED_EXTRACT,
                                             lambda b=b: extract(b, gen))
        stored.append([x.cpu() for x in out])
    profile_call(torch, lambda: extract(batches[0], gen), "roi extract bf16 batch 16")
    feats = torch.cat([s[0] for s in stored]).numpy()
    labels = torch.cat([s[1] for s in stored]).numpy()
    check("roi store", feats.shape == (65, 12544) and np.isfinite(feats).all(), feats.shape)

    # ---- 4. prototypes, on the host ----
    protos, proto_labels, _ = replay.build_prototypes(feats, labels, (0, 15, 20), 2,
                                                      max_prototype=10)
    log({"phase": "task chain: prototypes", "stored": len(feats),
         "stored_labels": np.bincount(labels, minlength=21).tolist(), "prototypes": len(protos),
         "prototype_labels": proto_labels.tolist()})
    check("prototypes", len(protos) > 0 and np.isfinite(protos).all(), len(protos))

    # ---- 5. EWC importance over 2 batches, then the task's terms ----
    imp_step = make_importance_step(model)
    st1 = TrainState(None)
    params1 = dict(model.named_parameters())
    importance = ewc.init_importance(params1)
    for i, b in enumerate(batches):
        grads, paths["importance_step"] = run_path(torch, f"importance step {i}", EXPECTED_TRAIN,
                                                   lambda b=b: imp_step(st1, b, gen))
        importance = ewc.accumulate_importance(importance, grads, TRAIN_BATCH, len(batches))
    profile_call(torch, lambda: imp_step(st1, batches[0], gen), "importance step bf16 batch 16")
    terms = ewc.append_task_terms({}, importance, params1)
    check("ewc terms", len(terms) == 106 and all(
        torch.isfinite(i).all() for i, _ in terms.values()), len(terms))
    check("ewc importance", all(terms[k][0].any() for k in terms
                                if not k.startswith(("backbone.bn1.", "backbone.layer1."))),
          "a trainable BN got no importance")
    del model, imp_step, extract, cov_step, grads, params1
    torch.cuda.empty_cache()

    # ---- 6. task 2: student, teacher, projections, prototypes, EWC ----
    cfg2 = load_config(CONFIG2)
    student = init_detector(cfg2, device="cuda", seed=SEED).model
    student.load_state_dict(task1)
    teacher = build_teacher(student)
    check("teacher", teacher.config.roi_sampling_ratio == 2 and teacher.config.task_id == 1,
          "teacher_fast with roi_align_mode 'window' keeps the 2x2 grid")
    opt = build_train_optimizer(cfg2, student, STEPS_PER_EPOCH)
    optim.set_transforms(opt, transforms, len(student.config.task_split) - 1)
    st = TrainState(opt, teacher_params=dict(teacher.named_parameters()),
                    replay_feats=torch.from_numpy(protos).cuda(),
                    replay_labels=torch.from_numpy(proto_labels).cuda(), ewc_terms=terms)
    step = make_train_step(student, opt, teacher_model=teacher)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    trainable = {n for n, p in student.named_parameters() if p.requires_grad}
    gen2 = torch.Generator(device="cuda").manual_seed(SEED + 21)
    batch = batches[0]

    def finite(metrics, label):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).item()]
        check(f"task-2 {label}", not bad, f"non-finite {bad}")
        check(f"task-2 {label}", {"replay_loss_cls", "ewc_loss"} <= set(metrics), sorted(metrics))

    # the assign kernel at the merged gt capacity, on this batch's merge
    bn = batch.replace(images=normalize_images(batch.images))
    with torch.no_grad():
        dets = teacher.predict(bn, rescale=False)
    cfg = student.config
    gts = merge_pseudo_labels(batch.gt, dets, cfg.rpn_thresh, cfg.roi_thresh, cfg.pseudo_iou_skip)
    merged = (int(gts[0].valid[:, GT_CAPACITY:].sum()), int(gts[1].valid[:, GT_CAPACITY:].sum()))
    scores = dets.scores[dets.valid]
    log({"phase": "task-2 pseudo-labels", "teacher_dets_valid": int(dets.valid.sum()),
         "merged_into_rpn_gt": merged[0], "merged_into_roi_gt": merged[1],
         "teacher_scores_quantiles": torch.quantile(scores, torch.tensor(
             [0.5, 0.9, 0.99, 1.0], device=scores.device)).tolist() if len(scores) else None})
    check("pseudo-labels", merged[0] > 0, "no teacher detection reaches the RPN gt set")
    assign_at_merged_g(torch, student, gts[0], batch.img_shape)

    ewc_first = []
    for i in range(2):  # warm-up
        (st, metrics), _ = run_path(torch, f"task-2 warm-up step {i}", EXPECTED_TASK2,
                                    lambda: step(st, batch, gen2))
        finite(metrics, f"warm-up step {i}")
        ewc_first.append(float(metrics["ewc_loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(10):
        _ext.reset_launches()
        t0 = time.perf_counter()
        st, metrics = step(st, batch, gen2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        paths["task2_step"] = dict(_ext.LAUNCHES)
        check(f"task-2 step {i} launches", paths["task2_step"] == EXPECTED_TASK2,
              f"{paths['task2_step']} != {EXPECTED_TASK2}")
        finite(metrics, f"step {i}")
        losses.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated()
    # step 0 runs at the stored weights (EWC 0); every later one has moved
    check("ewc after the first update", ewc_first[1] > 0 and all(l["ewc_loss"] > 0 for l in losses),
          f"{ewc_first} {[l['ewc_loss'] for l in losses]}")
    med = statistics.median(times)
    log({"phase": "task-2 train bf16 batch 16", "card": card, "launches_per_step": paths["task2_step"],
         "step_ms_median": med, "step_ms_all": times, "img_per_s": TRAIN_BATCH / med * 1e3,
         "max_memory_allocated_bytes": peak, "steps_taken": st.step, "ewc_loss_warm_up": ewc_first,
         "losses_first": losses[0], "losses_last": losses[-1], "prototypes": len(protos),
         "projections": len(opt.transforms),
         "measured": "host clock around make_train_step's step (teacher in the step), ending in "
                     "torch.cuda.synchronize"})
    profile_call(torch, lambda: step(st, batch, gen2), "task-2 train bf16 batch 16 (one step)")

    # ---- 7. the teacher's detections fed in: the same terms on the same draws ----
    dets, paths["teacher_step"] = run_path(torch, "teacher step", EXPECTED_TEACHER,
                                           lambda: make_teacher_step(teacher)(batch))
    with torch.no_grad():
        in_step = task_losses(student, st, bn, teacher,
                              generator=torch.Generator(device="cuda").manual_seed(SEED + 22))
        fed = task_losses(student, st, bn, teacher, teacher_dets=dets,
                          generator=torch.Generator(device="cuda").manual_seed(SEED + 22))
    same = {k: bool(torch.equal(in_step[k], fed[k])) for k in in_step}
    log({"phase": "task-2 teacher_dets against the teacher in the step",
         "terms_in_step": {k: float(v) for k, v in in_step.items()},
         "terms_fed": {k: float(v) for k, v in fed.items()}, "bit_equal": same})
    # the same deterministic kernels on the same inputs: the same bits
    check("teacher_dets terms", set(in_step) == set(fed) and all(same.values()), same)
    (st, metrics), paths["task2_dets_step"] = run_path(
        torch, "task-2 step on teacher_dets", EXPECTED_TRAIN,
        lambda: step(st, batch, gen2, teacher_dets=dets))
    finite(metrics, "teacher_dets step")
    frozen_moved = [n for n in before if n not in trainable
                    and not torch.equal(before[n], student.get_parameter(n).detach())]
    check("task-2 frozen parameters", not frozen_moved, f"moved: {frozen_moved[:5]}")
    moved_teacher = [n for n, p in teacher.named_parameters()
                     if not torch.equal(p.detach().cpu(), task1[n])]
    check("teacher", not moved_teacher, f"moved off the task-1 weights: {moved_teacher[:5]}")
    after = {k: v.detach().cpu().clone() for k, v in student.state_dict().items()}
    del student, teacher, opt, st, step, dets, in_step, fed
    torch.cuda.empty_cache()

    # ---- 8. raw replay: the stored RoI features distilled against the teacher ----
    cfg_raw = load_config(CONFIG2_RAW)
    raw_student = init_detector(cfg_raw, device="cuda", seed=SEED).model
    check("raw config", raw_student.config.replay_mode == "raw", raw_student.config.replay_mode)
    raw_student.load_state_dict(task1)
    raw_teacher = build_teacher(raw_student)
    raw_opt = build_train_optimizer(cfg_raw, raw_student, STEPS_PER_EPOCH)
    optim.set_transforms(raw_opt, transforms, len(raw_student.config.task_split) - 1)
    raw_st = TrainState(raw_opt, teacher_params=dict(raw_teacher.named_parameters()),
                        replay_feats=torch.from_numpy(feats).cuda(),
                        replay_labels=torch.from_numpy(labels).cuda(), ewc_terms=terms)
    raw_step = make_train_step(raw_student, raw_opt, teacher_model=raw_teacher)
    raw_losses = []
    for i in range(2):
        (raw_st, metrics), paths["raw_replay_step"] = run_path(
            torch, f"raw-replay step {i}", EXPECTED_TASK2, lambda: raw_step(raw_st, batch, gen2))
        finite(metrics, f"raw-replay step {i}")
        raw_losses.append({k: float(v) for k, v in metrics.items()})
    log({"phase": "task-2 raw replay bf16 batch 16", "stored_rows": len(feats),
         "losses": raw_losses})
    # step 0: the student is the teacher (MSE 0); step 1 has moved
    check("raw replay", raw_losses[1]["replay_loss_cls"] > 0, raw_losses)
    del raw_student, raw_teacher, raw_opt, raw_st, raw_step
    torch.cuda.empty_cache()

    # ---- 9. f32, batch 1: the task-2 loss, card (kernels) against CPU ----
    cfg32 = copy.deepcopy(cfg2)
    cfg32["compute_dtype"] = "float32"
    on_card = init_detector(cfg32, device="cuda", seed=SEED).model
    on_card.load_state_dict(task1)
    teacher32 = build_teacher(on_card)  # the task-1 weights
    on_card.load_state_dict(after)  # the student after its task-2 steps
    on_cpu = init_detector(cfg32, device="cpu", seed=SEED).model
    on_cpu.load_state_dict(after)
    b1 = batch_of(SEED + 3, n=1)
    # the card teacher's detections feed both devices' gt sets: anchors
    # inside a teacher box tie exactly in the RPN's low-quality match, so
    # box coordinates an ulp apart could assign a few anchors differently
    d1 = make_teacher_step(teacher32)(b1.to("cuda"))
    g1 = merge_pseudo_labels(b1.gt.to("cuda"), d1, cfg.rpn_thresh, cfg.roi_thresh,
                             cfg.pseudo_iou_skip)
    kw = {dev: dict(gts=tuple(x.to(dev) for x in g1),
                    replay=(torch.from_numpy(protos).to(dev), torch.from_numpy(proto_labels).to(dev)),
                    ewc_terms={k: (i.to(dev), o.to(dev)) for k, (i, o) in terms.items()})
          for dev in ("cuda", "cpu")}
    card_vs_cpu(torch, "task-2", on_card, on_cpu, b1, g1[0].capacity, kw["cuda"], kw["cpu"])
    return paths


# ---------------------------------------------------------------------------
# runner phase: the two-task chain as a user runs it, over a synthetic VOC tree
# ---------------------------------------------------------------------------

RUNNER_IMAGES = 16  # per split: with RepeatDataset times=3 and batch 16, 3 steps an epoch
OBJ_XML = ("<object><name>{}</name><difficult>0</difficult><bndbox><xmin>{}</xmin>"
           "<ymin>{}</ymin><xmax>{}</xmax><ymax>{}</ymax></bndbox></object>")


def write_voc_tree(root: str) -> None:
    """VOC2007 under ``root``: 16 trainval and 16 test images of
    ``seeded_images`` (600x1000, landscape) as binary PPM, each with 2-8
    boxes whose classes come from both 0-14 and 15-19, so that the task-1
    and task-2 datasets keep all 16 images."""
    import numpy as np

    from nsgp_repre_tpu_torch.datasets.voc import VOC_CLASSES

    base = os.path.join(root, "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    H, W = IMAGE_HW
    for split, seed in (("trainval", SEED + 30), ("test", SEED + 31)):
        rng = np.random.RandomState(seed)
        ids = []
        for i, img in enumerate(seeded_images(RUNNER_IMAGES, seed)):
            name = f"{split}_{i:03d}"
            with open(os.path.join(base, "JPEGImages", name + ".ppm"), "wb") as f:
                f.write(f"P6\n{W} {H}\n255\n".encode() + img.tobytes())
            n = rng.randint(2, 9)
            classes = [rng.randint(0, 15), rng.randint(15, 20)] + list(rng.randint(0, 20, n - 2))
            objs = []
            for c in classes:
                w, h = rng.randint(W // 16, W * 2 // 5), rng.randint(H // 10, H // 2)
                x, y = rng.randint(1, W - w), rng.randint(1, H - h)
                objs.append(OBJ_XML.format(VOC_CLASSES[c], x, y, x + w, y + h))
            with open(os.path.join(base, "Annotations", name + ".xml"), "w") as f:
                f.write(f"<annotation><filename>{name}.ppm</filename><size><width>{W}</width>"
                        f"<height>{H}</height><depth>3</depth></size>{''.join(objs)}</annotation>")
            ids.append(name)
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids))


def runner_cfg(path: str, data_root: str, work_dir: str, **entries):
    """A config file with its train and val datasets read from
    ``data_root``, one epoch, and ``entries``."""
    from nsgp_repre_tpu_torch.engine.runner import _leaf_dataset
    from nsgp_repre_tpu_torch.utils.config import load_config

    cfg = load_config(path)
    for loader in ("train_dataloader", "val_dataloader"):
        # the 15+5 configs' leaf datasets name no data_root (the default
        # data/VOCdevkit applies)
        _leaf_dataset(cfg[loader]["dataset"])["data_root"] = data_root
    cfg["work_dir"] = work_dir
    cfg["train_cfg"]["max_epochs"] = 1
    cfg.update(entries)
    return cfg


def expected_launches(runner, steps_have_teacher: bool):
    """A train() call's launches from the batches each pass ran
    (runner.timings) and each path's launches per call."""
    t = runner.timings
    val_batches = -(-int(t["val_images"]) // runner.val_loader.loader.batch_size)
    imp = {k: EXPECTED_TRAIN[k] + (EXPECTED_TEACHER[k] if steps_have_teacher else 0)
           for k in EXPECTED_TRAIN}
    calls = [(t.get("teacher_batches", 0), EXPECTED_TEACHER), (t["train_steps"], EXPECTED_TRAIN),
             (val_batches, EXPECTED_B16), (t["importance_batches"], imp),
             (t["cov_batches"], EXPECTED_COV), (t["roi_batches"], EXPECTED_EXTRACT)]
    return {k: int(sum(n * per[k] for n, per in calls)) for k in KERNELS}


def run_train(torch, runner, label: str, steps_have_teacher: bool, step_ms: float, card: str):
    """``runner.train()`` with its launches counted from zero; checks the
    batches each pass ran, the launches, finite logged losses and mAP;
    logs each stage's seconds, steps/s against the bare step, the
    loader's share of the loop, val img/s and peak memory."""
    import math

    from nsgp_repre_tpu_torch.ops import _ext

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_ext.LAUNCHES)
    t = runner.timings
    n_train = len(runner.train_loader)
    check(f"{label} batches", (t["train_steps"], t["val_images"], t["importance_batches"],
                               t["cov_batches"], t["roi_batches"]) == (
        n_train, len(runner.val_dataset), n_train, n_train, n_train), t)
    want = expected_launches(runner, steps_have_teacher)
    check(f"{label} launches", launches == want, f"{launches} != {want}")
    with open(os.path.join(runner.work_dir, "scalars.json")) as f:
        logged = [json.loads(line) for line in f if line.strip()]
    bad = [(r["iter"], k) for r in logged for k, v in r.items()
           if k not in ("epoch", "iter") and not math.isfinite(v)]
    check(f"{label} logged losses", logged and not bad, bad or "nothing logged")
    check(f"{label} mAP", math.isfinite(runner.last_val_map), runner.last_val_map)
    steps_per_s = t["train_steps"] / t["train_loop_s"]
    # step 0's logged time ends in a sync (its losses are logged); the
    # other steps share what is left of the loop once the loader's waits
    # are taken out
    first = logged[0]["time"]
    rest = (t["train_loop_s"] - t["loader_wait_s"] - first) / max(t["train_steps"] - 1, 1)
    log({"phase": f"runner {label}: train()", "card": card, "wall_s": wall,
         "timings": t, "launches": launches, "val_map": runner.last_val_map,
         "logged": logged, "steps_per_s": steps_per_s,
         "first_step_s": first, "later_steps_mean_s": rest,
         "bare_step_per_s": 1e3 / step_ms, "loop_over_bare_step": 1e3 / step_ms / steps_per_s,
         "loader_wait_share": t["loader_wait_s"] / t["train_loop_s"],
         "val_img_per_s": t["val_images"] / t["val_s"],
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "measured": "host clock (time.perf_counter) around each stage, each ending in a sync; "
                     "the bare step: the train phase's median"})
    return launches


def runner_phase(torch, card: str, task1, step_ms: float):
    """Task 1 then task 2 of the 15+5 configs through NullSpaceRunner at full
    width and depth (bf16, 600x1000 images on the 608x1024 canvas, batch
    16), over a synthetic VOC2007 tree; task 1 starts from ``task1`` (the
    predict phase's conditioned weights, written as a ``best_*.npz`` with
    the port's checkpoint writer), so the task-2 teacher detects something.
    Then tools/torch_test.py on task 2's best checkpoint, and a resumed
    task-2 runner. Returns the launches of each train()."""
    import importlib.util
    import math
    import pickle
    import shutil
    import tempfile

    import numpy as np

    from nsgp_repre_tpu_torch.datasets.prefetch import to_device
    from nsgp_repre_tpu_torch.engine.runner import NullSpaceRunner
    from nsgp_repre_tpu_torch.models.detector import FasterRCNN
    from nsgp_repre_tpu_torch.ops import _ext
    from nsgp_repre_tpu_torch.utils import checkpoint as ckpt_io
    from nsgp_repre_tpu_torch.utils.convert import jax_flat_from_state_dict

    tmp = tempfile.mkdtemp(prefix="nsgp_runner_")
    try:
        t0 = time.perf_counter()
        data_root = os.path.join(tmp, "VOCdevkit")
        write_voc_tree(data_root)
        init = os.path.join(tmp, "init", "best_mAP_epoch_0.npz")
        ckpt_io.save_flat(init, ckpt_io.model_flat(task1))
        log({"phase": "runner: data", "seconds": time.perf_counter() - t0,
             "images_per_split": RUNNER_IMAGES})
        wd1, wd2 = os.path.join(tmp, "task_1"), os.path.join(tmp, "task_2")
        paths = {}

        # ---- task 1 ----
        r1 = NullSpaceRunner(runner_cfg(CONFIG, data_root, wd1, load_from=init))
        check("runner task 1", r1.device.type == "cuda" and r1.teacher is None
              and tuple(r1.model.config.backbone_blocks) == (3, 4, 6, 3)
              and r1.model.config.compute_dtype == "bfloat16"
              and len(r1.train_dataset) == len(r1.val_dataset) == RUNNER_IMAGES
              and len(r1.train_loader) == 3, (len(r1.train_dataset), len(r1.train_loader)))
        # the host side alone: decoding and packing the epoch's batches (no
        # prefetch thread), and one batch's pinned copy to the card
        t0 = time.perf_counter()
        batches = [b for b, _ in r1.train_loader.loader]
        decode_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(batches[0], r1.device)
        torch.cuda.synchronize()
        log({"phase": "runner: loader alone", "batches": len(batches),
             "decode_ms_per_batch": decode_s / len(batches) * 1e3,
             "decode_ms_per_image": decode_s / (len(batches) * TRAIN_BATCH) * 1e3,
             "copy_ms_per_batch": (time.perf_counter() - t0) * 1e3,
             "batch_bytes": batches[0].images.numel(),
             "decode_threads": int(os.environ.get("NSGP_DECODE_THREADS", "16")),
             "measured": "host clock; the copy: pin_memory and a non-blocking copy, synchronized"})
        del batches
        paths["runner_task1_train"] = run_train(torch, r1, "task 1", False, step_ms, card)
        files = ["epoch_0.npz", "best_mAP_epoch_0.npz", "resume_state.npz", "scalars.json",
                 "covariance.npz", "rois_etc.npz", "ewc_reg_terms_ewc.npz"]
        check("task 1 files", set(files) <= set(os.listdir(wd1)), sorted(os.listdir(wd1)))
        # the checkpoints hold exactly the model's JAX paths, and load back bit for bit
        params, stats = jax_flat_from_state_dict(r1.model.state_dict())
        best1 = os.path.join(wd1, "best_mAP_epoch_0.npz")
        flat1 = ckpt_io.load_pytree_flat(best1)
        check("checkpoint keys", set(flat1) == {f"params/{k}" for k in params}
              | {f"batch_stats/{k}" for k in stats}, sorted(flat1)[:5])
        fresh = FasterRCNN(r1.model.config).to("cuda")
        ckpt_io.load_checkpoint(fresh, best1, strict=True)
        own = r1.model.state_dict()
        check("checkpoint round trip", all(torch.equal(v, own[k]) for k, v in
                                           fresh.state_dict().items()), "a tensor differs")
        cov1, rois1 = ckpt_io.load_covariance(wd1), ckpt_io.load_rois_etc(wd1)
        del r1, fresh, own
        torch.cuda.empty_cache()

        # ---- task 2: __init__ from task 1's dir ----
        cfg2 = runner_cfg(CONFIG2, data_root, wd2, previous_dir=wd1)
        r2 = NullSpaceRunner(cfg2)
        t2 = dict(r2.timings)
        teacher_is_best = lambda: all(  # noqa: E731
            np.array_equal(flat1[f"params/{k}"], v) for k, v in
            jax_flat_from_state_dict(dict(r2.teacher.named_parameters()))[0].items())
        log({"phase": "runner task 2: __init__", "init_s": t2["init_s"],
             "build_transforms_s": t2["build_transforms_s"],
             "transforms_installed": len(r2.optimizer.transforms),
             "covariances": len(cov1), "ewc_tensors": len(r2.ewc_terms),
             "prototypes": len(r2.state.replay_feats),
             "prototype_labels": r2.state.replay_labels.tolist()})
        check("task 2 __init__", len(r2.optimizer.transforms) == 50 and len(r2.ewc_terms) == 106
              and len(r2.state.replay_feats) > 0, (len(r2.optimizer.transforms), len(r2.ewc_terms)))
        check("task 2 teacher before training", teacher_is_best(), "differs from task 1's best")
        paths["runner_task2_train"] = run_train(torch, r2, "task 2", True, step_ms, card)
        check("task 2 teacher after training", teacher_is_best(), "differs from task 1's best")
        cached = sum(len(e[3]) for e in r2._pseudo_cache.values())
        log({"phase": "runner task 2: pseudo-label cache", "entries": len(r2._pseudo_cache),
             "detections": cached, "bytes": r2._pseudo_cache_bytes})
        check("pseudo-label cache", len(r2._pseudo_cache) == 2 * RUNNER_IMAGES and cached > 0,
              (len(r2._pseudo_cache), cached))
        check("task 2 files", set(files + ["mask.pkl"]) <= set(os.listdir(wd2)),
              sorted(os.listdir(wd2)))
        cov2, rois2 = ckpt_io.load_covariance(wd2), ckpt_io.load_rois_etc(wd2)
        check("task 2 covariance keys", set(cov2) >= set(cov1), sorted(set(cov1) - set(cov2)))
        check("task 2 RoI store", len(rois2[0]) > len(rois1[0]), (len(rois2[0]), len(rois1[0])))
        runner_map, step2, count2 = r2.last_val_map, r2.state.step, r2.optimizer.count
        r2.val(dump_to=os.path.join(tmp, "runner_dets.pkl"))  # its detections, for the tool's
        del r2
        torch.cuda.empty_cache()

        # ---- tools/torch_test.py on task 2's best checkpoint ----
        spec = importlib.util.spec_from_file_location("torch_test", os.path.join("tools",
                                                                                 "torch_test.py"))
        torch_test = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(torch_test)
        cfg_path = os.path.join(tmp, "cfg2.py")
        with open(cfg_path, "w") as f:
            f.write("".join(f"{k} = {v!r}\n" for k, v in cfg2.items()))
        _ext.reset_launches()
        t0 = time.perf_counter()
        test_map = torch_test.main([cfg_path, ckpt_io.find_checkpoint(wd2, "best"),
                                    "--work-dir", os.path.join(tmp, "test"),
                                    "--out", os.path.join(tmp, "dets.pkl")])
        test_s = time.perf_counter() - t0
        paths["runner_test_val"] = dict(_ext.LAUNCHES)
        dets = []
        for name in ("runner_dets.pkl", "dets.pkl"):
            with open(os.path.join(tmp, name), "rb") as f:
                dets.append(pickle.load(f))
        log({"phase": "runner: tools/torch_test.py", "map": test_map, "runner_map": runner_map,
             "seconds": test_s, "launches": paths["runner_test_val"],
             "detections": sum(len(d["boxes"]) for d in dets[1])})
        check("torch_test launches", paths["runner_test_val"] == EXPECTED_B16,
              f"{paths['runner_test_val']} != one batch-16 predict")
        # the same weights, kernels and cuDNN algorithms on the same images:
        # the same detections, bit for bit, and the same mAP
        same = len(dets[0]) == len(dets[1]) == RUNNER_IMAGES and all(
            a["img_id"] == b["img_id"] and all(np.array_equal(a[k], b[k]) for k in (
                "boxes", "scores", "labels")) for a, b in zip(*dets))
        check("torch_test detections", same, "differ from the runner's validation")
        check("torch_test mAP", test_map == runner_map, (test_map, runner_map))

        # ---- a resumed task-2 runner ----
        r2b = NullSpaceRunner(runner_cfg(CONFIG2, data_root, wd2, previous_dir=wd1, resume=True))
        epoch = r2b._try_resume()
        flat = ckpt_io.load_pytree_flat(os.path.join(wd2, "resume_state.npz"))
        now = ckpt_io.model_flat(r2b.model.state_dict())
        log({"phase": "runner: resumed task 2", "epoch": epoch, "step": r2b.state.step,
             "count": r2b.optimizer.count, "best_map": r2b._resumed_best,
             "transforms_installed": len(r2b.optimizer.transforms)})
        check("resume", (epoch, r2b.state.step, r2b.optimizer.count) == (1, step2, count2)
              and r2b._resumed_best == runner_map and len(r2b.optimizer.transforms) == 50,
              (epoch, r2b.state.step, r2b._resumed_best))
        check("resumed parameters", all(np.array_equal(now[k], flat[k]) for k in now),
              "differ from resume_state.npz")
        check("resume mAP finite", math.isfinite(r2b._resumed_best), r2b._resumed_best)
        del r2b
        torch.cuda.empty_cache()
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
        launches_train, step_ms = train_phase(torch, card, state)
        chain = task_chain_phase(torch, card, state)
        runs = runner_phase(torch, card, state, step_ms)
        by_path = {"predict_batch1": launches_b1, "train_step": launches_train, **chain, **runs}

        kernels = []
        for name in KERNELS:
            r = results[(name, "bfloat16")] if (name, "bfloat16") in results else results[(name, "float32")]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                # each main path counted from zero: one batch-1 predict, one
                # task-1 train step, one call of each task-chain path, and
                # each runner train() and the test tool's validation
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {path: p[name] for path, p in by_path.items()},
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "dtype": r["dtype"],
            })
            if "device_ms" in r:  # device time beside the eager calls
                kernels[-1]["device_ms"] = r["device_ms"]
            for k in ("by_size", "cases"):  # roi_align at train / batch-16 sizes; roi_align_bwd's sets
                if k in r:
                    kernels[-1][k] = r[k]
            if name == "nms":  # the train step's call and predict batch 16's multiclass call
                for key, sub in ((TRAIN_BATCH, "batch16"), ("multiclass16", "multiclass_batch16")):
                    r16 = results[("nms", "float32", key)]
                    kernels[-1][sub] = {k: r16[k] for k in (
                        "bound_ms", "device_ms", "nms_kernels_device_ms", "ious_evaluated")} | {
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
