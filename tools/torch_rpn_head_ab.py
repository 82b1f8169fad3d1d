#!/usr/bin/env python3
"""Time the fused RPN head kernel and fingerprint its outputs, for an A/B
of two checkouts on one card.

    python3 tools/torch_rpn_head_ab.py [--label NAME] [--wide]

Builds the kernels of the checkout this file lies in, then runs
``ops/rpn_head_cuda.rpn_head`` (bf16) on seeded maps:

- the FPN head (F = 256, 3 anchors, P = 15) on the five levels of the
  608x1024 canvas (strides 4-64) at batch 1 and 16, the shapes of
  PERF.md's kernel table row 5;
- with ``--wide``, the C4 head (C = F = 1024, 15 anchors, P = 75) and
  the DC5 head (C = F = 2048) on the 800x1344 canvas's stride-16 map
  (50x84) at batch 1 and 2.

For each case it prints one JSON line: the SHA-256 of the outputs' bytes
(equal in two checkouts means the same bits), the time of one call of
all the case's levels by CUDA events over back-to-back calls, and the
profiler's device time. Run it in each checkout, in turns (A, B, B, A),
in one call on one card; compare only within that call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def cuda_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(torch, fn, iters: int = 5) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity"))
    return total / 1e3 / iters


def run_case(torch, rh, label, name, levels, C, F, A, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(3, 3, C, F, generator=g) / (9 * C) ** 0.5
    b = torch.randn(F, generator=g) * 0.1
    wcr = torch.randn(F, 5 * A, generator=g) / F ** 0.5
    bcr = torch.randn(5 * A, generator=g) * 0.1
    maps = [torch.randn(*shape, C, generator=g).to("cuda", torch.bfloat16) for shape in levels]
    w, b, wcr, bcr = (t.cuda() for t in (w, b, wcr, bcr))
    with torch.no_grad():
        run = lambda: [rh.rpn_head(x, w, b, wcr, bcr) for x in maps]  # noqa: E731
        h = hashlib.sha256()
        for out in run():
            h.update(out.view(torch.int16).cpu().numpy().tobytes())
        print(json.dumps({"label": label, "case": name, "levels": [list(s) for s in levels],
                          "C": C, "F": F, "P": 5 * A, "sha256": h.hexdigest(),
                          "ms": cuda_ms(torch, run), "device_ms": profiled_ms(torch, run)}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=ROOT)
    ap.add_argument("--wide", action="store_true", help="also the C4 and DC5 heads")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from nsgp_repre_tpu_torch.ops import _ext
    from nsgp_repre_tpu_torch.ops import rpn_head_cuda as rh

    _ext.lib()
    print(json.dumps({"label": args.label, "card": card_line()}), flush=True)
    fpn = [(-(-608 // s), -(-1024 // s)) for s in (4, 8, 16, 32, 64)]
    for batch in (1, 16):
        run_case(torch, rh, args.label, f"fpn batch {batch}", [(batch, h, w) for h, w in fpn],
                 256, 256, 3, seed=batch)
    if args.wide:
        for name, C in (("c4", 1024), ("dc5", 2048)):
            for batch in (1, 2):
                run_case(torch, rh, args.label, f"{name} batch {batch}", [(batch, 50, 84)], C, C,
                         15, seed=C + batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
