"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``portbench/workloads/<cell>.json``: its configuration
(``configs/``), traffic mix (``traffic/``), entry (``entries/``, what the
window drives), end-to-end metrics and, for ``--trace 1``, per-layer
metric readers (``metrics/``). Set-up builds the program and its inputs
from the seed and warms every shape; the window then drives the entry for
``--seconds``; the check compares what the window's own path produced with
the plain reference (``reference/``). The last line of standard output is
one JSON object; the compared numbers and their limits are also the last
lines of standard error. A run without enough CUDA devices prints no result
and exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "nsgp_repre_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault: str = "", t_start: float = T_START, log=print) -> dict:
    """Set up, measure and check one cell; returns the result object."""
    import torch

    from portbench import common
    from portbench.trace import trace_window

    cfg = common.load_json("configs", cell["config"]) if isinstance(cell["config"], str) else cell["config"]
    traffic = (common.load_json("traffic", cell["traffic"]) if isinstance(cell["traffic"], str)
               else cell["traffic"])
    entry = common.load_module("entries", cell["entry"]).Entry(cfg, traffic, seed, device, fault)
    entry.sync()
    is_cuda = device.startswith("cuda")
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # ---- the window ----
    n_trace = cell["trace_steps"] if trace else 0
    done = 0
    marks = []
    traced = None
    launches0 = entry.launches()
    ev = (lambda: torch.cuda.Event(enable_timing=True)) if is_cuda else None
    t0 = time.perf_counter()
    if is_cuda:
        marks.append(ev())
        marks[-1].record()
    while True:
        now = time.perf_counter() - t0
        if traced is None and n_trace and now >= seconds / 2:
            traced = trace_window(entry.step, n_trace, entry.sync, entry.launches)
            done += 2 * n_trace
            continue
        if now >= seconds and (traced is not None or not n_trace):
            break
        with torch.profiler.record_function("portbench.step"):
            entry.step()
        done += 1
        if is_cuda and traced is None:
            marks.append(ev())
            marks[-1].record()
    entry.sync()
    window_s = time.perf_counter() - t0
    launches = {k: v - launches0.get(k, 0) for k, v in entry.launches().items()}
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    if is_cuda:
        torch.cuda.synchronize()
    intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])] if is_cuda else []

    # ---- metrics ----
    metrics = {}
    if not trace:
        for m in cell["end_to_end"]:
            if m["kind"] == "rate":
                v = done * entry.images_per_step / window_s
            elif m["kind"] == "interval_p95":
                v = float(statistics.quantiles(intervals, n=20)[18]) if len(intervals) > 20 else None
            elif m["kind"] == "setup":
                v = setup_s
            else:
                raise ValueError(f"unknown end-to-end kind {m['kind']!r}")
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for name in cell["per_layer"]:
            base, _, variant = name.partition(".")
            reader = common.load_module("metrics", base)
            got = reader.read(traced, entry, variant)
            if got is not None:
                metrics[name] = {"value": got, "unit": reader.UNIT}
    per_step = {k: v / max(done, 1) for k, v in launches.items() if v}
    log(json.dumps({"steps": done, "window_s": window_s, "launches_per_step": per_step,
                    "setup_s": setup_s}), file=sys.stderr)

    # ---- the check: the window's own path against the plain reference ----
    entry.free_program()
    t_ref = time.perf_counter()
    readings = entry.reference_readings()
    numbers = entry.numbers(entry.program_readings(), readings)
    numbers["_reference_s"] = time.perf_counter() - t_ref
    limits = cell["limits"]
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checked.values())
    extra = {k: v for k, v in numbers.items() if k not in limits}
    if extra:
        log(json.dumps(extra), file=sys.stderr)
    for k, v in checked.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)

    dev_info = {"platform": "gpu" if is_cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": done, "failed": 0 if correct else done,
           "metrics": metrics, "device": dev_info}
    if trace and traced is not None:
        dev_info["busy_s"] = traced.device.busy_s()
        dev_info["window_s"] = traced.device.window_s
        out["breakdown"] = {"device_ops": traced.device.device_ops(),
                            "idle_gaps": traced.hosted.idle_gaps()}
    out["checked"] = checked
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import common

    cell = common.load_json("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # the host only dispatches: one process, one compute thread
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    dev = out["device"]
    lim = os.popen("nvidia-smi --query-gpu=power.limit --format=csv,noheader 2>/dev/null").read()
    dev["power_limit"] = lim.strip().splitlines()[0] if lim.strip() else "unknown"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
