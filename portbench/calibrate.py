"""The readings a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault half_batch,drop_ewc --fault-seeds 4,5,6] \\
        [--f32-seeds 1,2,3]

For each seed of ``--seeds``: the cell's set-up (which drives the program
through the check's own steps) and the numbers the check compares, the
program against the float32 reference (the limit's lower reading). For
each seed of ``--control-seeds``: the same numbers for the control, the
reference computed with float8 operands in the program's place (the upper
reading). With ``--fault``: the numbers of the program with each of
those faults planted (``frozen_step``, ``half_batch``, ``drop_replay``,
``drop_ewc``, ``altered_answer``), on each of ``--fault-seeds``. With
``--f32-seeds``: the program built in float32 and run with TF32 off, a
witness of what the configuration's bfloat16 alone moves. One JSON line
per reading on standard output. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell: dict, seeds, control_seeds, faults, fault_seeds, device: str = "cuda",
             f32_seeds=()):
    """Yield one dict per reading."""
    import torch

    from portbench import common
    from portbench.reference import detector as ref

    cfg = common.load_json("configs", cell["config"]) if isinstance(cell["config"], str) else cell["config"]
    traffic = (common.load_json("traffic", cell["traffic"]) if isinstance(cell["traffic"], str)
               else cell["traffic"])
    cls = common.load_module("entries", cell["entry"]).Entry
    if isinstance(faults, str):
        faults = [f for f in faults.split(",") if f]
    plan = [(s, "program", "") for s in seeds] + [(s, "control", "") for s in control_seeds]
    plan += [(s, "fault", f) for f in faults for s in fault_seeds]
    plan += [(s, "program_f32", "") for s in f32_seeds]
    f32 = dict(cfg, compute_dtype="float32",
               program_overrides=dict(cfg.get("program_overrides", {}), compute_dtype="float32"))
    for seed, kind, f in plan:
        t0 = time.perf_counter()
        if kind == "program_f32":
            with ref.no_tf32():
                entry = cls(f32, traffic, seed, device, f)
        else:
            entry = cls(cfg, traffic, seed, device, f)
        prog = entry.program_readings()
        entry.free_program()
        if kind == "control":
            prog, r = entry.control_readings()
        else:
            r = entry.reference_readings()
        nums = entry.numbers(prog, r)
        yield {"seed": seed, "kind": kind if not f else f"fault:{f}", "seconds": time.perf_counter() - t0,
               **nums}
        del entry
        if device.startswith("cuda"):
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--f32-seeds", default="")
    args = p.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731

    from portbench import common

    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = common.load_json("workloads", args.workload)
    for row in readings(cell, ints(args.seeds), ints(args.control_seeds), args.fault,
                        ints(args.fault_seeds), f32_seeds=ints(args.f32_seeds)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
