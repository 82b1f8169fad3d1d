"""The span stretch: steps recorded with the program's own spans alone,
beside CUDA's runtime calls and device ops on one clock, and what the
per-layer span metrics read from it.

The port marks its layers with ``nsgp.*`` ranges
(``nsgp_repre_tpu_torch/utils/spans.py``). After the window, a traced
run drives ``traced.device.steps`` more steps (and one on each side, cut
away) under a profiler whose CPU activity is restricted to user scopes,
so the host records those spans and ``portbench.step`` but no ``aten::``
op, and keeps close to its untraced pace. The stretch is recorded once
per run and kept on the ``Traced`` object, so every reader of the run
reads the same steps. The extra steps come after the window's numbers are
taken and change none of them, nor what the check compares.

Attribution:

- a device op belongs to span S when the runtime call that launched it
  (matched by correlation) lies inside S, nested spans included
  (``Stretch.device_time_under``);
- an idle gap between device intervals belongs to the innermost
  ``nsgp.*`` span open when the gap starts: ``step`` when that is the
  step's own span (``train_step`` or ``predict``), ``outside`` when no
  program span is open (``Stretch.idle_gaps`` over the program's spans).
  Every gap falls in one bucket, so the buckets sum to the stretch's
  inter-op idle.

To read the span metrics of a cell whose workload file does not list
them, run

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

It makes a traced run of the cell, as ``run.py --trace 1`` does, with
every name of ``METRICS`` added to the cell's per-layer list (a reader
that finds no span prints nothing), and prints its result line. Every
span stretch also prints its summary to standard error.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.trace import DEVICE_CATS, Stretch  # noqa: E402

PREFIX = "nsgp."
STEP_SPANS = ("nsgp.train_step", "nsgp.predict")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
LAYERS = ("backbone", "rpn", "proposals", "roi", "mask", "replay", "ewc", "backward", "optimizer")
METRICS = ([f"{q}.{layer}" for q in ("layer_ms", "gap_ms", "launches") for layer in LAYERS]
           + ["gap_ms.step", "gap_ms.outside", "launches.step"])


@dataclass
class SpanStretch(Stretch):
    """A stretch whose host spans are the program's and ``portbench.step``,
    with the kernel-launch calls among the runtime calls: (start,
    correlation) of each call named in ``LAUNCH_CALLS``. The attribution is
    :class:`Stretch`'s own, over the program's spans alone."""
    launch_calls: List[Tuple[float, int]] = field(default_factory=list)

    def _spans(self, variant: str) -> List[Tuple[float, float]]:
        names = STEP_SPANS if variant == "step" else (PREFIX + variant,)
        return [(s, e) for n, s, e, _ in self.host if n in names]

    def _only(self, keep: Callable[[str], bool]) -> "SpanStretch":
        """This stretch with the host spans whose name ``keep`` admits."""
        return replace(self, host=[h for h in self.host if keep(h[0])])

    def layer_ms(self, variant: str) -> Optional[float]:
        """Device ms per step launched inside span ``nsgp.<variant>``."""
        if not self.device or not self._spans(variant):
            return None
        return 1e3 * self.device_time_under(PREFIX + variant) / self.steps

    def kernel_launches(self, variant: str) -> Optional[float]:
        """Kernel-launch calls per step that started inside ``nsgp.<variant>``
        (``step``: inside the step's own span)."""
        spans = self._spans(variant)
        if not self.device or not spans:
            return None
        return sum(any(a <= t <= b for a, b in spans) for t, _ in self.launch_calls) / self.steps

    def gap_buckets(self) -> Dict[str, float]:
        """Inter-op idle seconds by the innermost program span open at each
        gap's start (:meth:`Stretch.idle_gaps` over the ``nsgp.*`` spans): a
        layer, ``step`` or ``outside``."""
        program = self._only(lambda n: n.startswith(PREFIX))
        out: Dict[str, float] = {}
        for name, idle_s in program.idle_gaps(n=len(program.host) + 1):
            key = ("outside" if not name.startswith(PREFIX)
                   else "step" if name in STEP_SPANS else name[len(PREFIX):])
            out[key] = out.get(key, 0.0) + idle_s
        return out

    def gap_ms(self, variant: str) -> Optional[float]:
        """Idle ms per step of the gaps that started with ``nsgp.<variant>``
        innermost (``step``, ``outside``: see :meth:`gap_buckets`). A program
        without spans reads nothing, ``outside`` included."""
        if not self.device or not self._spans("step" if variant == "outside" else variant):
            return None
        return 1e3 * self.gap_buckets().get(variant, 0.0) / self.steps

    def summary(self) -> dict:
        """What the stretch is checked by: its pace, the host events it holds
        (spans; no op), the share of device time launched under no layer
        span, and the inter-op idle beside the gap buckets."""
        counts: Dict[str, int] = {}
        for n, _, _, _ in self.host:
            counts[n] = counts.get(n, 0) + 1
        layers = self._only(lambda n: n.startswith(PREFIX) and n not in STEP_SPANS)
        device_s = sum(e - s for _, s, e, _ in self.device) / 1e6
        busy = self.busy_s()
        return {
            "steps": self.steps, "window_s": self.window_s,
            "step_ms": 1e3 * self.window_s / self.steps,
            "spans": counts,
            "aten_ops": sum(v for k, v in counts.items() if k.startswith("aten::")),
            "launch_calls": len(self.launch_calls),
            # launches whose kernel the trace lacks: the device timeline misses them
            "kernels_missing": len({c for _, c in self.launch_calls}
                                   - {c for _, _, _, c in self.device}),
            "unattributed_share": ((device_s - layers.device_time_under(PREFIX)) / busy
                                   if busy > 0 else None),
            "idle_ms_per_step": 1e3 * (self.span_s() - busy) / self.steps,
            "gap_ms_per_step": {k: 1e3 * v / self.steps for k, v in self.gap_buckets().items()},
        }


def reduce(events: List[dict], steps: int, window_s: float) -> SpanStretch:
    """A saved Chrome trace's complete events as a :class:`SpanStretch`
    (``trace.profile_steps``' reduction, with the launch calls kept)."""
    st = SpanStretch(steps=steps, window_s=window_s)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        args = ev.get("args", {}) or {}
        corr = int(args.get("correlation", -1) or -1)
        if cat in DEVICE_CATS:
            st.device.append((name, ts, ts + dur, corr))
        elif cat in ("cpu_op", "user_annotation"):
            st.host.append((name, ts, ts + dur, int(ev.get("tid", 0) or 0)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            st.runtime.append((ts, ts + dur, corr))
            if name in LAUNCH_CALLS:
                st.launch_calls.append((ts, corr))
    return st


def record(step: Callable[[], None], steps: int, sync: Callable[[], None]) -> SpanStretch:
    """``steps`` steps under the profiler with CPU activity restricted to
    user scopes (the spans), plus CUDA activity where there is a card.
    One step more runs on each side and is cut away (:func:`middle`): the
    profiler loses some kernels in the first and last tenth of a stretch
    (up to 477 of 30,648 in 8 Mask steps, on an H100), never between."""
    import torch
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    activities = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        activities.add(ProfilerActivity.CUDA)
    sync()
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        for _ in range(steps + 2):
            with torch.profiler.record_function("portbench.step"):
                step()
        sync()
    finally:
        result = _disable_profiler()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        result.save(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return middle(reduce(events, steps + 2, 0.0), steps)


def middle(st: SpanStretch, steps: int) -> SpanStretch:
    """The ``steps`` steps after the first of ``st``, marked by its
    ``portbench.step`` spans: the host events and runtime calls inside them
    and the device ops those calls launched. ``window_s`` is their host
    time, from the first kept step's start to the last one's end."""
    marks = sorted((s, e) for n, s, e, _ in st.host if n == "portbench.step")
    t0, t1 = marks[1][0], marks[steps][1]
    out = SpanStretch(steps=steps, window_s=(t1 - t0) / 1e6)
    out.host = [h for h in st.host if t0 <= h[1] and h[2] <= t1]
    out.runtime = [r for r in st.runtime if t0 <= r[0] < t1]
    out.launch_calls = [c for c in st.launch_calls if t0 <= c[0] < t1]
    corr = {c for _, _, c in out.runtime}
    out.device = [d for d in st.device if d[3] in corr]
    return out


def span_stretch(traced, entry) -> Optional[SpanStretch]:
    """The run's span stretch, recorded at the first call and kept on ``traced``."""
    if traced is None:
        return None
    got = getattr(traced, "spans", None)
    if got is None:
        got = traced.spans = record(entry.step, traced.device.steps, entry.sync)
        print(json.dumps({"span_stretch": got.summary()}), file=sys.stderr)
    return got


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="A traced run of one cell with the span metrics.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    import torch

    from portbench import common, run

    cell = common.load_json("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as run.py sets it
    cell["per_layer"] = cell["per_layer"] + [m for m in METRICS if m not in cell["per_layer"]]
    out = run.run_cell(cell, args.seed, args.seconds, True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
