"""The traced stretches of a window: torch.profiler over a few steps,
reduced to the intervals the metric readers take.

Two stretches follow each other. The first records CUDA activity alone,
so the host runs at its untraced pace: the idle share, the MFU, the
rooflines and the top device ops are read from it. The second records
the CPU ops too, which slows the host, and serves only what needs host
spans: the idle gaps named by what the host was doing, and the device
work launched inside a host scope (the optimizer's).

The profiler's Chrome trace is written to the run's temporary directory,
read back and deleted. Device work is every kernel, copy and set; it is
busy where any of them runs. Host spans are the CPU ops and annotations,
so an idle gap can be named by the innermost host span that covers it.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Stretch:
    """What the profiled steps left: device ops (name, start, end, correlation),
    host spans (name, start, end, thread), runtime calls (start, end,
    correlation), all in microseconds on one clock; the host-clock seconds
    and the step count."""
    steps: int
    window_s: float
    device: List[Tuple[str, float, float, int]] = field(default_factory=list)
    host: List[Tuple[str, float, float, int]] = field(default_factory=list)
    runtime: List[Tuple[float, float, int]] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device intervals, sorted."""
        out: List[List[float]] = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def span_s(self) -> float:
        b = self.busy()
        return (b[-1][1] - b[0][0]) / 1e6 if b else 0.0

    def device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, s, e, _ in self.device:
            tot[name[:120]] = tot.get(name[:120], 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device intervals, summed by the innermost host
        span covering each gap's start."""
        b = self.busy()
        spans = sorted(self.host, key=lambda h: (h[1], -h[2]))
        stacks: Dict[int, list] = {}  # per thread: the spans open at the sweep's time
        i = 0
        tot: Dict[str, float] = {}
        for (_, e0), (s1, _) in zip(b, b[1:]):
            if s1 <= e0:
                continue
            while i < len(spans) and spans[i][1] <= e0:
                st = stacks.setdefault(spans[i][3], [])
                while st and st[-1][2] < spans[i][1]:
                    st.pop()
                st.append(spans[i])
                i += 1
            name, best = "(between host ops)", -1.0
            for st in stacks.values():
                while st and st[-1][2] < e0:
                    st.pop()
                if st and st[-1][1] > best:
                    name, best = st[-1][0], st[-1][1]
            tot[name[:120]] = tot.get(name[:120], 0.0) + (s1 - e0) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def device_time_under(self, span_prefix: str) -> float:
        """Seconds of device ops launched from inside host spans whose name
        starts with ``span_prefix`` (runtime calls matched by correlation)."""
        spans = [(s, e) for name, s, e, _ in self.host if name.startswith(span_prefix)]
        corr = {c for s, e, c in self.runtime if any(a <= s and e <= b for a, b in spans)}
        return sum(e - s for _, s, e, c in self.device if c in corr) / 1e6

    def device_time_of(self, names) -> float:
        return sum(e - s for n, s, e, _ in self.device if any(k in n for k in names)) / 1e6


@dataclass
class Traced:
    """A traced run's two stretches: ``device`` (CUDA activity alone) and
    ``hosted`` (CPU ops too)."""
    device: Stretch
    hosted: Stretch


def trace_window(step: Callable[[], None], steps: int, sync: Callable[[], None],
                 launches: Callable[[], Dict[str, int]]) -> Traced:
    """``steps`` steps traced with CUDA activity alone, then ``steps`` more
    with the CPU ops too."""
    return Traced(device=profile_steps(step, steps, sync, launches, host=False),
                  hosted=profile_steps(step, steps, sync, launches, host=True))


def profile_steps(step: Callable[[], None], steps: int, sync: Callable[[], None],
                  launches: Callable[[], Dict[str, int]], host: bool) -> Stretch:
    """Run ``steps`` steps under torch.profiler (CUDA activity, and with
    ``host`` the CPU ops) and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    before = dict(launches())
    sync()
    wanted = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    # without a card (the CPU tests) only the host can be recorded
    activities = [a for a in wanted if a in supported_activities()] or [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        window = time.perf_counter() - t0
    after = launches()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    st = Stretch(steps=steps, window_s=window,
                 launches={k: after[k] - before.get(k, 0) for k in after})
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev.get("ts", 0)), float(ev.get("dur", 0))
        args = ev.get("args", {}) or {}
        corr = int(args.get("correlation", -1) or -1)
        if cat in DEVICE_CATS:
            st.device.append((ev.get("name", ""), ts, ts + dur, corr))
        elif cat in ("cpu_op", "user_annotation"):
            st.host.append((ev.get("name", ""), ts, ts + dur, int(ev.get("tid", 0) or 0)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            st.runtime.append((ts, ts + dur, corr))
    return st
