"""Named spans at the port's layer boundaries, for torch's profiler.

``with span("backbone"):`` records a ``nsgp.backbone`` range when a
profiler is running, and costs one flag check when none is: the span is
then a shared null context. The check reads the profiler's C-level flag,
which every way of starting it sets (``torch.profiler.profile`` and the
low-level ``_enable_profiler`` alike). Spans live in the profiler's own
buffers and leave with its trace; nothing here keeps state.

The steps' spans: ``train_step`` (engine/train.py), ``predict``,
``backbone``, ``rpn``, ``proposals``, ``roi``, ``replay``
(models/detector.py), ``mask`` (models/mask.py), ``ewc``, ``backward``,
``optimizer`` (engine/train.py); the train loop's loader waits,
``runner.loader_wait`` (engine/runner.py).
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "nsgp."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``nsgp.<name>`` profiler range while a profiler runs, else a no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
