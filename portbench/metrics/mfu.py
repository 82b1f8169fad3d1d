"""The whole step's share of the chip's dense bf16 peak: the model FLOPs
of the cell's shapes (portbench/flops.py) times the traced steps, over the
device timeline's span from the first op to the last, over 989e12; read
from the stretch traced with CUDA activity alone."""

from portbench.peaks import PEAK_FLOPS

UNIT = "%"


def read(traced, entry, variant):
    stretch = traced.device if traced is not None else None
    if stretch is None or stretch.span_s() <= 0:
        return None
    return 100.0 * entry.flops_per_step() * stretch.steps / stretch.span_s() / PEAK_FLOPS["bfloat16"]
