"""Kernel-launch calls per step (``cudaLaunchKernel`` and its driver and
extended forms) made from inside the program's span ``nsgp.<variant>``
(``step``: the step's own span); read from the span stretch
(portbench/spans.py). A run in which the span never opened reads
nothing."""

from portbench.spans import span_stretch

UNIT = "launches"


def read(traced, entry, variant):
    stretch = span_stretch(traced, entry)
    return None if stretch is None else stretch.kernel_launches(variant)
