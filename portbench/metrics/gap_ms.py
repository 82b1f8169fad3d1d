"""Device idle milliseconds per step of the gaps between device ops that
start while the program's span ``nsgp.<variant>`` is the innermost one
open; ``step``: the step's own span with no layer span inside it open,
``outside``: no program span open (the window loop, the host work of an
entry around the step). Read from the span stretch (portbench/spans.py);
the variants of one run sum to its inter-op idle. A run in which the span
never opened reads nothing."""

from portbench.spans import span_stretch

UNIT = "ms"


def read(traced, entry, variant):
    stretch = span_stretch(traced, entry)
    return None if stretch is None else stretch.gap_ms(variant)
