"""Device milliseconds per step of the ops launched inside the program's
span ``nsgp.<variant>`` (``nsgp.backbone``, ``nsgp.optimizer``, ...),
nested spans included; read from the span stretch (portbench/spans.py).
A run in which the span never opened reads nothing."""

from portbench.spans import span_stretch

UNIT = "ms"


def read(traced, entry, variant):
    stretch = span_stretch(traced, entry)
    return None if stretch is None else stretch.layer_ms(variant)
