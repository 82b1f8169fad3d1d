"""Device milliseconds per step of the work launched inside torch's own
``Optimizer.step#...`` scope (the NSCL update with its projections); read
from the stretch traced with the CPU ops, which alone has host scopes."""

UNIT = "ms"


def read(traced, entry, variant):
    if traced is None:
        return None
    hosted = traced.hosted
    t = hosted.device_time_under("Optimizer.step#")
    return 1e3 * t / hosted.steps if t > 0 else None
