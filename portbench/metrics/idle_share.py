"""The device's idle share over the stretch traced with CUDA activity
alone: 1 - (union of the intervals in which a kernel, copy or set ran) /
(the stretch's host-clock length), in percent."""

UNIT = "%"


def read(traced, entry, variant):
    stretch = traced.device if traced is not None else None
    if stretch is None or stretch.window_s <= 0 or not stretch.device:
        return None
    return 100.0 * (1.0 - stretch.busy_s() / stretch.window_s)
