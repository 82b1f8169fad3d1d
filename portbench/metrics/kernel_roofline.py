"""The hand-written kernels' share of their roofline over the traced
steps: the least time their work needs (portbench/kernels/<function>.py,
at the step's shapes, for each launch the step makes) over the device time
of every op those kernels run as, in the stretch traced with CUDA
activity alone. A step whose launches differ from the shapes it states
reads nothing."""

from portbench import common
from portbench.peaks import least_seconds

UNIT = "%"


def read(traced, entry, variant):
    stretch = traced.device if traced is not None else None
    if stretch is None:
        return None
    calls = entry.kernel_calls()
    want = {}
    for fn, _ in calls:
        want[fn] = want.get(fn, 0) + stretch.steps
    got = {k: v for k, v in stretch.launches.items() if v}
    if got != want:
        return None
    least, names = 0.0, set()
    for fn, shape in calls:
        mod = common.load_module("kernels", fn)
        least += least_seconds(*mod.work(**shape)) * stretch.steps
        names.update(mod.NAMES)
    spent = stretch.device_time_of(tuple(names))
    return 100.0 * least / spent if spent > 0 else None
