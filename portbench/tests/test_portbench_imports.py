"""No module a run loads is JAX's or the JAX package's (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the port."""
import json
import subprocess
import sys

from portbench import common

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell
run_cell(tiny_cell({cell!r}), 7, 0.2, {trace}, device="cpu", log=lambda *a, **k: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.detector, portbench.common, portbench.flops, portbench.peaks
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=str(common.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    for cell, trace in (("frcnn-voc-task2.train-b16", True), ("frcnn-voc-task2.val-b16", False)):
        names = top_level(RUN.format(root=str(common.ROOT), cell=cell, trace=trace))
        assert "nsgp_repre_tpu_torch" in names
        assert not names & {"jax", "jaxlib", "flax", "nsgp_repre_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    names = top_level(REF.format(root=str(common.ROOT)))
    assert not names & {"jax", "jaxlib", "flax", "nsgp_repre_tpu", "nsgp_repre_tpu_torch"}
