"""On the card: each cell's run through the benchmark's command, short, reads correct;
the float8 control at the cell's own size exceeds a limit. Skips without a
CUDA device (decided inside the test)."""
import json
import subprocess
import sys

import pytest

from portbench import common

CELLS = sorted(p.stem for p in (common.BENCH / "workloads").glob("*.json"))


def need_card(chips=1):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip("needs CUDA device(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name):
    need_card(common.load_json("workloads", name)["chips"])
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", "4242424242",
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True,
                         timeout=1200, cwd=str(common.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_full_size(name):
    need_card(common.load_json("workloads", name)["chips"])
    from portbench.calibrate import readings

    cell = common.load_json("workloads", name)
    (row,) = list(readings(cell, [], [4242424243], "", []))
    assert any(row[k] > v for k, v in cell["limits"].items()), row
