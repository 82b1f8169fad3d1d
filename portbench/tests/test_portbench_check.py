"""The check that decides ``correct``, driven at a tiny size on the CPU.

The frozen reference against the port's plain (CPU) path in float32; the
whole run with each fault a cell can have planted under the timed path
(a step that leaves the state unchanged, half the batch left out with the
mean over the rest, the replay or the EWC term left out of the step, an
answer altered where it is produced), which must
come out not correct; and the control, the reference with float8
operands in the program's place, which must exceed a limit."""
import pytest

from portbench.calibrate import readings
from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345
TRAIN = ("frcnn-voc-task2.train-b16", "mask-rcnn-coco.train-b8")


def run(name, fault=""):
    return run_cell(tiny_cell(name), SEED, 0.5, False, device="cpu", fault=fault,
                    log=lambda *a, **k: None)


@pytest.mark.parametrize("name", TRAIN)
def test_reference_follows_the_port_in_float32(name):
    out = run(name)
    assert out["correct"]
    # float32 on both sides: every compared number agrees to rounding
    assert all(v["value"] < 1e-4 for v in out["checked"].values()), out["checked"]


def test_predict_reference_follows_the_port_in_float32():
    out = run("frcnn-voc-task2.val-b16")
    assert out["correct"] and out["checked"]["missed"]["value"] == 0.0


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAIN for f in ("frozen_step", "half_batch")]
                         + [(TRAIN[0], f) for f in ("drop_replay", "drop_ewc")]
                         + [("frcnn-voc-task2.val-b16", "altered_answer")])
def test_planted_fault_is_not_correct(name, fault):
    assert not run(name, fault)["correct"]


@pytest.mark.parametrize("name", TRAIN + ("frcnn-voc-task2.val-b16",))
def test_control_exceeds_a_limit(name):
    cell = tiny_cell(name)
    (row,) = list(readings(cell, [], [SEED], "", [], device="cpu"))
    assert any(row[k] > v for k, v in cell["limits"].items()), row
