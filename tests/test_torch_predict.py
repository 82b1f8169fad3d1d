"""Slice parity: the PyTorch port's predict against JAX FasterRCNN.predict.

Both run the same bridged weights on the same seeded uint8 images
through their predict steps (normalization included), in f32 on the
CPU, with exact top-k and reference RoI routing (use_approx_topk=False,
roi_align_mode='gather'). At batch 1 the port takes its fused paths
(conv3x3 and RPN-head plain versions); JAX on the CPU takes its XLA
convs, so the batch-1 case also crosses the two conv formulations.
Tolerances are those of tests/test_full_parity.py:95-96.
"""
import jax
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.engine.train import make_eval_step as jax_eval_step

from nsgp_repre_tpu_torch.engine.train import make_eval_step
from torch_port_util import batches, f32_matmuls, images, jax_and_port

HW = (64, 96)


@pytest.fixture(scope="module")
def runs():
    f32_matmuls()
    model, variables, port = jax_and_port(HW, seed=0)
    step = jax.jit(jax_eval_step(model))
    out = {}
    for B in (1, 2):
        imgs = images((B,) + HW, seed=B)
        # image 1 of the pair is smaller than the canvas: per-image clip
        # shapes and rescale factors differ inside the batch
        shp = np.array([[64, 96], [48, 80]], np.int32)[:B]
        sf = np.array([[1.0, 1.0], [0.5, 0.625]], np.float32)[:B]
        jb, tb = batches(imgs, shp, sf)
        jd = step(variables, jb)
        td = make_eval_step(port)(tb)
        out[B] = (jax.tree_util.tree_map(np.asarray, jd), td)
    return out


@pytest.mark.parametrize("B", [1, 2])
def test_predict_matches_jax(runs, B):
    jd, td = runs[B]
    for b in range(B):
        jv = jd.valid[b]
        tv = td.valid[b].numpy()
        n = int(jv.sum())
        assert n > 0, "degenerate test: no detections survived"
        assert int(tv.sum()) == n
        np.testing.assert_array_equal(td.labels[b].numpy()[tv], jd.labels[b][jv])
        np.testing.assert_allclose(td.scores[b].numpy()[tv], jd.scores[b][jv],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(td.boxes[b].numpy()[tv], jd.boxes[b][jv],
                                   rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("B", [1, 2])
def test_predict_future_task_masked(runs, B):
    """task_id=1 of (0, 4, 6): no detection carries a class of task 2."""
    _, td = runs[B]
    assert (td.labels[td.valid] < 4).all()
    assert torch.isfinite(td.boxes).all() and torch.isfinite(td.scores).all()
