"""Data parallel (parallel/mesh.py) across the model zoo, against the JAX
package's two-device mesh, on the CPU.

Each family's loss normalizer is summed over the ranks at its own site
(cascade.py: each stage's terms and accuracy; mask.py: the mask loss;
single_stage.py: RetinaNet's positives; ssd.py: SSD's positives), and
engine/train.py's ``rank_loss`` scales every per-batch term by W: a site
left with its rank's own count weights that term wrongly. So for
Cascade Mask R-CNN, RetinaNet and SSD300, built by both packages' model
zoos at ZOO_SMALL with the same perturbed weights (tests/torch_port_util.py),
one loss and gradient on a two-image batch whose ranks count different
samples (image 1 has one gt box and, for the two-stage family, a 12x16
``img_shape``, with samplers that take every valid candidate): JAX's
``jax.value_and_grad`` of the family's loss on ``create_mesh(2)`` with the
batch sharded and the weights replicated, against two gloo ranks of
tests/torch_parallel_worker.py (``family`` mode), each given its image
and the global draws, backpropagating ``rank_loss`` and averaging the
gradients.

Tolerances: loss terms within rtol 1e-4 (test_torch_parallel.py's); every
parameter gradient within 2e-4 of its largest magnitude (the zoo tests'
GRAD_REL) plus the slack of the ReLU flips between the two packages
(tests/torch_port_util.py::flip_slack), counted by the port and JAX
on one device on the same batch (``family_loss_runs``); the ranks' terms
and gradients bit-equal. The per-rank normalizers (each half alone, the
terms averaged) miss JAX's terms by more than ten times the tolerance.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.engine.train import total_loss as jax_total_loss
from nsgp_repre_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from nsgp_repre_tpu.structures.sample import DetBatch as JaxBatch
from nsgp_repre_tpu.structures.sample import InstanceArray as JaxInstances
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree

from nsgp_repre_tpu_torch.engine.train import normalize_images
from nsgp_repre_tpu_torch.parallel import mesh
from nsgp_repre_tpu_torch.structures.sample import DetBatch, InstanceArray
from nsgp_repre_tpu_torch.testing import demo_det_batch
from nsgp_repre_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_util import (MODELS, ZOO_SMALL, f32_matmuls, family_loss_runs, flip_slack, images,
                             n_flips, spawn_worker, wait_workers, zoo_jax_and_port,
                             zoo_priorities)

B = 2
G = 4
LOSS_RTOL = 1e-4
GRAD_REL = 2e-4
# (config, class, image (h, w), image 1's img_shape, the samplers' overrides,
#  the terms whose per-rank normalizer the batch must tell apart)
FAMILIES = [
    ("cascade-mask-rcnn_r50_fpn.py", "CascadeMaskRCNN", (64, 96), (12, 16),
     dict(rpn_num=512, rcnn_num=64), ("loss_rpn_cls", "s0.loss_cls", "s1.loss_cls",
                                      "s2.loss_cls", "loss_mask")),
    ("retinanet_r50_fpn.py", "RetinaNet", (64, 96), (64, 96), {}, ("loss_cls", "loss_bbox")),
    ("ssd300.py", "SSD", (257, 257), (257, 257), {}, ("loss_cls",)),
]


def _batch(hw, small_shape, masks):
    """Image 0 with three gt boxes; image 1 with one box in ``small_shape``
    (the canvas's top-left corner): the ranks count different positives,
    and for the two-stage family different valid anchors and proposals.
    Both images normalized, as the families' losses take them; with
    ``masks``, seeded 56x56 soft gt masks."""
    h, w = small_shape
    tb = demo_det_batch(B, *hw, num_instances=(3, 1), num_classes=4, gt_capacity=G, seed=3)
    z = dict(images=normalize_images(torch.from_numpy(images((B,) + hw, seed=3))).numpy(),
             img_shape=tb.img_shape.numpy().copy(), scale_factor=np.ones((B, 2), np.float32),
             gt_boxes=tb.gt.boxes.numpy().copy(), gt_labels=tb.gt.labels.numpy().copy(),
             gt_valid=tb.gt.valid.numpy())
    z["img_shape"][1] = small_shape
    z["gt_boxes"][1, 0] = (w / 8, h / 12, w * 7 / 8, h * 11 / 12)
    z["gt_labels"][1, 0] = 1
    if masks:
        z["gt_masks"] = np.random.RandomState(6).rand(B, G, 56, 56).astype(np.float32)
    jm = jnp.asarray(z["gt_masks"]) if masks else None
    jb = JaxBatch(images=jnp.asarray(z["images"]), img_shape=jnp.asarray(z["img_shape"]),
                  ori_shape=jnp.asarray(z["img_shape"]),
                  scale_factor=jnp.asarray(z["scale_factor"]),
                  gt=JaxInstances(boxes=jnp.asarray(z["gt_boxes"]),
                                  labels=jnp.asarray(z["gt_labels"]),
                                  valid=jnp.asarray(z["gt_valid"]), masks=jm))
    t = torch.from_numpy
    tb = DetBatch(images=t(z["images"]), img_shape=t(z["img_shape"]),
                  ori_shape=t(z["img_shape"]), scale_factor=t(z["scale_factor"]),
                  gt=InstanceArray(boxes=t(z["gt_boxes"]), labels=t(z["gt_labels"]),
                                   valid=t(z["gt_valid"]),
                                   masks=t(z["gt_masks"]) if masks else None))
    return z, jb, tb


def _jax_on_mesh(model, variables, jb, rng):
    """The family's loss terms and gradient (port names) on a two-device
    mesh: the batch sharded, the weights replicated."""
    dmesh = create_mesh(2)
    jbs = shard_batch(jb, dmesh)
    v = replicate(variables, dmesh)

    def loss_fn(p):
        losses = model.apply({"params": p, "batch_stats": v["batch_stats"]}, jbs, rng,
                             method=model.loss)
        return jax_total_loss(losses), losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    grads = {k: g.numpy() for k, g in
             state_dict_from_jax(_flatten_tree(jax.device_get(jg)), {}).items()}
    return {k: float(x) for k, x in jl.items()}, grads


@pytest.fixture(scope="module", params=FAMILIES, ids=[f[1] for f in FAMILIES])
def family_run(request, tmp_path_factory):
    """One family at world 2 (the ranks started first, running while JAX
    compiles) and on JAX's mesh, on the same weights, batch and draws."""
    config_file, kind, hw, small_shape, overrides, told = request.param
    tmp = tmp_path_factory.mktemp(f"dp_{kind}")
    f32_matmuls()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model, variables, port, cfg = zoo_jax_and_port(config_file, image_hw=hw, **overrides)
        assert type(port).__name__ == kind
        z, jb, tb = _batch(hw, small_shape, masks="Mask" in kind)
        rng = jax.random.PRNGKey(7)
        pri = zoo_priorities(kind, rng, cfg, B, hw, G)
        inp = dict(z, cfg_file=f"{MODELS}/{config_file}", num_classes=4,
                   overrides=json.dumps(dict(ZOO_SMALL, **overrides)))
        inp.update({f"sd/{k}": v.numpy() for k, v in port.state_dict().items()})
        inp.update({f"pri/{k}": v.numpy() for k, v in pri.items()})
        np.savez(tmp / "input.npz", **inp)
        procs = {f"rank{r}": spawn_worker(["family", tmp / "input.npz", tmp, r, 2, tmp / "init"],
                                          tmp, f"rank{r}") for r in (0, 1)}
        try:
            ref_losses, ref_grads = _jax_on_mesh(model, variables, jb, rng)
            # the ReLU flips between the packages on this batch, on one device
            flips = family_loss_runs(model, variables, port, jb, tb, rng, pri)["flips"]
            local = []
            with torch.no_grad():  # each half with its own normalizers
                for r in (0, 1):
                    local.append({k: float(v) for k, v in port.loss(
                        mesh.shard_rows(tb, r, 2),
                        priorities={k: mesh.shard_rows(v, r, 2) for k, v in pri.items()}).items()})
        finally:
            wait_workers(procs, tmp)
        ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)]
    finally:
        torch.set_num_threads(n)
        shutil.rmtree(tmp)
    return dict(kind=kind, told=told, ref_losses=ref_losses, ref_grads=ref_grads, flips=flips,
                local=local, ranks=ranks, port=port)


def test_the_batch_tells_global_from_local(family_run):
    """The mean of each half's terms taken alone misses JAX's mesh by far
    more than the tolerance on every term whose normalizer is checked."""
    ref, local = family_run["ref_losses"], family_run["local"]
    misses = {k: abs((local[0][k] + local[1][k]) / 2 - ref[k]) / abs(ref[k])
              for k in family_run["told"]}
    assert all(m > 10 * LOSS_RTOL for m in misses.values()), misses


def test_family_loss_terms_match_jax_mesh(family_run):
    ref = family_run["ref_losses"]
    for r in family_run["ranks"]:
        got = {k[2:]: float(v) for k, v in r.items() if k.startswith("m/")}
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    r0, r1 = family_run["ranks"]
    assert all(np.array_equal(r0[k], r1[k]) for k in r0 if k.startswith("m/"))


def test_family_gradients_match_jax_mesh(family_run):
    """The averaged gradients are bit-equal on the ranks and match JAX's
    mesh; the frozen stem and layer1 get none."""
    ref, flips = family_run["ref_grads"], family_run["flips"]
    assert n_flips(flips) <= 16, flips
    r0, r1 = family_run["ranks"]
    got = {k[2:]: v for k, v in r0.items() if k.startswith("g/")}
    assert got.keys() == ref.keys()
    assert all(np.array_equal(v, r1[f"g/{k}"]) for k, v in got.items())
    frozen = ("backbone.conv1", "backbone.bn1", "backbone.layer1.")
    moved = 0
    for k, want in ref.items():
        scale = np.abs(want).max()
        moved += scale > 0
        assert (np.abs(got[k]).max() > 0) == (scale > 0), k
        assert not (k.startswith(frozen) and scale > 0), k
        err = np.abs(got[k] - want).max()
        assert err <= (GRAD_REL + flip_slack(flips, k)) * max(scale, 1e-6), (k, err, scale, flips)
    assert moved > len(ref) // 2
