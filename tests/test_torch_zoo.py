"""The port's model zoo against the JAX package: ``build_detector`` on
every ``_base_/models`` config, RPN, Fast R-CNN and Cascade
R-CNN (loss terms, every gradient, predict), SmoothL1 and the
class-agnostic bbox head.

Both sides build each family from the same config with both packages'
model zoos at a small size (tests/torch_port_util.py::ZOO_SMALL: 64x64
images, one bottleneck per stage, 32 proposals, rcnn_num 16, 4
classes) and run the same perturbed weights through the bridge on the
same seeded images and gt boxes, in f32 on the CPU. JAX runs its XLA
paths, compiled once per family; its sampling draws are re-derived from
the key splits of each family's loss (torch_port_util.zoo_priorities).

Tolerances: loss terms to 1e-5 relative; every parameter gradient to
2e-4 of its largest magnitude, plus the slack of the ReLU flips counted
at the trainable bottlenecks and the bbox heads (torch_port_util
.flip_slack); predictions with the same valid slots and labels, boxes
to 1e-3 px and scores to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.engine.train import normalize_images as jax_normalize
from nsgp_repre_tpu.models import losses as jax_losses
from nsgp_repre_tpu.models.bbox_head import Shared2FCBBoxHeadTask as JaxHead
from nsgp_repre_tpu.models.zoo import build_detector as jax_build_detector
from nsgp_repre_tpu.structures.sample import InstanceArray as JaxInstances
from nsgp_repre_tpu.testing import demo_det_batch as jax_demo_batch
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree
from nsgp_repre_tpu.utils.config import load_config as jax_load_config

from nsgp_repre_tpu_torch import testing as ttesting
from nsgp_repre_tpu_torch.engine.train import normalize_images
from nsgp_repre_tpu_torch.models import losses as tlosses
from nsgp_repre_tpu_torch.models.bbox_head import Shared2FCBBoxHeadTask
from nsgp_repre_tpu_torch.models.zoo import build_detector
from nsgp_repre_tpu_torch.structures.sample import InstanceArray
from nsgp_repre_tpu_torch.utils.config import load_config
from torch_port_util import (MODELS, family_loss_runs, f32_matmuls, flip_slack, images, n_flips,
                             zoo_jax_and_port, zoo_priorities)

HW = (64, 64)
B = 2
G = 4
LOSS_RTOL = 1e-5
GRAD_REL = 2e-4

TWO_STAGE = [
    ("faster-rcnn_r50_fpn.py", "FasterRCNN"),
    ("rpn_r50_fpn.py", "RPN"),
    ("fast-rcnn_r50_fpn.py", "FastRCNN"),
    ("mask-rcnn_r50_fpn.py", "MaskRCNN"),
    ("cascade-rcnn_r50_fpn.py", "CascadeRCNN"),
    ("cascade-mask-rcnn_r50_fpn.py", "CascadeMaskRCNN"),
]
REST = ["retinanet_r50_fpn.py", "ssd300.py", "faster-rcnn_r50-caffe-c4.py",
              "faster-rcnn_r50-caffe-dc5.py", "mask-rcnn_r50-caffe-c4.py", "rpn_r50-caffe-c4.py"]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    f32_matmuls()
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# build_detector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config_file,cls_name", TWO_STAGE)
def test_build_detector_matches_jax_config(config_file, cls_name):
    """Each two-stage config builds the same family with the same config
    fields on both sides; the port's module is seeded (two builds give
    the same weights) and on the device asked for."""
    path = f"{MODELS}/{config_file}"
    _, jcfg = jax_build_detector(jax_load_config(path)["model"], num_classes=4,
                                 backbone_blocks=(1, 1, 1, 1))
    det, cfg = build_detector(load_config(path)["model"], num_classes=4, device="cpu",
                              backbone_blocks=(1, 1, 1, 1))
    assert type(det).__name__ == cls_name
    assert type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                       if k in dataclasses.asdict(cfg)}
    again, _ = build_detector(load_config(path)["model"], num_classes=4, device="cpu",
                              backbone_blocks=(1, 1, 1, 1))
    for (k, a), b in zip(det.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    assert next(det.parameters()).device.type == "cpu" and not det.training


@pytest.mark.parametrize("config_file", REST)
def test_build_detector_rest_of_zoo_matches_jax_config(config_file):
    """The single-stage and caffe C4/DC5 configs build JAX's family with
    JAX's config fields (overrides a family's config lacks are dropped on
    both sides: SSD's VGG has no ``backbone_blocks``); the port's module is
    seeded and on the device asked for (tests/test_torch_single_stage.py and
    tests/test_torch_c4.py hold the families against JAX)."""
    path = f"{MODELS}/{config_file}"
    jax_model, jcfg = jax_build_detector(jax_load_config(path)["model"], num_classes=4,
                                         backbone_blocks=(1, 1, 1, 1))
    det, cfg = build_detector(load_config(path)["model"], num_classes=4, device="cpu",
                              backbone_blocks=(1, 1, 1, 1))
    assert type(det).__name__ == type(jax_model).__name__
    assert type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    again, _ = build_detector(load_config(path)["model"], num_classes=4, device="cpu",
                              backbone_blocks=(1, 1, 1, 1))
    for (k, a), b in zip(det.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    assert next(det.parameters()).device.type == "cpu" and not det.training


def test_build_detector_needs_a_device_named_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(load_config(f"{MODELS}/cascade-rcnn_r50_fpn.py")["model"])


# ---------------------------------------------------------------------------
# SmoothL1 and the class-agnostic head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [1.0, 1.0 / 9.0])
def test_smooth_l1_matches_jax(beta):
    rng = np.random.RandomState(0)
    pred, tgt = rng.randn(64, 4).astype(np.float32), rng.randn(64, 4).astype(np.float32)
    w = (rng.rand(64, 1) > 0.4).astype(np.float32)
    got = tlosses.weighted_smooth_l1(_t(pred), _t(tgt), _t(w), 23.0, beta=beta)
    ref = jax_losses.weighted_smooth_l1(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(w), 23.0,
                                        beta=beta)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_class_agnostic_head_matches_jax():
    """One 4-output regressor that no task mask touches; the future
    task's logits are still masked."""
    head = JaxHead(task_split=(0, 3, 5), task_id=1, num_classes=5, reg_class_agnostic=True)
    x = np.random.RandomState(1).randn(6, 7, 7, 256).astype(np.float32)
    v = head.init(jax.random.PRNGKey(0), jnp.zeros((1, 7, 7, 256)))
    rng = np.random.RandomState(2)
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05),
                               v)
    cls, reg = head.apply(v, jnp.asarray(x))
    port = Shared2FCBBoxHeadTask(task_split=(0, 3, 5), task_id=1, num_classes=5,
                                 reg_class_agnostic=True)
    flat = _flatten_tree(v["params"])
    sd = {}
    for k, a in flat.items():
        mod, leaf = k.rsplit("/", 1)
        name = {"shared_fc1": "shared_fcs.0", "shared_fc2": "shared_fcs.1", "fc_cls0": "fc_cls.0",
                "fc_cls1": "fc_cls.1", "fc_cls_bg": "fc_cls.2", "fc_reg0": "fc_reg.0"}[mod]
        sd[f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = _t(
            np.asarray(a).T if leaf == "kernel" else a)
    port.load_state_dict(sd, strict=True)
    got_cls, got_reg = port(_t(x))
    assert tuple(got_reg.shape) == (6, 4) and len(port.fc_reg) == 1
    # the same f32 products over 12,544 inputs, summed in another order
    for got, ref in ((got_cls[:, :3], cls[:, :3]), (got_cls[:, 5:], cls[:, 5:]), (got_reg, reg)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5 * np.abs(ref).max())
    assert (got_cls[:, 3:5] == -1e10).all() and got_reg.abs().sum() > 0


# ---------------------------------------------------------------------------
# the families: loss terms, gradients, predict
# ---------------------------------------------------------------------------

def _batches(seed=0):
    """The same normalized batch for both sides: seeded smooth images, 2
    and 3 gt boxes of classes 0-3 (demo_det_batch's numbers)."""
    jb = jax_demo_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G, seed=seed)
    tb = ttesting.demo_det_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G,
                                 seed=seed)
    imgs = images((B,) + HW, seed=seed)
    jb = jb.replace(images=jax_normalize(jnp.asarray(imgs)))
    tb = tb.replace(images=normalize_images(torch.from_numpy(imgs)))
    return jb, tb


def _external_proposals(n=24, seed=5):
    """Seeded proposals for Fast R-CNN: jittered around the canvas, a
    few invalid slots."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (B, n, 2))
    wh = rng.uniform(8, 30, (B, n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 64)], -1).astype(np.float32)
    valid = rng.rand(B, n) > 0.1
    labels = np.zeros((B, n), np.int32)
    return (JaxInstances(boxes=jnp.asarray(boxes), labels=jnp.asarray(labels),
                         valid=jnp.asarray(valid)),
            InstanceArray(boxes=_t(boxes), labels=_t(labels), valid=_t(valid)))


def _check_losses(run):
    got, ref = run["losses"], run["jax_losses"]
    assert set(got) == set(ref)
    for k in ref:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def _check_grads(run, max_flips=4):
    """Every gradient within GRAD_REL (+ the flips' slack) of its largest
    magnitude; the same parameters get one on both sides, the frozen stem
    and layer1 none."""
    flips = run["flips"]
    assert n_flips(flips) <= max_flips, flips
    frozen = ("backbone.conv1", "backbone.bn1", "backbone.layer1.")
    ref, got = run["jax_grads"], run["grads"]
    assert ref.keys() == got.keys()
    assert any(np.abs(g).max() > 0 for g in got.values())
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert (np.abs(got[k]).max() > 0) == (scale > 0), k
        assert not (k.startswith(frozen) and scale > 0), k
        err = np.abs(got[k] - ref[k]).max()
        assert err <= (GRAD_REL + flip_slack(flips, k)) * max(scale, 1e-6), (k, err, scale, flips)


def _check_predictions(jd, td):
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    v = np.asarray(jd.valid)
    assert v.any()
    np.testing.assert_array_equal(td.labels.numpy()[v], np.asarray(jd.labels)[v])
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-5)


def _run_family(config_file, kind, proposals=None):
    model, variables, port, cfg = zoo_jax_and_port(config_file, image_hw=HW)
    jb, tb = _batches()
    rng = jax.random.PRNGKey(7)
    pri = zoo_priorities(kind, rng, cfg, B, HW, G,
                         n_proposals=None if proposals is None else proposals[1].boxes.shape[1])
    jax_args, port_kw = ((), {}) if proposals is None else ((proposals[0],),
                                                            {"proposals": proposals[1]})
    run = family_loss_runs(model, variables, port, jb, tb, rng, pri, jax_args, port_kw)
    jd = jax.jit(lambda v, b, *a: model.apply(v, b, *a, method=model.predict))(
        variables, jb, *jax_args)
    with torch.no_grad():
        td = port.predict(tb, *port_kw.values())
    return run, port, jd, td


def test_rpn_matches_jax():
    run, port, jd, td = _run_family("rpn_r50_fpn.py", "RPN")
    assert set(run["losses"]) == {"loss_rpn_cls", "loss_rpn_bbox"}
    _check_losses(run)
    _check_grads(run)
    assert not td.labels.any()
    _check_predictions(jd, td)


def test_fast_rcnn_matches_jax():
    run, port, jd, td = _run_family("fast-rcnn_r50_fpn.py", "FastRCNN", _external_proposals())
    assert set(run["losses"]) == {"loss_cls", "loss_bbox", "acc"}
    _check_losses(run)
    _check_grads(run)
    _check_predictions(jd, td)


def test_cascade_rcnn_matches_jax():
    run, port, jd, td = _run_family("cascade-rcnn_r50_fpn.py", "CascadeRCNN")
    assert {f"s{i}.loss_{t}" for i in range(3) for t in ("cls", "bbox")} <= set(run["losses"])
    assert run["losses"]["s1.loss_cls"] < run["losses"]["s0.loss_cls"]
    _check_losses(run)
    _check_grads(run)
    _check_predictions(jd, td)


@pytest.mark.parametrize("config_file", ["faster-rcnn_r50_fpn.py", "mask-rcnn_r50_fpn.py",
                                         "cascade-rcnn_r50_fpn.py",
                                         "cascade-mask-rcnn_r50_fpn.py"])
def test_split_losses_equal_the_family_loss(config_file):
    """testing.split_losses (the card-against-CPU cut of chip_smoke.py's
    model-zoo phase) gives the family's loss, with the draws of
    testing.draw_priorities keyed as each loss reads them."""
    from nsgp_repre_tpu_torch.testing import draw_priorities, split_losses
    from torch_port_util import ZOO_SMALL

    det, cfg = build_detector(load_config(f"{MODELS}/{config_file}")["model"], num_classes=4,
                              device="cpu", **ZOO_SMALL)
    batch = ttesting.demo_det_batch(B, *HW, num_instances=(2, 3), num_classes=4,
                                    gt_capacity=G, seed=2)
    batch = batch.replace(gt=batch.gt.replace(
        masks=torch.rand((B, G, 56, 56), generator=torch.Generator().manual_seed(0))))
    n = sum(-(-HW[0] // s) * -(-HW[1] // s) * cfg.num_base_priors for s in cfg.anchor_strides)
    pri = draw_priorities(det, B, n, G, torch.Generator().manual_seed(1))
    got, props = split_losses(det, batch, pri)
    with torch.no_grad():
        ref = det.loss(batch.replace(images=normalize_images(batch.images)), priorities=pri)
    assert got == {k: float(v) for k, v in ref.items()}
    assert ("loss_mask" in got) == ("mask" in config_file)
    assert props.boxes.shape == (B, cfg.rpn_max_per_img, 4)
