"""The port's mask branch against the JAX package: the transposed conv's
weight bridge, the FCN mask head, the mask targets (the crops' resample
over a RoI), ``paste_masks`` and ``normalize_gt_masks``, and Mask R-CNN
and Cascade Mask R-CNN loss terms, gradients and predicted masks.

The families run as in tests/test_torch_zoo.py (both model zoos at
ZOO_SMALL, 64x64, the same perturbed weights and seeded inputs, JAX
compiled once per family). Their gt masks are smooth random crops in
[0, 1]. The targets are crops resampled over each RoI and thresholded
at 0.5, and binary crops put hundreds of target pixels of the injected
gt RoIs at exactly 0.5 (a RoI equal to its gt box samples the crop at
pixel corners, averaging two 1s and two 0s): there the decision rests on
the last bit of a sum, which XLA's fused arithmetic under jit and the
op-by-op arithmetic round apart. The
port's targets on binary crops, ties included, are held bit for bit
against JAX's target function run op by op (:func:`test_mask_targets_match_jax`).

Tolerances: the transposed conv and the mask head to 1e-5 of the
largest output; targets and pasted masks exact; loss terms to 1e-5
relative; gradients to 2e-4 of each tensor's largest magnitude plus
the counted ReLU flips' slack (the mask head's ReLUs counted too);
predicted mask probabilities to 1e-4 (after five f32 convolutions on
14x14 RoI features, summed in another order by XLA and by PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from nsgp_repre_tpu.engine.train import normalize_images as jax_normalize
from nsgp_repre_tpu.models.mask import FCNMaskHead as JaxMaskHead
from nsgp_repre_tpu.models.mask import _resample_normalized as jax_resample
from nsgp_repre_tpu.structures import mask_paste as jax_paste
from nsgp_repre_tpu.structures.boxes import bbox_overlaps as jax_bbox_overlaps
from nsgp_repre_tpu.testing import demo_det_batch as jax_demo_batch
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree

from nsgp_repre_tpu_torch import testing as ttesting
from nsgp_repre_tpu_torch.engine.train import normalize_images
from nsgp_repre_tpu_torch.models.mask import FCNMaskHead, mask_targets, resample_normalized
from nsgp_repre_tpu_torch.structures import mask_paste
from nsgp_repre_tpu_torch.structures.sample import InstanceArray
from nsgp_repre_tpu_torch.utils.convert import jax_flat_from_state_dict, state_dict_from_jax
from torch_port_util import (family_loss_runs, f32_matmuls, flip_slack, images, n_flips,
                             zoo_jax_and_port, zoo_priorities)

HW = (64, 64)
B = 2
G = 4
S = 56
LOSS_RTOL = 1e-5
GRAD_REL = 2e-4


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
# the transposed conv and the mask head
# ---------------------------------------------------------------------------

def test_conv_transpose_bridge_flips_the_kernel():
    """Flax's ConvTranspose kernel (kh, kw, in, out) is torch's
    ConvTranspose2d weight (in, out, kh, kw) flipped in both spatial
    axes: with the flip the outputs agree, without it they do not."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 6, 8).astype(np.float32)
    layer = nn.ConvTranspose(4, (2, 2), strides=(2, 2))
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = rng.randn(2, 2, 8, 4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    ref = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    sd = state_dict_from_jax({"mask_head/upsample/kernel": kernel,
                              "mask_head/upsample/bias": bias}, {})
    w = sd["roi_head.mask_head.upsample.weight"]
    assert tuple(w.shape) == (8, 4, 2, 2)
    xt = _t(x).permute(0, 3, 1, 2)

    def run(weight):
        return torch.nn.functional.conv_transpose2d(xt, weight, _t(bias), stride=2).permute(
            0, 2, 3, 1).numpy()

    np.testing.assert_allclose(run(w), ref, atol=1e-5 * np.abs(ref).max())
    unflipped = _t(np.transpose(kernel, (2, 3, 0, 1)))
    assert np.abs(run(unflipped) - ref).max() > 0.1
    back, _ = jax_flat_from_state_dict(sd)
    np.testing.assert_array_equal(back["mask_head/upsample/kernel"], kernel)


def test_mask_head_matches_jax():
    """FCNMaskHead (4 convs, the 2x transposed conv, the 1x1 logits) on
    14x14 RoI features, weights through the bridge."""
    head = JaxMaskHead(num_classes=5)
    x = np.random.RandomState(1).randn(3, 14, 14, 256).astype(np.float32)
    v = head.init(jax.random.PRNGKey(0), jnp.zeros((1, 14, 14, 256)))
    ref = np.asarray(head.apply(v, jnp.asarray(x)))
    flat = {f"mask_head/{k}": np.asarray(a) for k, a in _flatten_tree(v["params"]).items()}
    port = FCNMaskHead(5)
    port.load_state_dict({k[len("roi_head.mask_head."):]: t
                          for k, t in state_dict_from_jax(flat, {}).items()}, strict=True)
    got = port(_t(x)).detach().numpy()
    assert got.shape == (3, 28, 28, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# mask targets and the host-side mask functions
# ---------------------------------------------------------------------------

def _boxes(rng, n, lo=0.0, hi=64.0):
    x1, x2 = np.sort(rng.uniform(lo, hi, (2, n)), 0)
    y1, y2 = np.sort(rng.uniform(lo, hi, (2, n)), 0)
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


@pytest.mark.parametrize("binary", [True, False])
def test_resample_normalized_matches_jax(binary):
    """The resample of crops over RoIs, bit for bit against JAX op by op,
    RoIs partly outside their gt boxes and RoIs equal to them."""
    rng = np.random.RandomState(0)
    n = 96
    crop = rng.rand(n, S, S).astype(np.float32)
    if binary:
        crop = (crop > 0.5).astype(np.float32)
    gt = _boxes(rng, n)
    roi = _boxes(rng, n)
    roi[::4] = gt[::4]
    ref = np.asarray(jax.vmap(lambda c, r, g: jax_resample(c, r, g, 28))(crop, roi, gt))
    got = resample_normalized(_t(crop), _t(roi), _t(gt), 28).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref == 0).any() and (ref > 0).any()


def test_mask_targets_match_jax():
    """Each RoI's target from its IoU-argmax valid gt, thresholded at 0.5,
    on binary crops: equal to JAX's target function (mask.py:200-211) run
    op by op, the exact-0.5 ties included."""
    rng = np.random.RandomState(3)
    gt_boxes = _boxes(rng, B * G, 2, 62).reshape(B, G, 4)
    gt_valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    masks = (rng.rand(B, G, S, S) > 0.5).astype(np.float32)
    n = 40
    rois = _boxes(rng, n)
    bidx = rng.randint(0, B, n).astype(np.int32)
    rois[:6] = gt_boxes[bidx[:6], 0]  # RoIs equal to a gt box: the tie case

    def one_roi(roi, b):
        ious = jax_bbox_overlaps(roi[None, :], jnp.asarray(gt_boxes)[b])[0]
        ious = jnp.where(jnp.asarray(gt_valid)[b], ious, -1.0)
        g = jnp.argmax(ious)
        t = jax_resample(jnp.asarray(masks)[b, g], roi, jnp.asarray(gt_boxes)[b, g], 28)
        return (t > 0.5).astype(jnp.float32), t

    ref, raw = jax.vmap(one_roi)(jnp.asarray(rois), jnp.asarray(bidx))
    gt = InstanceArray(boxes=_t(gt_boxes), labels=torch.zeros(B, G, dtype=torch.int32),
                       valid=_t(gt_valid), masks=_t(masks))
    got = mask_targets(_t(rois), _t(bidx), gt, 28).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (np.asarray(raw) == 0.5).sum() > 100  # the ties are exercised


def test_paste_and_normalize_masks_match_jax():
    rng = np.random.RandomState(4)
    img_h, img_w = 64, 80
    bitmaps = np.zeros((3, img_h, img_w), np.uint8)
    boxes = np.array([[20.0, 10.0, 50.0, 30.0], [3.5, 7.2, 70.9, 60.1], [60.0, 40.0, 80.0, 64.0]],
                     np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
        bitmaps[i, y1:y2, x1:x2] = rng.rand(y2 - y1, x2 - x1) > 0.3
    crops = mask_paste.normalize_gt_masks(bitmaps, boxes, size=S)
    np.testing.assert_array_equal(crops, jax_paste.normalize_gt_masks(bitmaps, boxes, size=S))
    probs = rng.rand(3, 28, 28).astype(np.float32)
    pasted = mask_paste.paste_masks(probs, boxes, img_h, img_w)
    np.testing.assert_array_equal(pasted, jax_paste.paste_masks(probs, boxes, img_h, img_w))
    assert pasted.shape == (3, img_h, img_w) and pasted.any()


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

def _soft_masks(seed=6):
    """Smooth random crops in [0, 1] (bilinear upsampling of 8x8 noise)."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.rand(B * G, 1, 8, 8).astype(np.float32))
    up = torch.nn.functional.interpolate(coarse, size=(S, S), mode="bilinear",
                                         align_corners=False)
    return up.reshape(B, G, S, S).numpy()


def _batches(seed=0):
    jb = jax_demo_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G, seed=seed)
    tb = ttesting.demo_det_batch(B, *HW, num_instances=(2, 3), num_classes=4, gt_capacity=G,
                                 seed=seed)
    imgs = images((B,) + HW, seed=seed)
    masks = _soft_masks()
    jb = jb.replace(images=jax_normalize(jnp.asarray(imgs)),
                    gt=jb.gt.replace(masks=jnp.asarray(masks)))
    tb = tb.replace(images=normalize_images(torch.from_numpy(imgs)),
                    gt=tb.gt.replace(masks=torch.from_numpy(masks)))
    return jb, tb


@pytest.mark.parametrize("config_file,kind", [("mask-rcnn_r50_fpn.py", "MaskRCNN"),
                                              ("cascade-mask-rcnn_r50_fpn.py", "CascadeMaskRCNN")])
def test_mask_family_matches_jax(config_file, kind):
    model, variables, port, cfg = zoo_jax_and_port(config_file, image_hw=HW)
    jb, tb = _batches()
    rng = jax.random.PRNGKey(7)
    run = family_loss_runs(model, variables, port, jb, tb, rng,
                           zoo_priorities(kind, rng, cfg, B, HW, G))
    got, ref = run["losses"], run["jax_losses"]
    assert set(got) == set(ref) and "loss_mask" in got
    for k in ref:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)

    # the mask head's four convs and its upsample see ~12.8M ReLU inputs
    # per loss here (He-init weights: many near zero); a handful flip
    flips = run["flips"]
    assert n_flips(flips) <= 16, flips
    frozen = ("backbone.conv1", "backbone.bn1", "backbone.layer1.")
    assert any(np.abs(run["grads"][k]).max() > 0 for k in run["grads"]
               if k.startswith("roi_head.mask_head."))
    for k, r in run["jax_grads"].items():
        scale = np.abs(r).max()
        g = run["grads"][k]
        assert (np.abs(g).max() > 0) == (scale > 0) and not (k.startswith(frozen) and scale > 0), k
        err = np.abs(g - r).max()
        assert err <= (GRAD_REL + flip_slack(flips, k)) * max(scale, 1e-6), (k, err, scale, flips)

    jd = jax.jit(lambda v, b: model.apply(v, b, method=model.predict))(variables, jb)
    with torch.no_grad():
        td = port.predict(tb)
    v = np.asarray(jd.valid)
    assert v.any()
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_array_equal(td.labels.numpy()[v], np.asarray(jd.labels)[v])
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-5)
    assert tuple(td.masks.shape) == (B, cfg.max_per_img, 28, 28)
    np.testing.assert_allclose(td.masks.numpy()[v], np.asarray(jd.masks)[v], atol=1e-4)


def test_bridge_round_trip_of_the_mask_families():
    """state_dict_from_jax and jax_flat_from_state_dict are inverses on the
    cascade's stage heads and the mask head (the upsample flipped twice)."""
    model, variables, port, _ = zoo_jax_and_port("cascade-mask-rcnn_r50_fpn.py", image_hw=HW)
    params, stats = jax_flat_from_state_dict(port.state_dict())
    ref = _flatten_tree(variables["params"])
    assert params.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(params[k], np.asarray(ref[k]), err_msg=k)
    names = set(port.state_dict())
    assert {"roi_head.bbox_head.2.fc_reg.0.weight", "roi_head.bbox_head.0.fc_cls.1.weight",
            "roi_head.mask_head.convs.3.conv.weight", "roi_head.mask_head.upsample.weight",
            "roi_head.mask_head.conv_logits.weight"} <= names
    assert len(stats) == len(_flatten_tree(variables["batch_stats"]))
