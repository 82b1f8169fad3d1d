"""The rest of the port's API against the JAX package: soft-NMS and the
matrix NMS (keep lists and scores; both as predict options of the
detector), ``DetInferencer`` with its saved visualization, the benchmark
utilities, and the native against the numpy VOC and COCO mAP.

Inputs are seeded numpy arrays; both sides see the same numbers in f32 on
the CPU. JAX runs its XLA paths. The detector cases use
tests/torch_port_util.py's SMALL detector and, for the inferencer, the
15+5 task-1 config cut to one bottleneck per stage at a 256x160 scale,
with one perturbed weight file loaded by both packages.

Tolerances: keep lists, labels and valid slots equal; soft-NMS scores to
1e-6; detection boxes to 1e-3 px and scores to 1e-5; drawn images and
mAP values exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.apis.inference import DetInferencer as JaxInferencer
from nsgp_repre_tpu.evaluation.coco_map import eval_coco_map as jax_coco_map
from nsgp_repre_tpu.evaluation.voc_map import eval_voc_map as jax_voc_map
from nsgp_repre_tpu.ops.nms import batched_nms_matrix as jax_batched_nms_matrix
from nsgp_repre_tpu.ops.nms import batched_soft_nms as jax_batched_soft_nms
from nsgp_repre_tpu.utils.config import load_config as jax_load_config
from nsgp_repre_tpu.visualization import draw_detections as jax_draw

from nsgp_repre_tpu_torch.apis.inference import DetInferencer, inference_detector
from nsgp_repre_tpu_torch.datasets.loader import load_image
from nsgp_repre_tpu_torch.evaluation import eval_coco_map, eval_voc_map
from nsgp_repre_tpu_torch.evaluation import coco_map, native, voc_map
from nsgp_repre_tpu_torch.ops import nms, nms_cuda
from nsgp_repre_tpu_torch.utils.benchmark import (DataLoaderBenchmark, DatasetBenchmark,
                                                  InferenceBenchmark)
from nsgp_repre_tpu_torch.utils.checkpoint import model_flat, save_flat
from nsgp_repre_tpu_torch.utils.config import load_config
from torch_port_util import (batches, f32_matmuls, images, jax_and_port, perturb)

CFG = "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_1.py"
DEMO = "demo/demo.jpg"


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
# soft-NMS and the matrix NMS
# ---------------------------------------------------------------------------

def _candidates(seed, B=2, n=300, classes=5):
    """Clustered seeded boxes (many overlaps), scores with ties, labels."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 200, (B, 12, 2))
    pick = rng.randint(0, 12, (B, n))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.randn(B, n, 2) * 6
    wh = rng.uniform(10, 50, (B, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = np.round(rng.rand(B, n), 2).astype(np.float32)  # ties
    labels = rng.randint(0, classes, (B, n)).astype(np.int32)
    valid = rng.rand(B, n) > 0.1
    return boxes, scores, labels, valid


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_matches_jax(method):
    boxes, scores, labels, valid = _candidates(1)
    ref = jax.vmap(lambda b, s, l, v: jax_batched_soft_nms(
        b, s, l, v, 0.3, 60, sigma=0.5, min_score=0.05, method=method))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid))
    got = nms.batched_soft_nms(_t(boxes), _t(scores), _t(labels), _t(valid), 0.3, 60, sigma=0.5,
                               min_score=0.05, method=method)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    v = np.asarray(ref[1])
    assert v.sum(1).min() > 10
    np.testing.assert_array_equal(got[0].numpy()[v], np.asarray(ref[0])[v])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-6)
    # decayed scores come out in pick order, not above the input's
    assert (got[2].numpy()[v] <= scores.max() + 1e-6).all()


@pytest.mark.parametrize("tile", [64, 512])
def test_matrix_nms_matches_jax_and_the_greedy_walk(tile):
    """JAX's block fixed point (one tile, and five tiles of 64) gives the
    keep lists of the port's matrix NMS, the NMS kernel's wrapper with the
    batch-wide offset, which are the greedy walk's."""
    boxes, scores, labels, valid = _candidates(2)
    ref = jax_batched_nms_matrix(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                                     jnp.asarray(valid), 0.5, 100, tile=tile)
    got = nms_cuda.batched_nms_matrix(_t(boxes), _t(scores), _t(labels), _t(valid), 0.5, 100,
                                      tile=tile)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    # the greedy walk on the same (batch-wide) offset boxes
    shifted = _t(boxes) + (_t(labels).float() * (
        torch.where(_t(valid)[..., None], _t(boxes), torch.zeros(())).max() + 1))[..., None]
    gi, gv = nms.nms(shifted, _t(scores), _t(valid), 0.5, 100)
    np.testing.assert_array_equal(got[1].numpy(), gv.numpy())
    np.testing.assert_array_equal(got[0].numpy(), gi.numpy())


def test_detector_predict_options_match_jax():
    """predict with nms_type='soft_nms' and rpn_nms_impl='matrix' (the two
    options that raised before) against JAX with the same options."""
    opts = dict(nms_type="soft_nms", rpn_nms_impl="matrix", soft_nms_min_score=0.05)
    model, variables, port = jax_and_port((64, 96), seed=0, jit_init=True, **opts)
    jb, tb = batches(images((2, 64, 96), seed=3))
    from nsgp_repre_tpu.engine.train import normalize_images as jax_normalize

    from nsgp_repre_tpu_torch.engine.train import normalize_images

    jd = jax.jit(lambda v, b: model.apply(v, b, method=model.predict))(
        variables, jb.replace(images=jax_normalize(jb.images)))
    with torch.no_grad():
        td = port.predict(tb.replace(images=normalize_images(tb.images)))
    v = np.asarray(jd.valid)
    assert v.sum() > 4
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_array_equal(td.labels.numpy()[v], np.asarray(jd.labels)[v])
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-5)


# ---------------------------------------------------------------------------
# DetInferencer and the visualization
# ---------------------------------------------------------------------------

def _small_cfg(load):
    cfg = load(CFG)
    cfg["compute_dtype"] = "float32"
    cfg["img_scale"] = (256, 160)
    cfg["model"]["backbone"]["stage_blocks"] = (1, 1, 1, 1)
    return cfg


def test_det_inferencer_matches_inference_detector_and_jax(tmp_path):
    """DetInferencer's predictions are inference_detector's on the same
    detector, and JAX's DetInferencer's on the same weight file; its
    saved image is the JAX visualizer's drawing of those detections."""
    cfg = _small_cfg(load_config)
    inf = DetInferencer(cfg, pred_score_thr=0.05, device="cpu")
    params, stats = {}, {}
    for k, v in model_flat(inf.detector.model.state_dict()).items():
        (params if k.startswith("params/") else stats)[k.split("/", 1)[1]] = v
    params, stats = perturb(params, stats, seed=2, cls_scale=20.0)
    path = str(tmp_path / "weights.npz")
    save_flat(path, {**{f"params/{k}": v for k, v in params.items()},
                     **{f"batch_stats/{k}": v for k, v in stats.items()}})
    inf = DetInferencer(cfg, weights=path, pred_score_thr=0.05, device="cpu")
    out_dir = str(tmp_path / "vis")
    res = inf(DEMO, out_dir=out_dir, return_vis=True)
    pred = res["predictions"][0]
    assert len(pred["boxes"]) > 0
    direct = inference_detector(inf.detector, [DEMO], score_thr=0.05)[0]
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(pred[k], direct[k])

    ref = JaxInferencer(_small_cfg(jax_load_config), weights=path, pred_score_thr=0.05)
    jres = ref(DEMO, out_dir=str(tmp_path / "jax_vis"))
    jpred = jres["predictions"][0]
    np.testing.assert_array_equal(pred["labels"], jpred["labels"])
    np.testing.assert_allclose(pred["boxes"], jpred["boxes"], atol=1e-3)
    np.testing.assert_allclose(pred["scores"], jpred["scores"], atol=1e-5)

    img = load_image(DEMO)
    assert os.listdir(out_dir) == ["demo.jpg"]
    np.testing.assert_array_equal(res["visualization"][0], jax_draw(img, pred))
    assert (res["visualization"][0] != img).any()


def test_torch_image_demo_writes_its_drawing(tmp_path, capsys):
    """demo/torch_image_demo.py: one line per detection, the drawing
    written under --out-dir."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_image_demo", "demo/torch_image_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(f"_base_ = ['{os.path.abspath(CFG)}']\n"
                        "compute_dtype = 'float32'\nimg_scale = (256, 160)\n"
                        "model = dict(backbone=dict(stage_blocks=(1, 1, 1, 1)))\n")
    res = demo.main([DEMO, str(cfg_path), "--out-dir", str(tmp_path / "out"),
                     "--pred-score-thr", "0.0", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("label=")]
    assert len(lines) == len(res["predictions"][0]["boxes"]) > 0
    assert os.listdir(tmp_path / "out") == ["demo.jpg"]


# ---------------------------------------------------------------------------
# the benchmark utilities
# ---------------------------------------------------------------------------

def test_benchmark_utilities():
    cfg = _small_cfg(load_config)
    inf = DetInferencer(cfg, device="cpu")
    from nsgp_repre_tpu_torch.apis.inference import _pack_images

    batch = _pack_images(inf.detector, [load_image(DEMO)] * 2)
    r = InferenceBenchmark(inf.detector, max_iter=2, num_warmup=1).run(batch)
    assert r["fps"] > 0 and r["times_per_img_ms"] > 0
    loader = [(None, [0, 1]), (None, [2, 3]), (None, [4])]
    r = DataLoaderBenchmark(loader, max_iter=2).run()
    assert r["batches_per_sec"] > 0 and r["imgs_per_sec"] == pytest.approx(
        2 * r["batches_per_sec"], rel=1e-2)

    class Items:
        seen = []

        def __len__(self):
            return 9

        def __getitem__(self, i):
            self.seen.append(i)
            return i

    items = Items()
    r = DatasetBenchmark(items, max_iter=4, num_warmup=2, seed=0).run()
    idx = np.arange(9)
    np.random.RandomState(0).shuffle(idx)
    assert items.seen == idx[:6].tolist() and r["items_per_sec"] > 0


# ---------------------------------------------------------------------------
# native against numpy mAP
# ---------------------------------------------------------------------------

def _eval_inputs(seed, n_img=6, classes=4):
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(n_img):
        g = rng.randint(1, 6)
        xy = rng.uniform(0, 200, (g, 2))
        gt = np.concatenate([xy, xy + rng.uniform(4, 120, (g, 2))], 1).astype(np.float32)
        lab = rng.randint(0, classes, g)
        ann = dict(boxes=gt, labels=lab, difficult=(rng.rand(g) > 0.8).astype(np.int32),
                   iscrowd=(rng.rand(g) > 0.85).astype(np.int32))
        if rng.rand() > 0.5:
            ann["ignore_boxes"] = gt[:1] + 3
        anns.append(ann)
        per = {}
        for c in range(classes):
            k = rng.randint(0, 8)
            base = gt[rng.randint(0, g, k)] + rng.randn(k, 4).astype(np.float32) * 6
            per[c] = (base.astype(np.float32), np.round(rng.rand(k), 2).astype(np.float32))
        dets.append(per)
    return dets, anns


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_map_equals_numpy_map(seed, monkeypatch):
    """The evaluators (native matching) against themselves with the numpy
    reference matchers swapped in, and against JAX's: exact."""
    dets, anns = _eval_inputs(seed)
    voc = [eval_voc_map(dets, anns, 4, mode=mode) for mode in ("11points", "area")]
    got = eval_coco_map(dets, anns, 4)
    monkeypatch.setattr(voc_map, "voc_tpfp", voc_map._tpfp_numpy)
    monkeypatch.setattr(coco_map, "coco_match", coco_map._match_numpy)
    for mode, g in zip(("11points", "area"), voc):
        ref = eval_voc_map(dets, anns, 4, mode=mode)
        assert g[0] == ref[0] and g[1] == ref[1]
        assert g[0] == jax_voc_map(dets, anns, 4, mode=mode)[0]
    ref = eval_coco_map(dets, anns, 4)
    jref = jax_coco_map(dets, anns, 4)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got[k], jref[k], err_msg=k)
    assert 0 < got["mAP_50"] <= 1


def test_native_library_builds_in_the_checkout():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.endswith(".so")
    tp, fp = native.voc_tpfp(np.zeros((0, 4)), np.zeros((0, 4)), np.zeros(0), 0.5)
    assert tp.shape == fp.shape == (0,)
