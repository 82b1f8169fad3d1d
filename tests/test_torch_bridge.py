"""The weight bridge, the port's isolation from JAX, device selection,
config mapping and the inference API."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.apis.inference import _pack_images as jax_pack_images
from nsgp_repre_tpu.engine.runner import detector_config_from_cfg as jax_cfg_map
from nsgp_repre_tpu.models.detector import DetectorConfig, FasterRCNN
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree, save_pytree
from nsgp_repre_tpu.utils.config import load_config as jax_load_config
from nsgp_repre_tpu.utils.torch_convert import convert_detector_state_dict

from nsgp_repre_tpu_torch.apis import inference as api
from nsgp_repre_tpu_torch.engine.runner import detector_config_from_cfg
from nsgp_repre_tpu_torch.engine.train import TrainState, make_train_step
from nsgp_repre_tpu_torch.models import detector as tdet
from nsgp_repre_tpu_torch.utils.config import load_config
from nsgp_repre_tpu_torch.utils.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
CFG = str(REPO / "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_1.py")
CONFIGS = [
    CFG,
    str(REPO / "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_2.py"),
    str(REPO / "cl_faster_rcnn_cfgs/mini_voc/mini_voc_anchor_task1.py"),
]


def _random_flat(cfg: DetectorConfig, seed=0):
    """Flat params/stats of a JAX detector with the shapes of ``cfg``,
    filled with seeded numbers (shapes only: no init is traced)."""
    model = FasterRCNN(config=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(seed)
    fill = lambda t: jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), t)
    return _flatten_tree(fill(shapes["params"])), _flatten_tree(fill(shapes["batch_stats"]))


@pytest.mark.parametrize("blocks,split", [((3, 4, 6, 3), (0, 15, 20)), ((1, 1, 1, 1), (0, 10, 20))])
def test_state_dict_round_trip(blocks, split):
    """convert_detector_state_dict(state_dict_from_jax(flat)) == flat."""
    params, stats = _random_flat(DetectorConfig(backbone_blocks=blocks, task_split=split))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, stats).items()}
    p2, s2 = convert_detector_state_dict(sd)
    assert p2.keys() == params.keys() and s2.keys() == stats.keys()
    for a, b in ((p2, params), (s2, stats)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the names are the port's own: the bridged dict loads strictly
    port = tdet.FasterRCNN(tdet.DetectorConfig(backbone_blocks=blocks, task_split=split))
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'nsgp_repre_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, nsgp_repre_tpu_torch\n"
        "for m in pkgutil.walk_packages(nsgp_repre_tpu_torch.__path__, 'nsgp_repre_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import nsgp_repre_tpu_torch.apis.inference\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_source_scan_no_jax_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|nsgp_repre_tpu)\b", re.M)
    files = sorted((REPO / "nsgp_repre_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_init_detector_device():
    """No device named: cuda, or an error where there is none; never a
    quiet CPU run. device='cpu' works."""
    cfg = load_config(CFG)
    cfg["model"]["backbone"] = dict(stage_blocks=(1, 1, 1, 1))
    if torch.cuda.is_available():
        assert api.init_detector(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.init_detector(cfg)
    det = api.init_detector(cfg, device="cpu")
    assert det.device.type == "cpu" and det.model.config.compute_dtype == "bfloat16"
    assert next(det.model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("path", CONFIGS)
def test_config_mapping_matches_jax(path):
    assert load_config(path) == jax_load_config(path)
    port = dataclasses.asdict(detector_config_from_cfg(load_config(path)))
    ref = dataclasses.asdict(jax_cfg_map(jax_load_config(path)))
    assert port == ref


def test_init_detector_loads_jax_npz_and_pth(tmp_path):
    cfg = load_config(CFG)
    cfg["model"]["backbone"] = dict(stage_blocks=(1, 1, 1, 1))
    jcfg = dataclasses.replace(jax_cfg_map(jax_load_config(CFG)), backbone_blocks=(1, 1, 1, 1))
    params, stats = _random_flat(jcfg, seed=3)
    npz = str(tmp_path / "ckpt.npz")
    save_pytree(npz, {"params": params, "batch_stats": stats})
    want = state_dict_from_jax(params, stats)
    det = api.init_detector(cfg, checkpoint=npz, device="cpu")
    got = det.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # a reference-style .pth (mmdet names, plus counters the port lacks)
    pth = str(tmp_path / "ckpt.pth")
    ref_sd = dict(want, **{"backbone.bn1.num_batches_tracked": torch.tensor(0)})
    torch.save({"state_dict": ref_sd}, pth)
    got = api.init_detector(cfg, checkpoint=pth, device="cpu").model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_unported_options_raise():
    port = tdet.FasterRCNN(tdet.DetectorConfig(backbone_blocks=(1, 1, 1, 1)))
    # the task-2 terms of the train step (slice (c))
    opt = torch.optim.SGD(port.parameters(), lr=0.1)
    step = make_train_step(port, opt)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        step(TrainState(opt, replay_feats=torch.zeros(1, 4)), None)
    for kw in (dict(rpn_nms_impl="matrix"), dict(nms_type="soft_nms")):
        cfg = tdet.DetectorConfig(backbone_blocks=(1, 1, 1, 1), max_per_img=4,
                                  rpn_max_per_img=8, rpn_nms_pre=16, **kw)
        m = tdet.FasterRCNN(cfg).eval()
        batch = api._pack_images(api.Detector(m, (96, 64), "cpu"),
                                 [np.zeros((64, 96, 3), np.uint8)])
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            m.predict(batch.replace(images=batch.images.float()))


def test_pack_images_and_inference_api():
    """Canvas, shapes and scale factors as the JAX _pack_images makes them
    (square canvas when an image is portrait); detections in original
    image coordinates."""
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (60, 90, 3), np.uint8), rng.randint(0, 255, (90, 50, 3), np.uint8)]

    class _Det:
        img_scale = (128, 80)

    for group in (imgs[:1], imgs):
        ref = jax_pack_images(_Det(), group)
        got = api._pack_images(api.Detector(None, (128, 80), "cpu"), group)
        for name in ("images", "img_shape", "ori_shape", "scale_factor"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    cfg = load_config(CFG)
    cfg["model"]["backbone"] = dict(stage_blocks=(1, 1, 1, 1))
    det = api.init_detector(cfg, device="cpu", img_scale=(128, 80))
    out = api.inference_detector(det, imgs)
    assert len(out) == 2
    for o, img in zip(out, imgs):
        assert o["boxes"].shape[1] == 4 and len(o["boxes"]) == len(o["scores"]) == len(o["labels"])
        assert (o["boxes"][:, 2] <= img.shape[1] + 1e-3).all()
        assert (o["boxes"][:, 3] <= img.shape[0] + 1e-3).all()
        assert (o["labels"] < 15).all()
    single = api.inference_detector(det, imgs[0])
    assert isinstance(single, dict)
