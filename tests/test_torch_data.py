"""The port's data, evaluation and file modules against the JAX package.

All exact: the same dataset records (VOC, DIOR, COCO) and loader batches
(ids, flips, pixels, boxes, shapes, scale factors, in both aspect
buckets, training and not, with ``force_flip``, ``repeat`` and a partial
last batch), the same VOC (11-point and area) and COCO mAP on seeded
detections, the same bytes through each package's checkpoint and
artifact writers and readers, and the same tensors from a
torchvision-layout ResNet-50 or a reference detector ``.pth``.
"""
import json
import os

import numpy as np
import pytest
import torch

from nsgp_repre_tpu.datasets.coco import CocoTaskDataset as JaxCoco
from nsgp_repre_tpu.datasets.dior import DIORTaskDataset as JaxDior
from nsgp_repre_tpu.datasets.loader import DetLoader as JaxLoader
from nsgp_repre_tpu.datasets.loader import load_image as jax_load_image
from nsgp_repre_tpu.datasets.voc import VOCTaskDataset as JaxVoc
from nsgp_repre_tpu.evaluation import eval_coco_map as jax_coco_map
from nsgp_repre_tpu.evaluation import eval_voc_map as jax_voc_map
from nsgp_repre_tpu.utils import checkpoint as jax_ckpt
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree, restore_into
from nsgp_repre_tpu.utils.torch_convert import load_torch_detector, load_torch_resnet50

from nsgp_repre_tpu_torch.datasets.coco import COCO_CLASSES, CocoTaskDataset
from nsgp_repre_tpu_torch.datasets.dior import DIOR_CLASSES, DIORTaskDataset
from nsgp_repre_tpu_torch.datasets.loader import DetLoader, load_image
from nsgp_repre_tpu_torch.datasets.prefetch import PrefetchLoader, to_device
from nsgp_repre_tpu_torch.datasets.voc import VOCTaskDataset
from nsgp_repre_tpu_torch.evaluation import eval_coco_map, eval_voc_map
from nsgp_repre_tpu_torch.models.detector import DetectorConfig, FasterRCNN
from nsgp_repre_tpu_torch.utils import checkpoint as ckpt_io
from nsgp_repre_tpu_torch.utils.convert import jax_flat_from_state_dict, state_dict_from_jax
from torch_port_util import SMALL, jax_and_port
from voc_fixture import write_voc

# (h, w) of the dataset's images: landscape and portrait, two resized
# by (100, 60) and the rest kept as they are; 7 of 8 keep an in-task box
SHAPES = [(60, 80), (80, 60), (60, 100), (90, 50), (50, 90), (60, 80), (80, 60), (60, 80)]


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    rng = np.random.RandomState(3)
    images, objects = [], []
    for i, (h, w) in enumerate(SHAPES):
        images.append(rng.randint(0, 255, (h, w, 3), np.uint8))
        objs = [(i % 4, 4, 5, w // 2, h // 2), (2 + i % 2, 10, 8, w - 3, h - 4, i % 3 == 0),
                (5 + i % 3, 2, 2, 30, 30)]
        if i == 7:
            objs = [(3, 2, 2, 5, 5)]  # a task-2 box under bbox_min_size only
        objects.append(objs)
    return write_voc(tmp_path_factory.mktemp("VOCdevkit"), images, objects)


def _records_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]), k
            else:
                assert g[k] == r[k], k


@pytest.mark.parametrize("task_id,test_mode", [(1, False), (2, False), (1, True)])
def test_voc_records_match_jax(voc_root, task_id, test_mode):
    kw = dict(data_root=voc_root, ann_file="VOC2007/ImageSets/Main/trainval.txt",
              task_split=[0, 2, 20], task_id=task_id, test_mode=test_mode)
    got, ref = VOCTaskDataset(**kw), JaxVoc(**kw)
    assert 0 < len(ref) <= 8
    _records_equal(got.records, ref.records)


def test_dior_records_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    images = [rng.randint(0, 255, (40, 50, 3), np.uint8) for _ in range(4)]
    objects = [[(i * 5, 3, 3, 30, 30), (19, 5, 6, 40, 35)] for i in range(4)]
    root = write_voc(tmp_path, images, objects, classes=DIOR_CLASSES)
    for task_id in (1, 2):
        kw = dict(data_root=root, ann_file="VOC2007/ImageSets/Main/trainval.txt",
                  sub_data_root="VOC2007/", task_split=[0, 10, 20], task_id=task_id)
        got, ref = DIORTaskDataset(**kw), JaxDior(**kw)
        assert len(ref) == 2 * task_id
        _records_equal(got.records, ref.records)


def test_coco_records_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    cats = [dict(id=10 + 3 * i, name=n) for i, n in enumerate(COCO_CLASSES)]
    images, anns = [], []
    for i in range(6):
        w, h = (640, 480) if i % 2 else (30, 400)  # image 0 too small to train
        images.append(dict(id=100 + i, file_name=f"{i:012d}.jpg", width=w, height=h))
        for j in range(4):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            bw, bh = (0.5, 10) if j == 3 else rng.uniform(1, w / 2, 2)
            anns.append(dict(id=len(anns) + 1, image_id=100 + i, category_id=cats[(i + 37 * j) % 80]["id"],
                             bbox=[x, y, bw, bh], area=float(bw * bh), iscrowd=int(j == 2)))
    (tmp_path / "ann.json").write_text(json.dumps(dict(images=images, annotations=anns,
                                                       categories=cats)))
    for task_id, test_mode in ((1, False), (2, False), (2, True)):
        kw = dict(data_root=str(tmp_path), ann_file="ann.json", img_prefix="train2017",
                  task_split=[0, 40, 80], task_id=task_id, test_mode=test_mode)
        got, ref = CocoTaskDataset(**kw), JaxCoco(**kw)
        assert got.cat_id2label == ref.cat_id2label
        _records_equal(got.records, ref.records)


def test_load_image_matches_jax(voc_root):
    """The fixture's PPM images decode to the pixels written, as in JAX."""
    path = os.path.join(voc_root, "VOC2007", "JPEGImages", "000003.ppm")
    got = load_image(path)
    raw = open(path, "rb").read()
    assert got.dtype == np.uint8 and got.shape == (90, 50, 3)
    assert np.array_equal(got.reshape(-1), np.frombuffer(raw[-got.size:], np.uint8))
    assert np.array_equal(got, jax_load_image(path))


def _batch_equal(got, ref):
    (gb, gm), (rb, rm) = got, ref
    assert list(gm) == list(rm) and gm.flips == rm.flips
    for name in ("images", "img_shape", "ori_shape", "scale_factor"):
        g, r = getattr(gb, name), np.asarray(getattr(rb, name))
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().dtype == r.dtype and np.array_equal(g.numpy(), r), name
    for name in ("boxes", "labels", "valid"):
        g, r = getattr(gb.gt, name).numpy(), np.asarray(getattr(rb.gt, name))
        assert g.dtype == r.dtype and np.array_equal(g, r), name


@pytest.mark.parametrize("training,force_flip,repeat,batch_size", [
    (True, None, 1, 2), (True, None, 3, 3), (False, None, 1, 3), (False, True, 1, 2),
    (False, False, 2, 4)])
def test_loader_matches_jax(voc_root, training, force_flip, repeat, batch_size):
    """Both buckets, the partial last batch (not training), the flips and
    the shuffle of two epochs."""
    ds = dict(data_root=voc_root, ann_file="VOC2007/ImageSets/Main/trainval.txt",
              task_split=[0, 4, 20], task_id=1)
    kw = dict(batch_size=batch_size, scale=(100, 60), training=training, gt_capacity=4,
              repeat=repeat, seed=5, force_flip=force_flip)
    got, ref = DetLoader(VOCTaskDataset(**ds), **kw), JaxLoader(JaxVoc(**ds), **kw)
    assert len(got) == len(ref)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        ref.set_epoch(epoch)
        g, r = list(got), list(ref)
        assert len(g) == len(r) > 0
        assert {b.images.shape[1:3] for b, _ in g} == {(64, 128), (128, 64)}
        for a, b in zip(g, r):
            _batch_equal(a, b)


def test_prefetch_loader_yields_the_loader_batches(voc_root):
    ds = VOCTaskDataset(data_root=voc_root, ann_file="VOC2007/ImageSets/Main/trainval.txt",
                        task_split=[0, 4, 20], task_id=1)
    loader = DetLoader(ds, batch_size=2, scale=(100, 60), training=True, seed=1)
    pre = PrefetchLoader(loader, transfer_fn=lambda b: to_device(b, torch.device("cpu")))
    pre.set_epoch(1)
    got = list(pre)
    assert len(got) == len(pre) == len(list(loader))
    for (gb, gm), (rb, rm) in zip(got, loader):
        assert list(gm) == list(rm) and torch.equal(gb.images, rb.images)
    for _ in zip(range(1), pre):  # an early stop releases the worker
        pass


def _dets_and_anns(seed, n_img=12, nc=5):
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(n_img):
        g = rng.randint(0, 6)
        xy = rng.uniform(0, 200, (g, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 120, (g, 2))], 1).astype(np.float32)
        labels = rng.randint(0, nc, g).astype(np.int32)
        anns.append(dict(boxes=boxes, labels=labels, difficult=(rng.rand(g) < 0.2).astype(np.int32),
                         iscrowd=(rng.rand(g) < 0.1).astype(np.int32)))
        per = {}
        for c in range(nc):
            d = rng.randint(0, 5)
            src = boxes[labels == c]
            if len(src) and d:
                b = src[rng.randint(0, len(src), d)] + rng.randn(d, 4).astype(np.float32) * 6
            else:
                xy = rng.uniform(0, 200, (d, 2))
                b = np.concatenate([xy, xy + 30], 1).astype(np.float32)
            per[c] = (b, rng.rand(d).astype(np.float32))
        dets.append(per)
    return dets, anns


@pytest.mark.parametrize("mode", ["11points", "area"])
def test_voc_map_matches_jax(mode):
    dets, anns = _dets_and_anns(0)
    got, got_cls = eval_voc_map(dets, anns, 5, mode=mode)
    ref, ref_cls = jax_voc_map(dets, anns, 5, mode=mode)
    assert 0 < ref < 1 and got == ref
    assert str(got_cls) == str(ref_cls)


def test_coco_map_matches_jax():
    dets, anns = _dets_and_anns(1)
    got, ref = eval_coco_map(dets, anns, 5), jax_coco_map(dets, anns, 5)
    assert got.keys() == ref.keys() and 0 < ref["mAP"] < 1
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def small():
    return jax_and_port(jit_init=True)


def test_checkpoint_round_trip_jax_port_jax(small, tmp_path):
    """A JAX checkpoint loads into the port bit for bit; the port writes
    exactly the keys, shapes, dtypes and values JAX wrote."""
    _, variables, port = small
    jax_path = str(tmp_path / "jax.npz")
    jax_ckpt.save_pytree(jax_path, variables)
    fresh = FasterRCNN(DetectorConfig(**SMALL))
    assert ckpt_io.load_checkpoint(fresh, jax_path, strict=True) == []
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    port_path = str(tmp_path / "port.npz")
    ckpt_io.save_flat(port_path, ckpt_io.model_flat(fresh.state_dict()))
    ref, got = jax_ckpt.load_pytree_flat(jax_path), jax_ckpt.load_pytree_flat(port_path)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    back = {"params": restore_into(variables["params"],
                                   {k[7:]: v for k, v in got.items() if k.startswith("params/")}),
            "batch_stats": restore_into(variables["batch_stats"],
                                        {k[12:]: v for k, v in got.items()
                                         if k.startswith("batch_stats/")})}
    flat_back, flat_ref = _flatten_tree(back), _flatten_tree(variables)
    assert all(np.array_equal(flat_back[k], flat_ref[k]) for k in flat_ref)
    # a shape mismatch raises; a missing entry only under strict
    bad = dict(ref)
    bad["params/backbone/conv1/kernel"] = np.zeros((7, 7, 3, 32), np.float32)
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="shape"):
        ckpt_io.load_checkpoint(fresh, str(tmp_path / "bad.npz"))
    del bad["params/backbone/conv1/kernel"]
    np.savez(tmp_path / "part.npz", **bad)
    assert ckpt_io.load_checkpoint(fresh, str(tmp_path / "part.npz")) == ["backbone.conv1.weight"]
    with pytest.raises(KeyError, match="missing"):
        ckpt_io.load_checkpoint(fresh, str(tmp_path / "part.npz"), strict=True)


def test_artifact_files_round_trip(tmp_path):
    """covariance.npz, rois_etc.npz, ewc_reg_terms_ewc.npz and mask.pkl:
    JAX writes, the port reads and writes, JAX reads the same arrays; EWC
    terms come out keyed by the port's names."""
    rng = np.random.RandomState(0)
    cov = {"backbone/layer2_0/conv1/kernel": rng.rand(6, 6).astype(np.float32),
           "neck/lateral_conv0/kernel": rng.rand(4, 4).astype(np.float32)}
    rois = [rng.rand(5, 12).astype(np.float32), rng.randint(0, 20, 5).astype(np.int32),
            np.ones(5, np.float32), rng.rand(5, 4).astype(np.float32),
            np.ones((5, 4), np.float32), rng.rand(5, 4).astype(np.float32)]
    ewc = {"backbone/bn1/scale": (rng.rand(2, 8).astype(np.float32), rng.rand(2, 8).astype(np.float32)),
           "backbone/layer1_0/downsample_bn/bias": (rng.rand(2, 3).astype(np.float32),
                                                    rng.rand(2, 3).astype(np.float32))}
    masks = [[rng.rand(7) < 0.5, rng.rand(7) < 0.5], []]
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    jax_ckpt.save_covariance(str(a), cov)
    jax_ckpt.save_rois_etc(str(a), rois)
    jax_ckpt.save_ewc_terms(str(a), ewc)
    jax_ckpt.save_masks(str(a), masks)
    terms = ckpt_io.load_ewc_terms(str(a), n_tasks=2)
    assert set(terms) == {"backbone.bn1.weight", "backbone.layer1.0.downsample.1.bias"}
    ckpt_io.save_covariance(str(b), {k: torch.from_numpy(v) for k, v in ckpt_io.load_covariance(str(a)).items()})
    ckpt_io.save_rois_etc(str(b), ckpt_io.load_rois_etc(str(a)))
    ckpt_io.save_ewc_terms(str(b), {k: (torch.from_numpy(i), p) for k, (i, p) in terms.items()}, 2)
    ckpt_io.save_masks(str(b), ckpt_io.load_masks(str(a)))
    for name in ("covariance.npz", "rois_etc.npz", "ewc_reg_terms_ewc.npz"):
        ref, got = jax_ckpt.load_pytree_flat(str(a / name)), jax_ckpt.load_pytree_flat(str(b / name))
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), (name, k)
    got_masks = jax_ckpt.load_masks(str(b))
    assert [len(c) for c in got_masks] == [2, 0]
    assert all(np.array_equal(g, r) for g, r in zip(got_masks[0], masks[0]))
    assert ckpt_io.load_masks(str(tmp_path)) is None


def _torchvision_resnet50(seed=0):
    """A torchvision-layout ResNet-50 state dict (random values): the
    port's full-depth backbone names without ``backbone.``, BN counters
    and the classifier."""
    g = torch.Generator().manual_seed(seed)
    model = FasterRCNN(DetectorConfig())
    sd = {}
    for k, v in model.backbone.state_dict().items():
        sd[k] = torch.randn(v.shape, generator=g) * 0.1 + (1.0 if k.endswith("running_var") else 0.0)
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 2048, generator=g), torch.zeros(1000)
    return sd


def test_torchvision_backbone_loads_in_both(tmp_path):
    sd = _torchvision_resnet50()
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    params, stats = load_torch_resnet50(path)  # the JAX package's reader
    ref = state_dict_from_jax(params, stats)
    for blocks in ((3, 4, 6, 3), (1, 1, 1, 1)):
        model = FasterRCNN(DetectorConfig(backbone_blocks=blocks))
        missing = ckpt_io.load_torch_backbone(model, path)
        assert not any(k.startswith("backbone.") for k in missing)
        got = model.state_dict()
        for k in got:
            if k.startswith("backbone."):
                assert torch.equal(got[k], ref[k]) and torch.equal(got[k], sd[k[9:]]), k
    sd["conv1.weight"] = torch.zeros(64, 3, 3, 3)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="backbone.conv1.weight"):
        ckpt_io.load_torch_backbone(model, path)


def test_reference_detector_pth_loads_in_both(small, tmp_path):
    """A reference mmdet detector ``.pth`` (the port's names are mmdet's)
    loads by name into the port, and to the same arrays through the JAX
    package's converter."""
    _, _, port = small
    path = str(tmp_path / "epoch_12.pth")
    torch.save({"meta": {"epoch": 12}, "state_dict": {
        **port.state_dict(), "teacher_model.backbone.conv1.weight": torch.zeros(1)}}, path)
    fresh = FasterRCNN(DetectorConfig(**SMALL))
    assert ckpt_io.load_checkpoint(fresh, path, strict=True) == []
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in port.state_dict().items())
    params, stats = load_torch_detector(path)
    got_p, got_s = jax_flat_from_state_dict(port.state_dict())
    assert params.keys() == got_p.keys() and stats.keys() == got_s.keys()
    assert all(np.array_equal(params[k], got_p[k]) for k in params)
    assert all(np.array_equal(stats[k], got_s[k]) for k in stats)
