"""Data parallel (parallel/mesh.py) against the JAX package's mesh, on the CPU.

Three parts, each rank a process of tests/torch_parallel_worker.py
(torch only, started with ``sys.executable``, a gloo group joined through
a file in ``tmp_path``, two threads each, a two-minute collective
timeout):

1. The shard plan: the port's ``DetLoader(num_shards=2, shard_id=r)``
   yields JAX's shards bit for bit (training: seeded shuffle and flips,
   two epochs; validation: the padded partial last batch, one shard
   empty), and the two shards side by side are the one-shard batch.
2. One task-1 step pair at the SMALL size, f32: JAX's make_train_step,
   make_cov_step and make_importance_step on ``create_mesh(2)`` with the
   batch sharded and the state replicated (conftest's virtual CPU
   devices), against two port ranks each given its image of the batch and
   its rows of JAX's draws. The batch's two images differ and make the
   ranks' sample counts differ (image 1 has one gt box and a small
   ``img_shape``, so fewer anchors and proposals are valid than the
   samplers take, rpn_num 512 and rcnn_num 128 here): normalizers
   taken per rank, or a sum of per-rank covariances, would fail. Loss
   terms within rtol 1e-4 and weights after each of 2 steps within 2e-4
   of the largest update plus 4 ulps, frozen ones bit-equal (the rule of
   test_torch_train.py::test_train_steps_match_jax); importance gradients
   within 2e-4 of their largest magnitude; covariances within 1e-5 of
   each matrix's largest entry.
3. The runner at world 1 and world 2 through tools/torch_train.py's
   ``main`` (task 1 at global batch 4 with its task-end files, then task
   2 with the teacher cache, projections, prototypes and EWC): the same
   files, rank 1 writing none, the RoI store's rows and the gathered
   validation detections in the same order.
   Two ranks sum the loss and average the gradients in another order than
   one process: values within 1e-4 of their largest magnitude, labels,
   masks and file sets exact.
"""
import json
import os
import os.path as osp
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsgp_repre_tpu.datasets.loader import DetLoader as JaxLoader
from nsgp_repre_tpu.datasets.voc import VOCTaskDataset as JaxVoc
from nsgp_repre_tpu.engine import nsgp as jax_nsgp
from nsgp_repre_tpu.engine import optim as jax_optim
from nsgp_repre_tpu.engine.runner import build_optimizer as jax_build_optimizer
from nsgp_repre_tpu.engine.train import TrainState as JaxTrainState
from nsgp_repre_tpu.engine.train import make_cov_step as jax_make_cov_step
from nsgp_repre_tpu.engine.train import make_importance_step as jax_make_importance_step
from nsgp_repre_tpu.engine.train import make_lr_schedule as jax_lr_schedule
from nsgp_repre_tpu.engine.train import make_train_step as jax_make_train_step
from nsgp_repre_tpu.engine.train import trainable_mask as jax_trainable_mask
from nsgp_repre_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from nsgp_repre_tpu.structures.sample import DetBatch as JaxBatch
from nsgp_repre_tpu.structures.sample import InstanceArray as JaxInstances
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree
from nsgp_repre_tpu.utils.config import load_config as jax_load_config

from nsgp_repre_tpu_torch.datasets.loader import DetLoader
from nsgp_repre_tpu_torch.datasets.voc import VOCTaskDataset
from nsgp_repre_tpu_torch.engine.train import normalize_images, trainable_mask
from nsgp_repre_tpu_torch.parallel import mesh
from nsgp_repre_tpu_torch.structures.sample import DetBatch, InstanceArray
from nsgp_repre_tpu_torch.utils import checkpoint as ckpt_io
from nsgp_repre_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_util import (SMALL, f32_matmuls, images, jax_and_port, loss_priorities,
                             spawn_worker, wait_workers)
from voc_fixture import make_cfg, make_voc, write_cfg, write_voc

CFG = "cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_1.py"
HW = (64, 96)
B = 2
G = 4
# samplers that take more than image 1 has valid (test_torch_train.py's are 64 and 32)
OVERRIDES = dict(rpn_num=512, rcnn_num=128)
LOSS_RTOL = 1e-4
GRAD_REL = 2e-4
COV_REL = 1e-5
RUNNER_REL = 1e-4


# ---------------------------------------------------------------------------
# 1. the shard plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_voc(tmp_path_factory):
    """11 images, 7 landscape and 4 portrait: both canvases, and partial
    batches in each."""
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 255, (60, 80, 3) if i % 3 else (80, 60, 3), np.uint8)
            for i in range(11)]
    objects = [[(i % 4, 5, 6, 40, 44), (1 + i % 3, 20, 10, 55, 50)] for i in range(11)]
    return write_voc(tmp_path_factory.mktemp("mixed_voc"), imgs, objects)


def _as_numpy(batch):
    out = {n: np.asarray(getattr(batch, n)) for n in ("images", "img_shape", "ori_shape",
                                                       "scale_factor")}
    out.update({n: np.asarray(getattr(batch.gt, n)) for n in ("boxes", "labels", "valid")})
    return out


@pytest.mark.parametrize("training", [True, False])
def test_shard_plan_matches_jax(mixed_voc, training):
    ds = dict(data_root=mixed_voc, ann_file="VOC2007/ImageSets/Main/trainval.txt",
              task_split=[0, 4, 20], task_id=1)
    kw = dict(batch_size=4 if training else 6, scale=(100, 60), training=training,
              gt_capacity=4, seed=7)
    whole = DetLoader(VOCTaskDataset(**ds), **kw)
    shards = [(DetLoader(VOCTaskDataset(**ds), num_shards=2, shard_id=r, **kw),
               JaxLoader(JaxVoc(**ds), num_shards=2, shard_id=r, **kw)) for r in (0, 1)]
    assert all(g.local_batch == kw["batch_size"] // 2 for g, _ in shards)
    empty_shards = 0
    for epoch in (0, 1):
        whole.set_epoch(epoch)
        for g, r in shards:
            g.set_epoch(epoch)
            r.set_epoch(epoch)
        runs = [(list(g), list(r)) for g, r in shards]
        one = list(whole)
        assert len(one) == len(runs[0][0]) == len(runs[1][0]) == len(runs[0][1]) > 1
        for i, (batch, meta) in enumerate(one):
            parts = []
            for got, ref in runs:
                (gb, gm), (rb, rm) = got[i], ref[i]
                assert list(gm) == list(rm) == list(meta) and gm.flips == rm.flips == meta.flips
                g, r = _as_numpy(gb), _as_numpy(rb)
                for k in r:
                    assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]), (i, k)
                assert len(g["images"]) == kw["batch_size"] // 2
                empty_shards += not g["img_shape"].any()
                parts.append(g)
            w = _as_numpy(batch)
            for k in w:
                assert np.array_equal(np.concatenate([p[k] for p in parts]), w[k]), (i, k)
    if training:
        assert any(any(m.flips) for _, m in one) and not all(all(m.flips) for _, m in one)
    else:
        assert empty_shards > 0  # the partial last batch left shard 1 only padding


# ---------------------------------------------------------------------------
# 2. steps against JAX's two-device mesh
# ---------------------------------------------------------------------------

def _both_batches():
    """Image 0 with three gt boxes on the whole canvas; image 1 with one
    box in a 12x16 ``img_shape``, where fewer anchors and proposals are
    valid than the samplers take (OVERRIDES), so the ranks sample
    different counts."""
    from nsgp_repre_tpu_torch.testing import demo_det_batch

    tb = demo_det_batch(B, *HW, num_instances=(3, 1), num_classes=4, gt_capacity=G, seed=3)
    z = dict(images=images((B,) + HW, seed=3), img_shape=tb.img_shape.numpy().copy(),
             scale_factor=np.ones((B, 2), np.float32), gt_boxes=tb.gt.boxes.numpy().copy(),
             gt_labels=tb.gt.labels.numpy().copy(), gt_valid=tb.gt.valid.numpy())
    z["img_shape"][1] = (12, 16)
    z["gt_boxes"][1, 0] = (2.0, 1.0, 14.0, 11.0)
    z["gt_labels"][1, 0] = 1
    jb = JaxBatch(images=jnp.asarray(z["images"]), img_shape=jnp.asarray(z["img_shape"]),
                  ori_shape=jnp.asarray(z["img_shape"]),
                  scale_factor=jnp.asarray(z["scale_factor"]),
                  gt=JaxInstances(boxes=jnp.asarray(z["gt_boxes"]),
                                  labels=jnp.asarray(z["gt_labels"]),
                                  valid=jnp.asarray(z["gt_valid"])))
    t = torch.from_numpy
    tb = DetBatch(images=t(z["images"]), img_shape=t(z["img_shape"]),
                  ori_shape=t(z["img_shape"]), scale_factor=t(z["scale_factor"]),
                  gt=InstanceArray(boxes=t(z["gt_boxes"]), labels=t(z["gt_labels"]),
                                   valid=t(z["gt_valid"])))
    return z, jb, tb


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The port's two ranks (started first, running while JAX compiles)
    and JAX on its two-device mesh, on the same weights, batch and draws."""
    tmp = tmp_path_factory.mktemp("dp_step")
    f32_matmuls()
    model, variables, port = jax_and_port(HW, seed=0, jit_init=True, **OVERRIDES)
    z, jb, tb = _both_batches()
    keys = {"imp": 7, "cov": 8, "step0": 100, "step1": 101}
    draws = {tag: loss_priorities(jax.random.PRNGKey(s), port.config, B, HW, G)
             for tag, s in keys.items()}
    inp = dict(z, config=json.dumps(dict(SMALL, **OVERRIDES)), cfg_file=CFG)
    inp.update({f"sd/{k}": v.numpy() for k, v in port.state_dict().items()})
    inp.update({f"{tag}/{k}": v.numpy() for tag, d in draws.items() for k, v in d.items()})
    np.savez(tmp / "input.npz", **inp)
    procs = {f"rank{r}": spawn_worker(["step", tmp / "input.npz", tmp, r, 2, tmp / "init"], tmp,
                                f"rank{r}") for r in (0, 1)}
    try:
        ref = _jax_on_mesh(model, variables, jb, keys)
    finally:
        wait_workers(procs, tmp)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)]
    shutil.rmtree(tmp)  # ~1.6 GB, most of it the bbox head's 12544² covariance
    return dict(ref=ref, ranks=ranks, port=port, tb=tb, draws=draws,
                start={k: v.numpy().copy() for k, v in port.state_dict().items()})


def _jax_on_mesh(model, variables, jb, keys):
    dmesh = create_mesh(2)
    jbs = shard_batch(jb, dmesh)
    jcfg = jax_load_config(CFG)
    jcfg["param_scheduler"][0]["end"] = 2
    opt_cfg = jcfg["optim_wrapper"]["optimizer"]
    sched = jax_lr_schedule(opt_cfg["lr"], 100, max_epochs=30, milestones=(8, 11), gamma=0.1,
                            warmup_iters=2)
    params = variables["params"]
    jopt = jax_optim.masked(jax_build_optimizer(opt_cfg, sched, params),
                            jax_trainable_mask(params, model.config))
    jstate = replicate(JaxTrainState(params=params, batch_stats=variables["batch_stats"],
                                     opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32)),
                       dmesh)
    key = {tag: jax.random.PRNGKey(s) for tag, s in keys.items()}
    flat = lambda tree: {k: v.numpy() for k, v in state_dict_from_jax(  # noqa: E731
        _flatten_tree(jax.device_get(tree)), {}).items()}
    out = {"imp": flat(jax_make_importance_step(model)(jstate, jbs, key["imp"]))}
    cov = jax_make_cov_step(model)(replicate(variables, dmesh), jbs, key["cov"])
    out["cov"] = {k: np.asarray(v) for k, v in
                  jax_nsgp.cov_collection_to_param_names(cov).items()}
    jstep = jax_make_train_step(model, jopt, donate=False)
    for t in range(2):
        jstate, metrics = jstep(jstate, jbs, key[f"step{t}"])
        out[f"m{t}"] = {k: float(v) for k, v in metrics.items()}
        out[f"p{t}"] = flat(jstate.params)
    return out


def test_the_batch_tells_global_from_local(mesh_runs):
    """Each rank's own normalizers (the mean of the ranks' terms taken
    alone) miss JAX's terms by far more than the tolerance, and the two
    images differ, so the test below tells the global form from a local one."""
    port, tb, draws, ref = (mesh_runs[k] for k in ("port", "tb", "draws", "ref"))
    tbn = tb.replace(images=normalize_images(tb.images))
    local = []
    with torch.no_grad():
        for r in (0, 1):
            pri = {k: mesh.shard_rows(v, r, 2) for k, v in draws["step0"].items()}
            local.append(port.loss(mesh.shard_rows(tbn, r, 2), priorities=pri))
    misses = {k: abs((float(local[0][k]) + float(local[1][k])) / 2 - ref["m0"][k])
              / abs(ref["m0"][k]) for k in ("loss_rpn_cls", "loss_cls")}
    assert all(m > 10 * LOSS_RTOL for m in misses.values()), misses
    assert not np.array_equal(tb.images[0].numpy(), tb.images[1].numpy())


@pytest.mark.parametrize("t", [0, 1])
def test_steps_match_jax_mesh(mesh_runs, t):
    """Both ranks report the global loss terms and hold the same weights,
    bit for bit; both match JAX's mesh after each step."""
    ref, ranks, start, port = (mesh_runs[k] for k in ("ref", "ranks", "start", "port"))
    for r in ranks:
        got = {k[3:]: v for k, v in r.items() if k.startswith(f"m{t}/")}
        assert set(got) == set(ref[f"m{t}"])
        for k, v in ref[f"m{t}"].items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    p0 = {k[3:]: v for k, v in ranks[0].items() if k.startswith(f"p{t}/")}
    p1 = {k[3:]: v for k, v in ranks[1].items() if k.startswith(f"p{t}/")}
    assert p0.keys() == p1.keys() and all(np.array_equal(p0[k], p1[k]) for k in p0)
    mask = trainable_mask(port, port.config)
    moved = 0
    for name, got in p0.items():
        if not mask[name]:
            assert np.array_equal(got, start[name]), name
            continue
        want = ref[f"p{t}"][name]
        delta = np.abs(want - start[name]).max()
        moved += delta > 0
        err = np.abs(got - want).max()
        ulps = 4 * np.spacing(np.abs(want).max())
        assert err <= GRAD_REL * delta + ulps, (t, name, err, delta)
    assert moved > 0.8 * sum(mask.values())


def test_importance_gradients_match_jax_mesh(mesh_runs):
    ref, ranks = mesh_runs["ref"]["imp"], mesh_runs["ranks"]
    got = {k[4:]: v for k, v in ranks[0].items() if k.startswith("imp/")}
    other = {k[4:]: v for k, v in ranks[1].items() if k.startswith("imp/")}
    assert got.keys() == ref.keys() == other.keys()
    nonzero = 0
    for k, want in ref.items():
        assert np.array_equal(got[k], other[k]), k
        scale = np.abs(want).max()
        nonzero += scale > 0
        assert np.abs(got[k] - want).max() <= GRAD_REL * max(scale, 1e-6), k
    assert nonzero > len(ref) // 2


def test_covariance_matches_jax_mesh(mesh_runs):
    ref = mesh_runs["ref"]["cov"]
    got = {k[4:]: v for k, v in mesh_runs["ranks"][0].items() if k.startswith("cov/")}
    assert set(got) == set(ref) and "bbox_head/shared_fc1/kernel" in got
    for k, want in ref.items():
        scale = np.abs(want).max()
        assert scale > 0, k
        assert np.abs(got[k] - want).max() <= COV_REL * scale, k


# ---------------------------------------------------------------------------
# 3. the runner at world 1 and world 2
# ---------------------------------------------------------------------------

def _read_world(root):
    """What the tests compare of one world's run, read into memory."""
    out = {"ranks": [json.load(open(p)) for p in sorted(root.glob("rank*.json"))],
           "dets": [pickle.load(open(root / f"dets{i}.pkl", "rb")) for i in (0, 1)]}
    for task in (1, 2):
        d = root / f"task_{task}"
        out[task] = dict(files=sorted(os.listdir(d)), cov=ckpt_io.load_covariance(d),
                         rois=ckpt_io.load_rois_etc(d), ewc=ckpt_io.load_ewc_terms(d, 2),
                         best=ckpt_io.load_pytree_flat(ckpt_io.find_checkpoint(str(d), "best")),
                         masks=ckpt_io.load_masks(d))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """tools/torch_train.py's main over task 1 then task 2, once as one
    process and once as two ranks, all three processes at once; the work
    dirs (~1.8 GB of checkpoints) are read, then removed."""
    tmp = tmp_path_factory.mktemp("dp_runner")
    voc = make_voc(tmp / "VOCdevkit")
    procs = {}
    for world in (1, 2):
        root = tmp / f"world{world}"
        root.mkdir()
        cfgs = []
        for task in (1, 2):
            cfg = make_cfg(voc, str(root), task)
            cfg["train_dataloader"]["batch_size"] = 4
            cfg["val_dataloader"]["batch_size"] = 4
            cfgs.append(write_cfg(cfg, tmp / f"w{world}_task{task}.py"))
        for r in range(world):
            procs[f"w{world}r{r}"] = spawn_worker(["train", root, r, world, tmp / f"init{world}",
                                             *cfgs], tmp, f"w{world}r{r}")
    wait_workers(procs, tmp)
    out = {w: _read_world(tmp / f"world{w}") for w in (1, 2)}
    shutil.rmtree(tmp)
    return out


def _close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= RUNNER_REL * scale, what


def test_world_two_writes_the_same_files_once(worlds):
    """Every file of world 1 and no other, each written by rank 0 alone;
    both ranks ran at world 2 and scored the mAP world 1 scored."""
    one, two = worlds[1], worlds[2]
    assert [r["world"] for r in one["ranks"]] == [1] and [r["world"] for r in two["ranks"]] == [2, 2]
    for task in (1, 2):
        names = one[task]["files"]
        assert {"covariance.npz", "rois_etc.npz", "ewc_reg_terms_ewc.npz", "resume_state.npz",
                "scalars.json"} <= set(names)
        assert two[task]["files"] == names, task
    assert "mask.pkl" in two[2]["files"]
    assert two["ranks"][1]["writes"] == [] and two["ranks"][0]["writes"]
    w0 = [osp.basename(p) for _, p in two["ranks"][0]["writes"]]
    assert sorted(w0) == sorted(osp.basename(p) for _, p in one["ranks"][0]["writes"])
    maps = [r["maps"] for r in two["ranks"]]
    assert maps[0] == maps[1]
    np.testing.assert_allclose(maps[0], one["ranks"][0]["maps"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("task", [1, 2])
def test_world_two_covariance_matches_world_one(worlds, task):
    c1, c2 = worlds[1][task]["cov"], worlds[2][task]["cov"]
    assert c1.keys() == c2.keys() and c1
    for k in c1:
        _close(c2[k], c1[k], k)


@pytest.mark.parametrize("task", [1, 2])
def test_world_two_roi_store_matches_world_one(worlds, task):
    """The same rows in the same order (not only the same set)."""
    r1, r2 = worlds[1][task]["rois"], worlds[2][task]["rois"]
    assert len(r1[0]) == len(r2[0]) > 0
    for i, (a, b) in enumerate(zip(r2, r1)):
        if b.dtype.kind in "iub":
            assert np.array_equal(a, b), i
        else:
            _close(a, b, i)


@pytest.mark.parametrize("task", [1, 2])
def test_world_two_ewc_terms_and_checkpoint_match_world_one(worlds, task):
    e1, e2 = worlds[1][task]["ewc"], worlds[2][task]["ewc"]
    assert e1.keys() == e2.keys() and e1
    for k in e1:
        for a, b, part in zip(e2[k], e1[k], ("importance", "weights")):
            _close(a, b, (k, part))
    f1, f2 = worlds[1][task]["best"], worlds[2][task]["best"]
    assert f1.keys() == f2.keys()
    for k in f1:
        _close(f2[k], f1[k], k)


def test_world_two_prototype_masks_match_world_one(worlds):
    m1, m2 = worlds[1][2]["masks"], worlds[2][2]["masks"]
    assert len(m1) == len(m2) > 0
    for a, b in zip(m1, m2):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("task", [0, 1])
def test_world_two_val_detections_match_world_one(worlds, task):
    """The detections validation gathered from the ranks, dumped by rank
    0: the same images in the same order, the same labels, boxes and
    scores within the tolerance."""
    d1, d2 = worlds[1]["dets"][task], worlds[2]["dets"][task]
    assert [d["img_id"] for d in d1] == [d["img_id"] for d in d2] and len(d1) == 8
    assert sum(len(d["boxes"]) for d in d1) > 0
    for a, b in zip(d2, d1):
        assert np.array_equal(a["labels"], b["labels"]), b["img_id"]
        _close(a["boxes"], b["boxes"], b["img_id"])
        _close(a["scores"], b["scores"], b["img_id"])
