"""The port's runner: a two-task NSGP-RePRE chain on the CPU, held to the
JAX package through the files it writes.

The twin of tests/test_pipeline.py::test_two_task_pipeline, on
tests/voc_fixture.py's copy of its 8-image synthetic VOC set and config
(one bottleneck per stage, 80x60 images, batch 2): task 1 trains, task 2
trains with the teacher (fed from the pseudo-label cache), the NSGP
projections, the EWC terms and the prototypes, and both resume, with the
JAX test's asserts. Then the JAX package reads the port's files, and a
JAX ``NullSpaceRunner`` built on the task-2 config over the port's
task-1 dir (``__init__`` only) holds what the port's task-2 runner built
from the same dir: projections P = V·Vᵀ within n * 2**-24 of their
largest entry (the same float64 decomposition, one f32 product summed in
another order; tests/test_torch_task_end.py's rule), prototypes, labels,
EWC terms and teacher weights bit-equal, and ``resume_state.npz`` with
the keys JAX's resume state flattens to, which JAX's ``_try_resume``
reads. Random draws differ between the packages (torch.Generator against
jax.random), so training itself is not compared here; the steps are
(tests/test_torch_train.py, test_torch_task2.py).
"""
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from nsgp_repre_tpu.utils import checkpoint as jax_ckpt
from nsgp_repre_tpu.utils.checkpoint import _flatten_tree
from nsgp_repre_tpu.utils.config import Config as JaxConfig

from nsgp_repre_tpu_torch.engine.runner import NullSpaceRunner
from nsgp_repre_tpu_torch.utils import checkpoint as ckpt_io
from nsgp_repre_tpu_torch.utils.config import Config
from nsgp_repre_tpu_torch.utils.convert import jax_flat_from_state_dict, jax_path_from_port
from voc_fixture import make_cfg, make_voc, write_cfg

N_TASKS = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads and two BLAS threads: the suite runs six workers
    on a few cores, and numpy's float64 eigh (build_transforms) on an
    oversubscribed BLAS ran ~18x slower here."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2):
        yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return make_voc(tmp_path_factory.mktemp("VOCdevkit"))


@pytest.fixture(scope="module")
def chain(voc_root, tmp_path_factory):
    """Task 1 trained, task 2 built (its state at __init__ kept) and trained."""
    work_root = str(tmp_path_factory.mktemp("work"))
    r1 = NullSpaceRunner(Config.wrap(make_cfg(voc_root, work_root, 1)), device="cpu")
    assert r1.state.teacher_params is None and r1.teacher is None
    r1.train()
    r2 = NullSpaceRunner(Config.wrap(make_cfg(voc_root, work_root, 2)), device="cpu")
    at_init = dict(
        teacher={k: v.clone() for k, v in r2.teacher.state_dict().items()},
        transforms=dict(r2.optimizer.transforms),
        replay=(r2.state.replay_feats.clone(), r2.state.replay_labels.clone()),
        ewc={k: (i.clone(), p.clone()) for k, (i, p) in r2.ewc_terms.items()},
    )
    r2.train()
    return dict(voc_root=voc_root, work_root=work_root, r1=r1, r2=r2, at_init=at_init,
                wd1=r1.work_dir, wd2=r2.work_dir)


def test_two_task_pipeline(chain):
    """tests/test_pipeline.py::test_two_task_pipeline's asserts."""
    voc_root, work_root, wd1, wd2, r2 = (chain[k] for k in ("voc_root", "work_root", "wd1",
                                                           "wd2", "r2"))
    for f in ("covariance.npz", "rois_etc.npz", "ewc_reg_terms_ewc.npz"):
        assert osp.exists(osp.join(wd1, f))
    assert any(f.startswith("best_") for f in os.listdir(wd1))
    cov = ckpt_io.load_covariance(wd1)
    assert any(k.startswith("backbone/") for k in cov)
    assert any(k.startswith("neck/") for k in cov)
    for v in cov.values():
        assert v.shape[0] == v.shape[1]
    rois = ckpt_io.load_rois_etc(wd1)
    assert rois[0].shape[1] == 7 * 7 * 256
    assert ((rois[1] < 2) | (rois[1] == 4)).all()  # task-1 classes, or bg

    # task 2: teacher, NSGP, EWC and RePRE all active
    assert r2.state.teacher_params is not None and r2.state.replay_feats is not None
    assert len(r2.ewc_terms) > 0
    tf = chain["at_init"]["transforms"]
    assert len(tf) > 0 and tf.keys() == r2.optimizer.transforms.keys()
    assert all("rpn" not in k and "bbox_head" not in k for k in tf)
    assert r2.timings["teacher_batches"] == 8 and r2.timings["train_steps"] == 4
    cov2 = ckpt_io.load_covariance(wd2)
    assert set(cov2) >= set(cov)
    assert len(ckpt_io.load_rois_etc(wd2)[0]) > len(rois[0])
    assert ckpt_io.load_masks(wd2) is not None
    assert np.isfinite(r2.val())

    # resume, task 1: the loop state from resume_state.npz
    cfg1r = Config.wrap(make_cfg(voc_root, work_root, 1))
    cfg1r["resume"] = True
    r1b = NullSpaceRunner(cfg1r, device="cpu")
    assert r1b._try_resume() == 1 and r1b.state.step > 0
    # resume, task 2: teacher, projections, prototypes and EWC rows rebuilt
    # at __init__ from task 1's files; the loop state restored on top
    cfg2r = Config.wrap(make_cfg(voc_root, work_root, 2))
    cfg2r["resume"] = True
    r2b = NullSpaceRunner(cfg2r, device="cpu")
    assert r2b._try_resume() == 1
    assert r2b.state.step == r2.state.step > 0 and r2b.optimizer.count == r2.optimizer.count
    assert r2b._resumed_best >= 0
    assert len(r2b.optimizer.transforms) > 0
    # parameters and momentum as the resumed run left them
    flat = ckpt_io.load_pytree_flat(osp.join(wd2, "resume_state.npz"))
    now = ckpt_io.model_flat(r2b.model.state_dict())
    assert all(np.array_equal(now[k], flat[k]) for k in now)
    for n, p in r2b.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(r2b.optimizer.state[p]["momentum"], r2.optimizer.state[
                r2.model.get_parameter(n)]["momentum"]), n
    # the teacher is still task 1's best checkpoint
    best1 = ckpt_io.find_checkpoint(wd1, "best")
    flat1 = ckpt_io.load_pytree_flat(best1)
    assert np.array_equal(r2b.teacher.backbone.conv1.weight.detach().numpy(),
                          np.transpose(flat1["params/backbone/conv1/kernel"], (3, 2, 0, 1)))


def test_checkpoints_hold_the_jax_paths(chain):
    """Every model checkpoint holds exactly the JAX paths of the model's
    state in JAX layouts; it loads into a fresh model bit for bit."""
    r1 = chain["r1"]
    params, stats = jax_flat_from_state_dict(r1.model.state_dict())
    keys = {f"params/{k}" for k in params} | {f"batch_stats/{k}" for k in stats}
    for f in ("epoch_0.npz", "best_mAP_epoch_0.npz"):
        flat = jax_ckpt.load_pytree_flat(osp.join(chain["wd1"], f))
        assert set(flat) == keys
        assert flat["params/backbone/conv1/kernel"].shape == (7, 7, 3, 64)
        assert flat["params/bbox_head/fc_cls_bg/kernel"].shape == (1024, 1)
    fresh = NullSpaceRunner(Config.wrap(make_cfg(chain["voc_root"], chain["work_root"] + "/x", 1)),
                            device="cpu").model
    ckpt_io.load_checkpoint(fresh, osp.join(chain["wd1"], "best_mAP_epoch_0.npz"), strict=True)
    ref = r1.model.state_dict()  # the task-end passes reloaded the best checkpoint
    assert all(torch.equal(v, ref[k]) for k, v in fresh.state_dict().items())


def test_files_load_in_jax(chain):
    """The JAX package's readers take every file of both work dirs; EWC
    terms are keyed by JAX paths, one row per task."""
    for wd, t in ((chain["wd1"], 1), (chain["wd2"], 2)):
        cov = jax_ckpt.load_covariance(wd)
        assert cov and all(v.dtype == np.float32 for v in cov.values())
        rois = jax_ckpt.load_rois_etc(wd)
        assert [a.dtype for a in rois] == [np.float32, np.int32, np.float32, np.float32,
                                           np.float32, np.float32]
        ewc = jax_ckpt.load_ewc_terms(wd)
        assert len(ewc) == 34 and all(k.startswith("backbone/") for k in ewc)
        assert all(i.shape[0] == p.shape[0] == t for i, p in ewc.values())
        flat = jax_ckpt.load_pytree_flat(osp.join(wd, "resume_state.npz"))
        assert int(flat["epoch"]) == 0 and flat["count"].dtype == np.int32
    masks = jax_ckpt.load_masks(chain["wd2"])
    assert len(masks) == 2 and all(m.dtype == bool for cls in masks for m in cls)


def test_cached_teacher_labels_equal_the_teacher(chain):
    """A batch rebuilt from the pseudo-label cache holds the teacher's
    valid detections bit for bit, at their rows."""
    r2 = chain["r2"]
    r2.train_loader.set_epoch(0)
    for batch, meta in r2.train_loader:
        cached = r2._cached_pseudo(batch, meta)
        live = r2.teacher_step(batch)
        assert torch.equal(cached.valid, live.valid) and live.valid.any()
        v = live.valid
        for name in ("boxes", "scores", "labels"):
            assert torch.equal(getattr(cached, name)[v], getattr(live, name)[v]), name


@pytest.fixture(scope="module")
def jax_task2(chain, tmp_path_factory):
    """The JAX package's task-2 runner over the port's task-1 dir (__init__ only)."""
    from nsgp_repre_tpu.engine.runner import NullSpaceRunner as JaxRunner

    cfg = make_cfg(chain["voc_root"], chain["work_root"], 2)
    cfg["work_dir"] = str(tmp_path_factory.mktemp("jax_task_2"))
    return JaxRunner(JaxConfig.wrap(cfg))


def test_jax_builds_the_same_transforms(chain, jax_task2):
    ref = jax_task2.state.opt_state.transforms
    got = chain["at_init"]["transforms"]
    # the port installs the projections of its trainable parameters only
    trainable = chain["r2"].optimizer.names.values()
    assert got and set(got) == {n for n in trainable if jax_path_from_port(n, N_TASKS) in ref}
    for name, P in got.items():
        r = np.asarray(ref[jax_path_from_port(name, N_TASKS)])
        assert np.abs(P.numpy() - r).max() <= r.shape[0] * 2 ** -24 * np.abs(r).max(), name


def test_jax_builds_the_same_prototypes_and_ewc_terms(chain, jax_task2):
    feats, labels = chain["at_init"]["replay"]
    assert np.array_equal(feats.numpy(), np.asarray(jax_task2.state.replay_feats))
    assert np.array_equal(labels.numpy(), np.asarray(jax_task2.state.replay_labels))
    ewc = chain["at_init"]["ewc"]
    assert {jax_path_from_port(k, N_TASKS) for k in ewc} == set(jax_task2.ewc_terms)
    for k, (imp, par) in ewc.items():
        ri, rp = jax_task2.ewc_terms[jax_path_from_port(k, N_TASKS)]
        assert np.array_equal(imp.numpy(), np.asarray(ri)) and np.array_equal(par.numpy(),
                                                                                np.asarray(rp)), k


def test_jax_builds_the_same_teacher(chain, jax_task2):
    """Both teachers are task 1's best checkpoint, before and after task 2 trained."""
    ref = _flatten_tree(jax_task2.teacher_params)
    for state in (chain["at_init"]["teacher"], chain["r2"].teacher.state_dict()):
        params, _ = jax_flat_from_state_dict(state)
        assert params.keys() == ref.keys()
        assert all(np.array_equal(params[k], ref[k]) for k in ref)


def test_jax_reads_the_resume_state(chain, jax_task2):
    """resume_state.npz has the keys of JAX's resume state (every
    parameter's momentum, count, step, epoch, best_map), and JAX's
    _try_resume (strict) restores the port's step count from it."""
    path = osp.join(chain["wd2"], "resume_state.npz")
    got = set(jax_ckpt.load_pytree_flat(path))
    ref = set(_flatten_tree(jax_task2._fetch_host_state(with_slots=True))) | {"epoch", "best_map"}
    assert got == ref
    shutil.copy(path, osp.join(jax_task2.work_dir, "resume_state.npz"))
    jax_task2.cfg["resume"] = True
    assert jax_task2._try_resume() == 1
    assert int(jax_task2.state.step) == chain["r2"].state.step
    assert int(jax_task2.state.opt_state.count) == chain["r2"].optimizer.count


def test_torch_test_tool_gives_the_runner_map(chain, tmp_path):
    """tools/torch_test.py on task 2's best checkpoint scores what the
    runner's last validation scored (the same weights, the same CPU
    arithmetic: bit-equal), and dumps its detections."""
    import pickle
    import sys

    sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools"))
    import torch_test

    cfg = make_cfg(chain["voc_root"], chain["work_root"], 2)
    path = write_cfg(cfg, tmp_path / "cfg2.py")
    best = ckpt_io.find_checkpoint(chain["wd2"], "best")
    out = str(tmp_path / "dets.pkl")
    mAP = torch_test.main([path, best, "--work-dir", str(tmp_path / "test"), "--out", out,
                           "--device", "cpu"])
    assert mAP == chain["r2"].last_val_map
    dets = pickle.load(open(out, "rb"))
    assert len(dets) == 8 and {"img_id", "boxes", "scores", "labels"} <= set(dets[0])


def test_torch_train_tool_runs_a_teacher_runner(chain, tmp_path):
    """tools/torch_train.py with runner_type=TeacherRunner: one task-2
    epoch with the teacher and no NSGP, EWC or task-end files."""
    import sys

    sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools"))
    import torch_train

    cfg = make_cfg(chain["voc_root"], chain["work_root"], 2)
    path = write_cfg(cfg, tmp_path / "cfg2.py")
    wd = str(tmp_path / "teacher_runner")
    runner = torch_train.main([path, "--work-dir", wd, "--device", "cpu",
                               "--cfg-options", "runner_type=TeacherRunner"])
    assert type(runner).__name__ == "TeacherRunner"
    assert runner.state.teacher_params is not None and not runner.optimizer.transforms
    assert not runner.ewc_terms
    assert sorted(os.listdir(wd)) == ["best_mAP_epoch_0.npz", "epoch_0.npz", "mask.pkl"]


def test_runner_refuses_what_it_lacks(chain, monkeypatch):
    cfg = Config.wrap(make_cfg(chain["voc_root"], chain["work_root"], 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NullSpaceRunner(cfg)
    # WORLD_SIZE asks for several processes, but no process group is up:
    # the runner names the call that joins one (parallel/mesh.py)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="maybe_init_distributed"):
        NullSpaceRunner(cfg, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    # validation's visualization is ported: vis_images=2 draws the first
    # two val images (gts left, detections right) under vis_data/
    r1 = chain["r1"]
    monkeypatch.setitem(r1.cfg, "vis_images", 2)
    vis_dir = os.path.join(r1.work_dir, "vis_data")
    shutil.rmtree(vis_dir, ignore_errors=True)
    r1.val()
    drawn = sorted(os.listdir(vis_dir))
    assert len(drawn) == 2 and all(n.endswith(".jpg") for n in drawn), drawn
    shutil.rmtree(vis_dir)
