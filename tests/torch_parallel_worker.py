"""One rank of tests/test_torch_parallel.py's data-parallel runs: torch and
the port only (no JAX), started with ``sys.executable``.

    python torch_parallel_worker.py step INPUT.npz OUT_DIR RANK WORLD INIT_FILE
        the task-1 step parity run: the bridged SMALL detector and the
        global batch and draws of INPUT.npz (written by the test), this
        rank's rows of each: one importance step and one covariance batch
        on the initial weights, then two make_train_step steps; writes
        OUT_DIR/rank<R>.npz (the covariance from rank 0 only).
    python torch_parallel_worker.py family INPUT.npz OUT_DIR RANK WORLD INIT_FILE
        one model-zoo family's loss and gradient (test_torch_parallel_zoo.py):
        the ``_base_/models`` config of INPUT.npz built by the port's zoo
        with its weights, this rank's rows of the normalized global batch
        and the global draws; engine/train.py's rank_loss backward, the
        gradients averaged over the ranks, the terms made global; writes
        OUT_DIR/rank<R>.npz.
    python torch_parallel_worker.py train OUT_DIR RANK WORLD INIT_FILE CFG [CFG ...]
        tools/torch_train.py's main on each config in turn (one task
        each, on the CPU), then one more validation of each that dumps
        its detections to OUT_DIR/dets<i>.pkl; writes
        OUT_DIR/rank<R>.json with each run's last mAP and the files this
        rank wrote through utils/checkpoint.py.

WORLD > 1 joins a gloo group through ``init_method=file://INIT_FILE``
(no TCP port to race on) with a two-minute timeout, so a hung collective
fails the run instead of stalling the suite.
"""
import json
import os
import os.path as osp
import sys

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

from nsgp_repre_tpu_torch.parallel import mesh  # noqa: E402

TIMEOUT_S = 120


def _join(rank: int, world: int, init_file: str) -> None:
    torch.set_num_threads(2)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0")
    mesh.maybe_init_distributed("gloo", "cpu", init_method=f"file://{init_file}",
                                timeout_s=TIMEOUT_S)


def _batch(z):
    from nsgp_repre_tpu_torch.structures.sample import DetBatch, InstanceArray

    t = lambda k: torch.from_numpy(z[k])  # noqa: E731
    return DetBatch(images=t("images"), img_shape=t("img_shape"), ori_shape=t("img_shape"),
                    scale_factor=t("scale_factor"),
                    gt=InstanceArray(boxes=t("gt_boxes"), labels=t("gt_labels"),
                                     valid=t("gt_valid"),
                                     masks=t("gt_masks") if "gt_masks" in z else None))


def step(inp: str, out_dir: str, rank: int, world: int) -> None:
    from nsgp_repre_tpu_torch.engine.runner import build_train_optimizer
    from nsgp_repre_tpu_torch.engine.train import (TrainState, make_cov_step,
                                                   make_importance_step, make_train_step)
    from nsgp_repre_tpu_torch.models.detector import DetectorConfig, FasterRCNN
    from nsgp_repre_tpu_torch.utils.config import load_config

    z = dict(np.load(inp))
    kw = json.loads(str(z["config"]))
    port = FasterRCNN(DetectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                                        for k, v in kw.items()}))
    port.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in z.items()
                          if k.startswith("sd/")}, strict=True)
    port.eval()
    local = mesh.shard_rows(_batch(z), rank, world)

    def pri(tag):  # the global draws; the detector takes this rank's rows
        return {k.split("/")[1]: torch.from_numpy(v) for k, v in z.items()
                if k.startswith(tag + "/")}

    tcfg = load_config(osp.join(ROOT, str(z["cfg_file"])))
    tcfg["param_scheduler"][0]["end"] = 2
    opt = build_train_optimizer(tcfg, port, 100)
    out = {}
    grads = make_importance_step(port)(TrainState(None), local, priorities=pri("imp"))
    out.update({f"imp/{k}": v.numpy() for k, v in grads.items()})
    cov = make_cov_step(port)(local, priorities=pri("cov"))
    if rank == 0:
        out.update({f"cov/{k}": v.numpy() for k, v in cov.items()})
    del cov
    state, train_step = TrainState(opt), make_train_step(port, opt)
    for t in range(2):
        state, metrics = train_step(state, local, priorities=pri(f"step{t}"))
        out.update({f"m{t}/{k}": v.numpy() for k, v in metrics.items()})
        out.update({f"p{t}/{k}": p.detach().numpy().copy() for k, p in port.named_parameters()})
    np.savez(osp.join(out_dir, f"rank{rank}.npz"), **out)


def family(inp: str, out_dir: str, rank: int, world: int) -> None:
    from nsgp_repre_tpu_torch.engine.train import global_terms, rank_loss
    from nsgp_repre_tpu_torch.models.zoo import build_config
    from nsgp_repre_tpu_torch.utils.config import load_config

    z = dict(np.load(inp))
    model_cfg = load_config(osp.join(ROOT, str(z["cfg_file"])))["model"]
    cls, cfg = build_config(model_cfg, int(z["num_classes"]), **json.loads(str(z["overrides"])))
    port = cls(cfg)
    port.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in z.items()
                          if k.startswith("sd/")}, strict=True)
    port.eval()
    pri = {k[4:]: torch.from_numpy(v) for k, v in z.items() if k.startswith("pri/")}
    losses = port.loss(mesh.shard_rows(_batch(z), rank, world), priorities=pri)
    rank_loss(losses).backward()
    named = list(port.named_parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in named]
    mesh.all_reduce_mean_(grads)
    out = {f"m/{k}": v.numpy() for k, v in global_terms(losses).items()}
    out.update({f"g/{n}": g.numpy() for (n, _), g in zip(named, grads)})
    np.savez(osp.join(out_dir, f"rank{rank}.npz"), **out)


def train(out_dir: str, rank: int, configs) -> None:
    sys.path.insert(0, osp.join(ROOT, "tools"))
    import torch_train

    from nsgp_repre_tpu_torch.utils import checkpoint as ckpt_io

    writes = []  # (writer, path) of every file the checkpoint module writes
    for name in ("save_flat", "save_covariance", "save_rois_etc", "save_ewc_terms",
                 "save_masks"):
        def wrapped(*a, _fn=getattr(ckpt_io, name), _name=name, **k):
            path = _fn(*a, **k)
            writes.append((_name, path if isinstance(path, str) else a[0]))
            return path
        setattr(ckpt_io, name, wrapped)
    maps = []
    for i, cfg in enumerate(configs):
        runner = torch_train.main([cfg, "--device", "cpu", "--dist-backend", "gloo"])
        maps.append(runner.last_val_map)
        runner.val(dump_to=osp.join(out_dir, f"dets{i}.pkl"))  # rank 0 writes it
    with open(osp.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(maps=maps, writes=writes, world=mesh.world_size()), f)


def main(argv) -> None:
    mode = argv[0]
    if mode == "step":
        inp, out_dir, rank, world, init_file = argv[1:6]
        _join(int(rank), int(world), init_file)
        step(inp, out_dir, int(rank), int(world))
    elif mode == "family":
        inp, out_dir, rank, world, init_file = argv[1:6]
        _join(int(rank), int(world), init_file)
        family(inp, out_dir, int(rank), int(world))
    elif mode == "train":
        out_dir, rank, world, init_file, *configs = argv[1:]
        _join(int(rank), int(world), init_file)
        train(out_dir, int(rank), configs)
    else:
        raise SystemExit(f"unknown mode {mode}")
    if mesh.is_distributed():
        mesh.barrier("done")
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
