"""A window of the port's train step: ``engine/train.py::make_train_step``.

Set-up builds the detector from its config file (the runner's
``detector_config_from_cfg`` or the zoo's ``build_config``), loads the
seeded weights, builds the optimizer with
``engine/runner.py::build_train_optimizer`` and, for a task >= 2 config,
the frozen teacher (``build_teacher``), the NSGP projections
(``engine/optim.py::set_transforms``), the prototypes and the EWC terms.
The teacher's detections on the mix's distinct batches are made once, as
the runner's pseudo-label cache makes them, and fed to the step.

The first three steps are the check's: they run through the same call
and feed as the window's, on three distinct batches, and leave the loss
of each, the gradient the optimizer got in the first (its momentum
buffer less the decay) and the parameters' change after the third. The
plain reference follows the same three steps once the window is over.
"""
from __future__ import annotations

import gc
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import common, flops
from portbench.reference import detector as ref

CHECK_STEPS = 3
WARM_STEPS = 2  # beyond the check's three, before the window


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


class Entry:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, fault: str = ""):
        from nsgp_repre_tpu_torch.engine import optim as port_optim
        from nsgp_repre_tpu_torch.engine.runner import build_teacher, build_train_optimizer
        from nsgp_repre_tpu_torch.engine.train import (TrainState, make_teacher_step,
                                                       make_train_step)
        from nsgp_repre_tpu_torch.ops import _ext
        from nsgp_repre_tpu_torch.utils.convert import jax_path_from_port

        self.cfg, self.traffic, self.device, self.fault = cfg, traffic, device, fault
        self._ext = _ext
        dev = torch.device(device)
        B = traffic["batch"]
        self.images_per_step = B
        model, full = common.program_model(cfg, device)
        gen = torch.Generator(dev).manual_seed(common.seed_bits(seed, 1))
        self.batches = common.make_batches(traffic, gen, np.random.default_rng(common.seed_bits(seed, 2)))
        nb = len(self.batches)
        W = self.W = common.seeded_weights(model, cfg, self.batches[0], gen)
        names = ref.trainable(cfg, list(W))
        self.names = names
        T = cfg.get("projection_keep")
        proj_names = [n for n in names if W[n].dim() == 4 and n.startswith(("backbone.", "neck."))]
        self.transforms = common.make_projections(W, proj_names, T, gen) if T else {}
        teacher = cfg["task_id"] > 1
        self.replay = None
        self.ewc = None
        if teacher:
            n_proto = traffic["replay_prototypes"]
            old = cfg["task_split"][cfg["task_id"] - 1]
            feats = torch.randn((n_proto, cfg["fpn_channels"] * cfg["roi_out_size"] ** 2),
                                generator=gen, device=dev)
            labels = torch.arange(old, device=dev).repeat_interleave(n_proto // old)
            self.replay = (feats, labels)
            self.ewc = common.make_ewc(W, cfg["ewc_importance"], cfg["ewc_drift"], gen)
        G = traffic["gt_slots"] + (cfg["max_per_img"] if teacher else 0)
        self.priorities = []
        for _ in range(nb):
            pri = {"rpn": torch.rand((B, self.num_anchors()), generator=gen, device=dev)}
            for k in ("roi", "roi2"):
                pri[k] = torch.rand((B, G + cfg["rpn_max_per_img"]), generator=gen, device=dev)
            self.priorities.append(pri)

        # ---- the program's training state ----
        model.load_state_dict(W)
        model.eval()
        self.model = model
        steps_per_epoch = cfg["optimizer"]["steps_per_epoch"]
        opt = build_train_optimizer(full, model, steps_per_epoch)
        check_optimizer(opt, cfg["optimizer"], names)
        if self.transforms:
            n_tasks = len(cfg["task_split"]) - 1
            port_optim.set_transforms(
                opt, {jax_path_from_port(n, n_tasks): P.cpu() for n, P in self.transforms.items()},
                n_tasks)
            if set(opt.transforms) != set(self.transforms):
                raise ValueError("the optimizer installed another set of projections")
        self.opt = opt
        if fault == "frozen_step":
            opt.step = lambda closure=None: None
        state_kw = {}
        self.teacher = None
        if teacher:
            with dev:
                self.teacher = build_teacher(model)
            state_kw = dict(teacher_params=dict(self.teacher.named_parameters()),
                            replay_feats=self.replay[0], replay_labels=self.replay[1],
                            ewc_terms=self.ewc)
            if fault == "drop_replay":
                state_kw.update(replay_feats=None, replay_labels=None)
            if fault == "drop_ewc":
                state_kw["ewc_terms"] = None
        self.state = TrainState(opt, **state_kw)
        self.train_step = make_train_step(model, opt, teacher_model=self.teacher)

        rows = slice(0, B // 2) if fault == "half_batch" else slice(None)
        self.feed = [common.program_batch(b, rows) for b in self.batches]
        self.feed_pri = [{k: v[rows] for k, v in p.items()} for p in self.priorities]
        self.dets = [None] * nb
        if teacher:
            teach = make_teacher_step(self.teacher)
            with torch.no_grad():
                self.dets = [teach(common.program_batch(b)) for b in self.batches]
        self.teacher_prog = [None if d is None else {
            "boxes": d.boxes.float(), "labels": d.labels.long(), "valid": d.valid, "scores": d.scores.float()}
            for d in self.dets[:CHECK_STEPS]]
        if teacher and fault == "half_batch":
            self.dets = [d.__class__(*(None if t is None else t[rows] for t in (
                d.boxes, d.labels, d.valid, d.scores, d.masks))) for d in self.dets]

        # ---- the check's three steps, then the warm-up ----
        p0 = {n: p.detach().clone() for n, p in model.named_parameters() if n in set(names)}
        self.loss_prog: List[float] = []
        wd = cfg["optimizer"]["weight_decay"]
        params = dict(model.named_parameters())
        self.i = 0
        for s in range(CHECK_STEPS):
            m = self.step()
            self.loss_prog.append(float(m["loss"]))
            if s == 0:
                self.terms_prog = {k: float(v) for k, v in m.items() if "loss" in k and k != "loss"}
            if s == 0:
                self.grad_prog = _norms({
                    n: (opt.state[params[n]]["momentum"] - wd * p0[n])
                    if "momentum" in opt.state.get(params[n], {}) else torch.zeros_like(p0[n])
                    for n in names})
        self.change_prog = _norms({n: params[n].detach() - p0[n] for n in names})
        del p0, params
        for _ in range(WARM_STEPS):
            self.step()
        self.sync()

    # ------------------------------------------------------------------
    def num_anchors(self) -> int:
        A = len(self.cfg["anchor_ratios"]) * len(self.cfg["anchor_scales"])
        return sum(h * w * A for h, w in self.level_sizes())

    def level_sizes(self) -> List[Tuple[int, int]]:
        H, W = self.traffic["canvas"]
        return [(-(-H // s), -(-W // s)) for s in self.cfg["anchor_strides"]]

    def step(self):
        """One optimizer step of the window, on the next distinct batch."""
        k = self.i % len(self.feed)
        self.i += 1
        self.state, m = self.train_step(self.state, self.feed[k], priorities=self.feed_pri[k],
                                        teacher_dets=self.dets[k])
        return m

    def sync(self) -> None:
        torch.cuda.synchronize() if self.device.startswith("cuda") else None

    def launches(self) -> Dict[str, int]:
        return dict(self._ext.LAUNCHES)

    def flops_per_step(self) -> float:
        return flops.step_flops(self.cfg, self.traffic, train=True)

    def kernel_calls(self) -> List[Tuple[str, dict]]:
        """The hand kernels one step launches, with the shapes their work takes."""
        cfg, tr = self.cfg, self.traffic
        B = tr["batch"]
        A = len(cfg["anchor_ratios"]) * len(cfg["anchor_scales"])
        C = cfg["fpn_channels"]
        sizes = self.level_sizes()
        n_cand = sum(min(cfg["rpn_nms_pre"], h * w * A) for h, w in sizes)
        R = B * cfg["rcnn_num"]
        maps = sum(B * h * w * C for h, w in sizes[:len(cfg["roi_strides"])])
        G = tr["gt_slots"] + (cfg["max_per_img"] if cfg["task_id"] > 1 else 0)
        calls = [("rpn_head", dict(B=B, H=h, W=w, C=C, F=C, P=5 * A)) for h, w in sizes]
        calls += [("assign", dict(B=B, N=self.num_anchors(), G=G, V=sum(tr["gt_counts"]))),
                  ("nms", dict(B=B, N=n_cand, max_out=cfg["rpn_max_per_img"])),
                  ("roi_align", dict(R=R, C=C, out=cfg["roi_out_size"], ss=cfg["roi_sampling_ratio"])),
                  ("roi_align_bwd", dict(R=R, C=C, out=cfg["roi_out_size"],
                                         ss=cfg["roi_sampling_ratio"], map_elems=maps))]
        if cfg.get("mask_convs"):
            m = cfg["mask_roi_out_size"]
            calls += [("roi_align", dict(R=R, C=C, out=m, ss=cfg["roi_sampling_ratio"])),
                      ("roi_align_bwd", dict(R=R, C=C, out=m, ss=cfg["roi_sampling_ratio"],
                                             map_elems=maps))]
        return calls

    # ------------------------------------------------------------------
    def free_program(self) -> None:
        for k in ("model", "teacher", "opt", "state", "train_step", "dets", "feed", "feed_pri"):
            setattr(self, k, None)
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference_readings(self, lp=ref.identity, follow="program") -> Dict[str, object]:
        """The reference's three steps from the same weights, inputs and draws:
        each step's loss, the first step's loss terms, the first gradient's
        and the change's leaf norms. On a task >= 2 config the reference's
        own teacher predicts the three batches (``teacher_judge``: its
        detections, to judge the program's teacher by); the student steps follow the program's
        teacher detections (``follow="program"``), a given list of them, or
        with ``follow=None`` the reference's own."""
        cfg = self.cfg
        W, names = self.W, self.names
        P = {k: v.clone() for k, v in W.items()}
        bufs: Dict[str, torch.Tensor] = {}
        losses, grad, first, used, judge = [], None, None, [], []
        teacher_cfg = dict(cfg, roi_sampling_ratio=cfg.get("teacher_roi_sampling_ratio"))
        with ref.no_tf32():
            for s in range(CHECK_STEPS):
                b = self.batches[s]
                dets = None
                if cfg["task_id"] > 1:
                    own = ref.predict(W, teacher_cfg, b["images"], b["img_shape"], b["scale_factor"], lp,
                                      task_id=cfg["task_id"] - 1, rescale=False)
                    judge += dets_np(own)
                    dets = own
                    if follow == "program":
                        dets = self.teacher_prog[s]
                    elif follow is not None:
                        dets = follow[s]
                used.append(dets)
                leaves = {n: P[n].detach().requires_grad_(True) for n in names}
                PP = dict(P)
                PP.update(leaves)
                terms = ref.train_losses(PP, cfg, b, self.priorities[s], lp, dets, self.replay,
                                         self.ewc)
                total = sum(v for k, v in terms.items() if "loss" in k)
                g = torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)
                losses.append(float(total.detach()))
                gd = {n: (torch.zeros_like(P[n]) if x is None else x) for n, x in zip(names, g)}
                if s == 0:
                    grad = _norms(gd)
                    first = {k: float(v.detach()) for k, v in terms.items() if "loss" in k}
                del terms, total, g, leaves, PP
                with torch.no_grad():
                    ref.sgd_nscl_step(P, names, gd, bufs, s, cfg["optimizer"], self.transforms)
                del gd
        change = _norms({n: P[n] - W[n] for n in names})
        return {"loss": losses, "terms": first, "grad": grad, "change": change, "teacher": used,
                "teacher_dets": [d for t in used if t is not None for d in dets_np(t)],
                "teacher_judge": judge}

    def program_readings(self) -> Dict[str, object]:
        return {"loss": self.loss_prog, "terms": self.terms_prog, "grad": self.grad_prog,
                "change": self.change_prog,
                "teacher_dets": [d for t in self.teacher_prog if t is not None for d in dets_np(t)]}

    def control_readings(self):
        """(the control's readings, the reference's to judge them by): the
        reference with float8 operands in the program's place, its own
        teacher included, and the float32 reference following that teacher."""
        c = self.reference_readings(lp=ref.fp8, follow=None)
        return c, self.reference_readings(follow=c["teacher"])

    def numbers(self, p: Dict[str, object], r: Dict[str, object]) -> Dict[str, float]:
        """The numbers of readings ``p`` judged against the reference's ``r``.

        Compared (the cell's ``limits`` name which): ``rpn_term_gap``, the
        first step's RPN loss terms' worst relative gap (their anchor
        sampling is exact on both sides, so only arithmetic and the batch
        move them); ``replay_term_gap`` and ``ewc_term_gap``, the first
        step's replay and EWC terms' relative gaps (no sampling on either
        side; a term the program lacks reads 1); ``change_gap_p75``, the
        75th percentile over leaves of the gap between the program's and
        the reference's norms of the parameters' change after the three
        steps, against the larger of the reference's norm of that leaf and
        of the median leaf (leaves whose reference gradient is under a
        thousandth of the median leaf's left out); ``teacher_missed``, the
        teacher's detections judged by the reference's teacher
        (``common.detection_gaps``). Reported beside them: the worst step's
        loss gap, the worst leaf's gaps of the first gradient and of the
        change, and the worst leaf's change gap among the leaves that the
        EWC term reaches (``ewc_change_gap``) and that the replay term
        reaches (``replay_change_gap``)."""
        loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p["loss"], r["loss"]))

        def term_gap(keys):
            return max(abs(p["terms"].get(k, 0.0) - v) / max(abs(v), 1e-6) for k, v in r["terms"].items()
                       if k in keys)

        grad, gleaf = common.leaf_gap(p["grad"], r["grad"])
        med = float(np.median(list(r["grad"].values())))
        moved = {k: v for k, v in r["change"].items() if r["grad"][k] >= 1e-3 * med}
        cmed = float(np.median(list(moved.values())))
        change, cleaf = common.leaf_gap(p["change"], moved, cmed)
        c75 = float(np.percentile([abs(p["change"][k] - v) / max(v, cmed) for k, v in moved.items()], 75))
        out = {"loss_gap": loss, "rpn_term_gap": term_gap([k for k in r["terms"] if k.startswith("loss_rpn")]),
               "grad_gap": grad, "change_gap": change, "change_gap_p75": c75,
               "_grad_leaf": gleaf, "_change_leaf": cleaf}
        for term, reach in (("ewc", common.EWC_NAME.fullmatch), ("replay", REPLAY_LEAF.match)):
            key = f"{term}_loss" if term == "ewc" else "replay_loss_cls"
            if key in r["terms"]:
                out[f"{term}_term_gap"] = term_gap([key])
                out[f"{term}_change_gap"] = common.leaf_gap(
                    p["change"], {k: v for k, v in moved.items() if reach(k)}, cmed)[0]
        if r["teacher_judge"]:
            t = common.detection_gaps(p["teacher_dets"], r["teacher_judge"], self.cfg["max_per_img"],
                                      self.cfg["score_thr"])
            out["teacher_missed"] = t["missed"]
        return out


# the leaves the replay loss's gradient reaches: the shared FCs and the classifier
REPLAY_LEAF = re.compile(r"roi_head\.bbox_head\.(shared_fcs|fc_cls)\.")


def dets_np(d: dict) -> List[dict]:
    """Padded detections (tensors) -> per image, the valid ones as numpy arrays."""
    h = {k: v.detach().float().cpu().numpy() if v.dtype.is_floating_point else v.cpu().numpy()
         for k, v in d.items()}
    out = []
    for i in range(len(h["valid"])):
        v = h["valid"][i].astype(bool)
        out.append({"boxes": h["boxes"][i][v], "scores": h["scores"][i][v], "labels": h["labels"][i][v]})
    return out


def check_optimizer(opt, o: dict, names) -> None:
    """The program's optimizer: SGD with the file's momentum, decay and
    learning rates, over the reference's trainable parameters."""
    group = opt.param_groups[0]
    got = {opt.names[id(p)] for g in opt.param_groups for p in g["params"]}
    lrs = [float(opt.learning_rate(s)) for s in range(4)]
    want = [ref.lr_at(o, s) for s in range(4)]
    if (type(opt).__name__ != "SGDNSCL" or group["momentum"] != o["momentum"]
            or group["weight_decay"] != o["weight_decay"] or got != set(names) or lrs != want):
        raise ValueError(f"the program's optimizer differs from the benchmark's: {type(opt).__name__} "
                         f"lr {lrs} vs {want}, {len(got ^ set(names))} parameters differ")
