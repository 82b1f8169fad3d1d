"""What every cell of the benchmark shares: finding a cell's files by name,
the seeded inputs and weights, and the comparison numbers.

Everything a run feeds the program is made here from ``--seed``, on the
device, in a few large calls: the images, the ground truth, the sampling
priorities, the weights (calibrated by the reference, never by the
program), the NSGP projections, the prototypes and the EWC terms. The
same tensors go to the program and to the plain reference
(``reference/``).
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``: a workload, a config or a traffic mix."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (entries, metric readers, kernels)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_bits(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed (any size) and a salt."""
    state = np.random.SeedSequence([seed % 2 ** 63, seed >> 63, salt]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_images(gen: torch.Generator, n: int, hw, canvas) -> torch.Tensor:
    """uint8 (n, H, W, 3) canvases whose top-left ``hw`` holds coarse 16x16
    random blocks plus N(0, 20) noise (the rest is padding, zero)."""
    H, W = hw
    dev = gen.device
    coarse = torch.randint(0, 255, (n, H // 16 + 1, W // 16 + 1, 3), generator=gen, device=dev)
    img = coarse.float().repeat_interleave(16, 1).repeat_interleave(16, 2)[:, :H, :W]
    img = img + torch.randn((n, H, W, 3), generator=gen, device=dev) * 20.0
    out = torch.zeros((n, canvas[0], canvas[1], 3), dtype=torch.uint8, device=dev)
    out[:, :H, :W] = img.clamp(0, 255).to(torch.uint8)
    return out


def make_gt(rng: np.random.Generator, counts: Sequence[int], hw, slots: int, labels: Sequence[int],
            mask_size: int = 0) -> dict:
    """Padded ground truth: image i gets ``counts[i]`` boxes with centres in
    the middle 60% of the content and sides 20-50% of it, labels uniform in
    ``[labels[0], labels[1])``; with ``mask_size``, box-normalised binary
    crops (an ellipse of random axes and centre in each box)."""
    B = len(counts)
    H, W = hw
    boxes = np.zeros((B, slots, 4), np.float32)
    lab = np.full((B, slots), -1, np.int64)
    valid = np.zeros((B, slots), bool)
    for b, n in enumerate(counts):
        cx, cy = rng.uniform(0.2, 0.8, n) * W, rng.uniform(0.2, 0.8, n) * H
        bw, bh = rng.uniform(0.2, 0.5, n) * W, rng.uniform(0.2, 0.5, n) * H
        boxes[b, :n] = np.stack([np.clip(cx - bw / 2, 0, W), np.clip(cy - bh / 2, 0, H),
                                 np.clip(cx + bw / 2, 0, W), np.clip(cy + bh / 2, 0, H)], -1)
        lab[b, :n] = rng.integers(labels[0], labels[1], n)
        valid[b, :n] = True
    out = {"boxes": torch.from_numpy(boxes), "labels": torch.from_numpy(lab),
           "valid": torch.from_numpy(valid)}
    if mask_size:
        g = (np.arange(mask_size, dtype=np.float32) + 0.5) / mask_size
        c = rng.uniform(0.35, 0.65, (B, slots, 2)).astype(np.float32)
        r = rng.uniform(0.25, 0.5, (B, slots, 2)).astype(np.float32)
        dy = (g[None, None, :, None] - c[..., 1, None, None]) / r[..., 1, None, None]
        dx = (g[None, None, None, :] - c[..., 0, None, None]) / r[..., 0, None, None]
        m = (dy ** 2 + dx ** 2 <= 1.0) & valid[..., None, None]
        out["masks"] = torch.from_numpy(m.astype(np.uint8))
    return out


def gt_counts(rng: np.random.Generator, traffic: dict) -> List[int]:
    """The batch's instance counts: the mix's fixed multiset, in a seeded order."""
    counts = list(traffic["gt_counts"])
    if len(counts) != traffic["batch"]:
        raise ValueError("gt_counts must list one count per image of the batch")
    return [counts[i] for i in rng.permutation(len(counts))]


def make_batches(traffic: dict, gen: torch.Generator, rng: np.random.Generator) -> List[dict]:
    """The mix's distinct batches on the generator's device: images, their
    content shape, unit scale factors and padded ground truth."""
    B, hw, dev = traffic["batch"], traffic["image_hw"], gen.device
    out = []
    for _ in range(traffic["distinct_batches"]):
        gt = make_gt(rng, gt_counts(rng, traffic), hw, traffic["gt_slots"], traffic["gt_labels"],
                     traffic.get("gt_mask_size", 0))
        out.append({"images": make_images(gen, B, hw, traffic["canvas"]),
                    "img_shape": torch.tensor([hw] * B, dtype=torch.int32, device=dev),
                    "scale_factor": torch.ones((B, 2), device=dev),
                    "gt": {k: v.to(dev) for k, v in gt.items()}})
    return out


def program_batch(b: dict, rows=slice(None)):
    """A batch as the port takes it (``DetBatch``), of ``rows``."""
    from nsgp_repre_tpu_torch.structures.sample import DetBatch, InstanceArray

    gt = b["gt"]
    return DetBatch(images=b["images"][rows], img_shape=b["img_shape"][rows],
                    ori_shape=b["img_shape"][rows], scale_factor=b["scale_factor"][rows],
                    gt=InstanceArray(boxes=gt["boxes"][rows], labels=gt["labels"][rows].int(),
                                     valid=gt["valid"][rows],
                                     masks=gt["masks"][rows] if "masks" in gt else None))


# ---------------------------------------------------------------------------
# the program, weights and task state
# ---------------------------------------------------------------------------

def program_model(cfg: dict, device: str):
    """The port's detector as its config file builds it (the runner's
    ``detector_config_from_cfg``, or the zoo's ``build_config``), on the
    device, its config checked against the benchmark's file. Returns the
    model and the loaded config file."""
    import dataclasses

    from nsgp_repre_tpu_torch.engine.runner import detector_config_from_cfg
    from nsgp_repre_tpu_torch.models.detector import FasterRCNN
    from nsgp_repre_tpu_torch.models.zoo import build_config
    from nsgp_repre_tpu_torch.utils.config import load_config

    full = load_config(str(ROOT / cfg["source_file"]))
    if cfg["builder"] == "runner":
        cls, det_cfg = FasterRCNN, detector_config_from_cfg(full)
    else:
        cls, det_cfg = build_config(full["model"], compute_dtype=cfg["compute_dtype"])
    det_cfg = dataclasses.replace(det_cfg, **cfg.get("program_overrides", {}))
    bad = [f"{f.name}: program {getattr(det_cfg, f.name)!r}, file {cfg[f.name]!r}"
           for f in dataclasses.fields(det_cfg)
           if f.name in cfg and _plain(getattr(det_cfg, f.name)) != _plain(cfg[f.name])]
    if bad:
        raise ValueError("the program's config differs from the benchmark's: " + "; ".join(bad))
    with torch.device(device):
        return cls(det_cfg), full


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else v


def seeded_weights(model, cfg: dict, batch: dict, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every entry of ``model``'s state dict, made from the seed: drawn, the
    BNs calibrated by the reference on ``batch``, the heads conditioned."""
    from portbench.reference import detector as ref

    W = make_weights({k: tuple(v.shape) for k, v in model.state_dict().items()}, gen)
    ref.calibrate_bn(W, cfg, batch["images"], gen)
    condition_heads(W, cfg, batch, cfg["rpn_logit_std"], cfg["cls_logit_std"], gen)
    return W


def init_std(name: str, shape) -> float:
    """The std of a leaf's seeded N(0, std) draw (the port's initializers,
    Xavier uniform replaced by the normal of the same variance)."""
    if name.endswith("bias"):
        return 0.0
    if ".bn" in name or "downsample.1" in name or name.startswith("backbone.bn1"):
        return 0.0
    if "upsample" in name:
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    if name.startswith("rpn_head.") or ".fc_cls." in name:
        return 0.01
    if ".fc_reg." in name:
        return 0.001
    if name.startswith("neck.") or ".shared_fcs." in name:
        rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        return math.sqrt(2.0 / ((shape[0] + shape[1]) * rf))
    return math.sqrt(2.0 / (shape[0] * int(np.prod(shape[2:]))))  # He normal, fan_out


def make_weights(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """f32 leaves from one N(0, 1) draw on the generator's device: scaled per
    leaf, zero biases, identity BN (statistics 0 and 1)."""
    total = sum(int(np.prod(s)) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=gen.device)
    out, off = {}, 0
    for name, s in shapes.items():
        n = int(np.prod(s))
        t = z[off:off + n].view(s)
        off += n
        if name.endswith("running_var") or (name.endswith("weight") and (
                ".bn" in name or "downsample.1" in name or name.startswith("backbone.bn1"))):
            out[name] = torch.ones(s, device=gen.device)
        else:
            out[name] = t * init_std(name, s)
    return out


def condition_heads(W: Dict[str, torch.Tensor], cfg: dict, batch: dict, rpn_std: float,
                    cls_std: float, gen: torch.Generator) -> None:
    """Scale the objectness and class weights so that their logits on the
    first two images have the given standard deviations: the RPN's at every
    anchor, the classifier's at 256 boxes per image drawn at every scale
    (sides log-uniform from 16 px to the image). Seeded heads either tie
    every score or, scaled blindly, saturate them; either way the ranking of
    proposals and detections would be decided by rounding."""
    from portbench.reference import detector as ref

    with torch.no_grad(), ref.no_tf32():
        images = batch["images"][:2]
        feats = ref.extract(W, cfg, images, ref.identity)
        cls, _ = ref.rpn_head(W, feats, ref.identity)
        W["rpn_head.rpn_cls.weight"] = W["rpn_head.rpn_cls.weight"] * (
            rpn_std / float(torch.cat(cls, 1).std()))
        H, Wd = batch["img_shape"][0].tolist()
        n = 2 * 256
        u = torch.rand((n, 4), generator=gen, device=gen.device)
        side = torch.exp(math.log(16.0) + u[:, :2] * math.log(min(H, Wd) / 16.0))
        x1 = u[:, 2] * (Wd - side[:, 0])
        y1 = u[:, 3] * (H - side[:, 1])
        rois = torch.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], 1)
        bidx = torch.arange(2, device=gen.device).repeat_interleave(n // 2)
        x = ref.roi_align(feats, rois, bidx, cfg, cfg["roi_out_size"], cfg["roi_sampling_ratio"])
        logits, _ = ref.bbox_head(W, cfg, x, ref.identity, len(cfg["task_split"]) - 1)
        scale = cls_std / float(logits.std())
    for k in list(W):
        if ".fc_cls." in k and k.endswith("weight"):
            W[k] = W[k] * scale


def make_projections(W: Dict[str, torch.Tensor], names: Sequence[str], keep: float,
                     gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A projection onto a random ``keep`` share of each layer's input space
    (the (I*kh*kw)^2 shape NSCL gives a conv): P = Q Q^T with Q orthonormal;
    backbone ones divided by their Frobenius norm, as SGD-NSCL divides them."""
    out = {}
    for n in names:
        w = W[n]
        d = int(np.prod(w.shape[1:]))
        k = max(1, int(d * keep))
        q = torch.linalg.qr(torch.randn((d, k), generator=gen, device=gen.device)).Q
        p = q @ q.T
        if n.startswith("backbone."):
            p = p / torch.linalg.norm(p)
        out[n] = p
    return out


EWC_NAME = re.compile(r"backbone\.(bn1|layer\d+\.\d+\.(bn\d|downsample\.1))\.(weight|bias)")


def make_ewc(W: Dict[str, torch.Tensor], scale: float, drift: float, gen: torch.Generator):
    """One old task's EWC terms on every BN affine tensor, as a task part-way
    through has them: importance U(0, scale), the old value the current one
    (the teacher's) less a seeded N(0, drift) step, so that the term and its
    gradient are live from the first step."""
    out = {}
    for k, v in W.items():
        if EWC_NAME.fullmatch(k):
            imp = torch.rand((1,) + tuple(v.shape), generator=gen, device=gen.device) * scale
            step = torch.randn((1,) + tuple(v.shape), generator=gen, device=gen.device) * drift
            out[k] = (imp, v.detach()[None] - step)
    return out


# ---------------------------------------------------------------------------
# comparison numbers
# ---------------------------------------------------------------------------

def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], med: float = 0.0) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and ``med`` (by
    default the median leaf's). Returns (gap, leaf)."""
    med = med or float(np.median([ref[k] for k in ref]))
    worst, at = 0.0, ""
    for k, r in ref.items():
        g = abs(prog[k] - r) / max(r, med, 1e-30)
        if g > worst:
            worst, at = g, k
    return worst, at


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-6)


def detection_gaps(prog: List[dict], ref: List[dict], cap: int, score_thr: float,
                   iou_min: float = 0.5, margin: float = 0.05, top: int = 10) -> Dict[str, float]:
    """The program's detections judged by the reference, image by image.

    ``missed``: the share of the reference's first ``cap`` detections
    scoring above the program's cut by ``margin`` (the program's lowest
    kept score when it kept ``cap``, else the threshold) that no program
    detection of the same label overlaps at ``iou_min``; ``missed_top``:
    the same share among each image's ``top`` most confident reference
    detections alone."""
    missed = confident = missed_top = n_top = 0
    for p, r in zip(prog, ref):
        k = min(top, cap, len(r["scores"]))
        n_top += k
        if k and len(p["scores"]) == 0:
            missed_top += k
        elif k:
            ov = box_iou_np(r["boxes"][:k], p["boxes"])
            ok = (ov >= iou_min) & (r["labels"][:k][:, None] == p["labels"][None, :])
            missed_top += int((~ok.any(1)).sum())
        cut = (float(p["scores"].min()) if len(p["scores"]) >= cap else score_thr) + margin
        conf = r["scores"][:cap] >= cut
        n = int(conf.sum())
        if n == 0:
            continue
        confident += n
        if len(p["scores"]) == 0:
            missed += n
            continue
        ov = box_iou_np(r["boxes"][:cap][conf], p["boxes"])
        ok = (ov >= iou_min) & (r["labels"][:cap][conf][:, None] == p["labels"][None, :])
        missed += int((~ok.any(1)).sum())
    return {"missed": missed / max(confident, 1), "missed_top": missed_top / max(n_top, 1),
            "_confident": confident, "_detections": int(sum(len(p["scores"]) for p in prog))}
