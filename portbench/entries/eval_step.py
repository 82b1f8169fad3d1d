"""A window of the port's validation predict: ``engine/train.py::make_eval_step``.

Set-up builds the detector from its config file, loads the seeded weights
and predicts once on each of the mix's distinct batches (the warm-up).
Each step of the window predicts one batch and copies its detections to
the host, as validation does before scoring them; the last copy of each
batch is what the check compares with the reference's predict on the same
images.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import common, flops
from portbench.reference import detector as ref


EXTEND = 3  # the reference's list per image, in multiples of max_per_img


class Entry:
    kind = "predict"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, fault: str = ""):
        from nsgp_repre_tpu_torch.engine.train import make_eval_step
        from nsgp_repre_tpu_torch.ops import _ext

        self.cfg, self.traffic, self.device, self.fault = cfg, traffic, device, fault
        self._ext = _ext
        self.images_per_step = traffic["batch"]
        model, _ = common.program_model(cfg, device)
        gen = torch.Generator(torch.device(device)).manual_seed(common.seed_bits(seed, 1))
        self.batches = common.make_batches(traffic, gen, np.random.default_rng(common.seed_bits(seed, 2)))
        self.W = common.seeded_weights(model, cfg, self.batches[0], gen)
        model.load_state_dict(self.W)
        self.model = model.eval()
        self.eval_step = make_eval_step(model)
        self.feed = [common.program_batch(b) for b in self.batches]
        self.results: List[List[dict]] = [[] for _ in self.batches]
        self.i = 0
        for _ in self.batches:
            self.step()
        self.sync()

    def step(self):
        """Predict the next distinct batch and copy its detections to the host."""
        k = self.i % len(self.feed)
        self.i += 1
        dets = self.eval_step(self.feed[k])
        host = [t.cpu().numpy() for t in (dets.boxes, dets.scores, dets.labels, dets.valid)]
        if self.fault == "altered_answer":
            top = host[1].argmax(1)  # each image's best detection gets another label
            host[2][np.arange(len(top)), top] = (host[2][np.arange(len(top)), top] + 1) % \
                self.cfg["num_classes"]
        self.results[k] = split_images(*host)

    def sync(self) -> None:
        torch.cuda.synchronize() if self.device.startswith("cuda") else None

    def launches(self) -> Dict[str, int]:
        return dict(self._ext.LAUNCHES)

    def flops_per_step(self) -> float:
        return flops.step_flops(self.cfg, self.traffic, train=False)

    def kernel_calls(self) -> List[Tuple[str, dict]]:
        cfg, B = self.cfg, self.traffic["batch"]
        A = len(cfg["anchor_ratios"]) * len(cfg["anchor_scales"])
        H, W = self.traffic["canvas"]
        sizes = [(-(-H // s), -(-W // s)) for s in cfg["anchor_strides"]]
        n_cand = sum(min(cfg["rpn_nms_pre"], h * w * A) for h, w in sizes)
        R = B * cfg["rpn_max_per_img"]
        return [("nms", dict(B=B, N=n_cand, max_out=cfg["rpn_max_per_img"])),
                ("roi_align", dict(R=R, C=cfg["fpn_channels"], out=cfg["roi_out_size"],
                                   ss=cfg["roi_sampling_ratio"])),
                ("nms", dict(B=B, N=R * cfg["num_classes"], max_out=cfg["max_per_img"]))]

    def free_program(self) -> None:
        self.model = self.eval_step = self.feed = None
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference_readings(self, lp=ref.identity) -> Dict[str, object]:
        """The reference's detections on every distinct batch, each image's list
        extended to ``EXTEND`` times ``max_per_img`` in pick order."""
        out = []
        cap = self.cfg["max_per_img"]
        with ref.no_tf32():
            for b in self.batches:
                d = ref.predict(self.W, self.cfg, b["images"], b["img_shape"], b["scale_factor"], lp,
                                max_out=EXTEND * cap)
                h = {k: v.cpu().numpy() for k, v in d.items()}
                out += split_images(h["boxes"], h["scores"], h["labels"], h["valid"])
        return {"dets": out}

    def program_readings(self) -> Dict[str, object]:
        return {"dets": [d for batch in self.results for d in batch]}

    def as_program(self, r: Dict[str, object]) -> Dict[str, object]:
        """Reference readings cut to what the program returns (the control)."""
        cap = self.cfg["max_per_img"]
        return {"dets": [{k: d[k][:cap] for k in ("boxes", "scores", "labels")} for d in r["dets"]]}

    def control_readings(self):
        """(the control's readings, the reference's to judge them by): the
        reference with float8 operands in the program's place."""
        return self.as_program(self.reference_readings(lp=ref.fp8)), self.reference_readings()

    def numbers(self, p: Dict[str, object], r: Dict[str, object]) -> Dict[str, float]:
        return common.detection_gaps(p["dets"], r["dets"], self.cfg["max_per_img"], self.cfg["score_thr"])


def split_images(boxes, scores, labels, valid) -> List[dict]:
    """Per image, its valid detections as numpy arrays."""
    return [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]],
             "labels": labels[i][valid[i]]} for i in range(len(valid))]
