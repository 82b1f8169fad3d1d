#!/usr/bin/env python
"""Single-image inference demo with the PyTorch port (the twin of
demo/image_demo.py; reference demo/image_demo.py surface).

Usage: python demo/torch_image_demo.py IMG CONFIG [--weights CKPT]
           [--out-dir DIR] [--pred-score-thr T] [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given; prints one line per
detection and writes the image with its detections drawn to
``DIR/<image name>``.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

from nsgp_repre_tpu_torch.apis import DetInferencer  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("img")
    p.add_argument("config")
    p.add_argument("--weights", default=None)
    p.add_argument("--out-dir", default="outputs")
    p.add_argument("--pred-score-thr", type=float, default=0.3)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    inferencer = DetInferencer(args.config, weights=args.weights,
                               pred_score_thr=args.pred_score_thr, device=args.device)
    result = inferencer(args.img, out_dir=args.out_dir)
    pred = result["predictions"][0]
    for box, score, label in zip(pred["boxes"], pred["scores"], pred["labels"]):
        print(f"label={int(label)} score={float(score):.3f} box={[round(float(v), 1) for v in box]}")
    return result


if __name__ == "__main__":
    main()
