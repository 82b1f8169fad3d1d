#!/usr/bin/env python
"""Evaluate a trained checkpoint with the PyTorch port (the CLI of tools/test.py).

    python tools/torch_test.py <config> <checkpoint> [--work-dir DIR] [--out results.pkl]

``checkpoint`` is a ``.npz`` of either package or a reference mmdet
``.pth``. ``--device`` names the device (default ``cuda``; use
``--device cpu`` on a host without one).
"""
from __future__ import annotations

import argparse
import logging
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

from nsgp_repre_tpu_torch.engine.runner import NullSpaceRunner  # noqa: E402
from nsgp_repre_tpu_torch.utils.config import load_config  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector with the PyTorch port")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--work-dir")
    p.add_argument(
        "--out",
        default=None,
        help="pickle per-image raw detections to this path "
        "(reference tools/test.py --out / DumpDetResults)",
    )
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> float:
    """Validate the checkpoint; returns its mAP."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    cfg = load_config(args.config, overrides=args.cfg_options)
    if args.work_dir:
        cfg["work_dir"] = args.work_dir
    cfg["load_from"] = args.checkpoint
    cfg["is_trained"] = True
    runner = NullSpaceRunner(cfg, device=args.device)
    mAP = runner.val(dump_to=args.out)
    print(f"mAP: {mAP:.4f}")
    return mAP


if __name__ == "__main__":
    main()
