#!/usr/bin/env python
"""Train one task of the incremental pipeline with the PyTorch port.

The CLI of tools/train.py: a config positional, ``--work-dir``,
``--resume`` and ``--cfg-options`` dotted overrides; the runner class
comes from the config's ``runner_type`` ('BRNullSpaceRunner' |
'TeacherRunner'). ``--device`` names the device (default ``cuda``; the
run stops with an error when there is no CUDA device, use
``--device cpu`` to train on the CPU).

    python tools/torch_train.py cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_1.py \\
        --work-dir work_dirs/15_5_1
"""
from __future__ import annotations

import argparse
import logging
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

from nsgp_repre_tpu_torch.engine.runner import NullSpaceRunner, TeacherRunner  # noqa: E402
from nsgp_repre_tpu_torch.utils.config import load_config  # noqa: E402

RUNNERS = {
    "BRNullSpaceRunner": NullSpaceRunner,
    "TeacherRunner": TeacherRunner,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector (one task) with the PyTorch port")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", help="directory to save logs and models")
    p.add_argument("--resume", action="store_true")
    p.add_argument(
        "--cfg-options",
        nargs="+",
        default=None,
        help="override config entries, e.g. task_id=2 train_cfg.max_epochs=1",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None):
    """Train the task; returns the runner."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    cfg = load_config(args.config, overrides=args.cfg_options)
    if args.work_dir:
        cfg["work_dir"] = args.work_dir
    elif "work_dir" not in cfg:
        cfg["work_dir"] = osp.join("./work_dirs", osp.splitext(osp.basename(args.config))[0])
    cfg["resume"] = args.resume
    runner = RUNNERS[cfg.get("runner_type", "BRNullSpaceRunner")](cfg, device=args.device)
    runner.train()
    return runner


if __name__ == "__main__":
    main()
