"""A cell cut to a size a CPU test run holds: the same files, with a
one-block-per-stage backbone, small sampling budgets, two 96x128 images
and the program in float32 (the port's plain PyTorch paths)."""
from __future__ import annotations

from portbench import common

OVERRIDES = {"backbone_blocks": [1, 1, 1, 1], "rpn_nms_pre": 64, "rpn_max_per_img": 32,
             "rpn_num": 16, "rcnn_num": 16, "max_per_img": 8, "compute_dtype": "float32"}


def tiny_cell(name: str) -> dict:
    cell = common.load_json("workloads", name)
    cfg = common.load_json("configs", cell["config"])
    tr = common.load_json("traffic", cell["traffic"])
    cfg.update(OVERRIDES)
    cfg["program_overrides"] = {k: tuple(v) if isinstance(v, list) else v for k, v in OVERRIDES.items()}
    tr.update({"batch": 2, "image_hw": [96, 128], "canvas": [96, 128], "gt_counts": [1, 3],
               "gt_slots": 8, "distinct_batches": 3})
    if "replay_prototypes" in tr:
        tr["replay_prototypes"] = 30
    if "gt_mask_size" in tr:
        tr["gt_mask_size"] = 16
    cell.update(config=cfg, traffic=tr, trace_steps=2)
    return cell
