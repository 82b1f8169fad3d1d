"""DIOR remote-sensing dataset (VOC XML format).

Counterpart of nsgp_repre_tpu/datasets/dior.py. Parity target: mmdet/datasets/dior_task.py:7 — same XMLTask machinery as
VOC with the 20 DIOR classes and JPEG images under ``JPEGImages-trainval``.
"""
from __future__ import annotations

from .voc import VOCTaskDataset

DIOR_CLASSES = (
    "airplane", "airport", "baseballfield", "basketballcourt", "bridge",
    "chimney", "dam", "expressway-service-area", "expressway-toll-station",
    "golffield", "groundtrackfield", "harbor", "overpass", "ship",
    "stadium", "storagetank", "tenniscourt", "trainstation", "vehicle",
    "windmill",
)


class DIORTaskDataset(VOCTaskDataset):
    CLASSES = DIOR_CLASSES
