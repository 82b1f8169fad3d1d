"""Task-filtered COCO dataset (self-contained json parsing; pycocotools
is not required for loading).

Counterpart of nsgp_repre_tpu/datasets/coco.py, the port's own numpy
copy. Parity target: mmdet/datasets/coco_task.py:14 — keep categories whose
contiguous label ∈ [task_split[task_id-1], task_split[task_id))
(``keep_cat``, :100-101); drop out-of-task annotations (:176-178); keep
only images with in-task instances (filter_data :195-230). The standard
mmdet filters also apply: crowd boxes ignored, min size filtering.
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List, Sequence

import numpy as np

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


class CocoTaskDataset:
    CLASSES = COCO_CLASSES

    def __init__(
        self,
        data_root: str,
        ann_file: str,
        img_prefix: str = "",
        task_split: Sequence[int] = (0, 80),
        task_id: int = 1,
        test_mode: bool = False,
        filter_empty_gt: bool = True,
        min_size: float = 32.0,
    ):
        assert 0 < task_id < len(task_split)
        self.task_split = list(task_split)
        self.task_id = task_id
        self.lo = task_split[task_id - 1]
        self.hi = task_split[task_id]
        self.test_mode = test_mode

        with open(osp.join(data_root, ann_file)) as f:
            coco = json.load(f)

        # category id → contiguous label, ordered by the dataset classes
        cats = {c["name"]: c["id"] for c in coco["categories"]}
        self.cat_id2label: Dict[int, int] = {}
        for label, name in enumerate(self.CLASSES):
            if name in cats:
                self.cat_id2label[cats[name]] = label
        self.label2cat_id = {v: k for k, v in self.cat_id2label.items()}

        anns_by_img: Dict[int, List[dict]] = {}
        for a in coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.records = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            boxes, labels, ignore = [], [], []
            for a in anns:
                if a["category_id"] not in self.cat_id2label:
                    continue
                label = self.cat_id2label[a["category_id"]]
                # task filter (coco_task.py:176-178)
                if not (self.lo <= label < self.hi):
                    continue
                x, y, w, h = a["bbox"]
                if w < 1 or h < 1 or a.get("area", w * h) <= 0:
                    continue
                if a.get("iscrowd", 0):
                    ignore.append([x, y, x + w, y + h])
                    continue
                boxes.append([x, y, x + w, y + h])
                labels.append(label)
            if not test_mode and filter_empty_gt and not boxes:
                continue  # filter_data (:195-230)
            if not test_mode and min(img["width"], img["height"]) < min_size:
                continue
            self.records.append(
                dict(
                    img_id=img["id"],
                    img_path=osp.join(data_root, img_prefix, img["file_name"]),
                    width=img["width"],
                    height=img["height"],
                    boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int32),
                    difficult=np.zeros(len(labels), np.int32),
                    ignore_boxes=np.asarray(ignore, np.float32).reshape(-1, 4),
                )
            )

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]
