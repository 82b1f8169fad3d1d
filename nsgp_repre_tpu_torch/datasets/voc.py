"""Task-filtered VOC (XML-style) dataset.

Counterpart of nsgp_repre_tpu/datasets/voc.py, the port's own numpy
copy. Parity targets:
- XMLTask base: mmdet/datasets/xml_style_task.py:14 — keep only
  instances whose label ∈ [task_split[task_id-1], task_split[task_id])
  (:167-168), assert 0 < task_id < len(task_split) (:34), drop images
  left with no instances (:69-70, filter_data :171-194);
- VOCTask: mmdet/datasets/voc_task.py:7 (class list :10-22);
- filter_cfg: filter_empty_gt + bbox_min_size=5 (dataset configs).

Host-side: produces numpy records; batching lives in loader.py.
"""
from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOCTaskDataset:
    """VOC2007/2012-format dataset with incremental task filtering."""

    CLASSES = VOC_CLASSES

    def __init__(
        self,
        data_root: str,
        ann_file: str,
        sub_data_root: str = "VOC2007/",
        task_split: Sequence[int] = (0, 20),
        task_id: int = 1,
        test_mode: bool = False,
        bbox_min_size: float = 5.0,
        filter_empty_gt: bool = True,
        img_subdir: str = "JPEGImages",
        ann_subdir: str = "Annotations",
        classes: Sequence[str] = None,
    ):
        assert 0 < task_id < len(task_split), (
            f"task_id {task_id} out of range for split {task_split}"
        )
        self.classes = tuple(classes) if classes else self.CLASSES
        self.cat2label: Dict[str, int] = {c: i for i, c in enumerate(self.classes)}
        self.data_root = data_root
        self.sub_root = osp.join(data_root, sub_data_root)
        self.task_split = list(task_split)
        self.task_id = task_id
        self.lo = task_split[task_id - 1]
        self.hi = task_split[task_id]
        self.test_mode = test_mode
        self.bbox_min_size = bbox_min_size
        self.filter_empty_gt = filter_empty_gt
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir

        with open(osp.join(data_root, ann_file)) as f:
            ids = [line.strip() for line in f if line.strip()]
        self.records = self._load(ids)

    def _load(self, ids: List[str]) -> List[dict]:
        records = []
        for img_id in ids:
            xml_path = osp.join(self.sub_root, self.ann_subdir, f"{img_id}.xml")
            tree = ET.parse(xml_path)
            root = tree.getroot()
            fname = root.findtext("filename") or f"{img_id}.jpg"
            size = root.find("size")
            width = int(size.findtext("width"))
            height = int(size.findtext("height"))

            boxes, labels, difficult = [], [], []
            for obj in root.findall("object"):
                name = obj.findtext("name")
                if name not in self.cat2label:
                    continue
                label = self.cat2label[name]
                # task filter (xml_style_task.py:167-168)
                if not (self.lo <= label < self.hi):
                    continue
                bnd = obj.find("bndbox")
                # VOC boxes are 1-indexed inclusive
                x1 = float(bnd.findtext("xmin")) - 1
                y1 = float(bnd.findtext("ymin")) - 1
                x2 = float(bnd.findtext("xmax")) - 1
                y2 = float(bnd.findtext("ymax")) - 1
                if not self.test_mode and self.bbox_min_size > 0:
                    if (x2 - x1) < self.bbox_min_size or (y2 - y1) < self.bbox_min_size:
                        continue
                boxes.append([x1, y1, x2, y2])
                labels.append(label)
                difficult.append(int(obj.findtext("difficult") or 0))

            if not self.test_mode and self.filter_empty_gt and not boxes:
                continue  # drop images with no in-task instances (:69-70)
            records.append(
                dict(
                    img_id=img_id,
                    img_path=osp.join(self.sub_root, self.img_subdir, fname),
                    width=width,
                    height=height,
                    boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int32),
                    difficult=np.asarray(difficult, np.int32),
                )
            )
        return records

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> dict:
        return self.records[i]
