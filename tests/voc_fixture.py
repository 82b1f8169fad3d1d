"""A synthetic VOC2007 tree and runner configs for the port's runner tests.

numpy only (no JAX), so the card tests can use it on a host without
JAX. Images are binary PPM, written without an image library; cv2 and
PIL read PPM by its content. The fixture is the one of
tests/test_pipeline.py: 8 landscape 80x60 images, two boxes each, of
classes 0-3.
"""
from __future__ import annotations

import os.path as osp
from pathlib import Path
from typing import Sequence

import numpy as np

from nsgp_repre_tpu_torch.datasets.voc import VOC_CLASSES

VOC_XML = """<annotation>
  <filename>{fname}</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>
"""
OBJ_XML = """<object>
    <name>{cls}</name><difficult>{difficult}</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>"""


def write_ppm(path, img: np.ndarray) -> None:
    """An RGB uint8 HWC image as binary PPM (P6)."""
    h, w = img.shape[:2]
    Path(path).write_bytes(f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(img).tobytes())


def write_voc(root, images: Sequence[np.ndarray], objects: Sequence[Sequence[tuple]],
              splits=("trainval", "test"), classes: Sequence[str] = VOC_CLASSES) -> str:
    """A VOC2007 tree under ``root``: image i is ``images[i]`` (PPM) with
    the objects ``(class index, x1, y1, x2, y2[, difficult])`` (1-indexed
    VOC corners, class names from ``classes``); every split lists every
    image. Returns ``root``."""
    base = Path(root) / "VOC2007"
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    ids = []
    for i, (img, objs) in enumerate(zip(images, objects)):
        name = f"{i:06d}"
        write_ppm(base / "JPEGImages" / f"{name}.ppm", img)
        xml_objs = [OBJ_XML.format(cls=classes[o[0]], x1=o[1], y1=o[2], x2=o[3], y2=o[4],
                                   difficult=int(o[5]) if len(o) > 5 else 0) for o in objs]
        (base / "Annotations" / f"{name}.xml").write_text(VOC_XML.format(
            fname=f"{name}.ppm", w=img.shape[1], h=img.shape[0], objects="\n".join(xml_objs)))
        ids.append(name)
    for split in splits:
        (base / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(ids))
    return str(root)


def make_voc(root) -> str:
    """tests/test_pipeline.py's fixture: 8 images of seeded noise, 80x60
    (one landscape canvas), each a box of class i % 4 and one of 2 + i % 2."""
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (60, 80, 3), np.uint8) for _ in range(8)]
    objects = [[(i % 4, 8, 8, 40, 40), (2 + i % 2, 30, 20, 70, 50)] for i in range(8)]
    return write_voc(root, images, objects)


def make_cfg(voc_root, work_root, task_id, split=(0, 2, 4)) -> dict:
    """tests/test_pipeline.py's make_cfg, as a plain dict (wrap it in
    either package's Config). ``ignore_keys`` also skips the five 2304-
    and one 4608-input layers (layer3/layer4's 3x3 convs, the FPN output
    convs): their float64 decompositions would take ~17 s of every task-2
    runner's __init__ here (tests/test_torch_task_end.py makes the same
    cut; chip_smoke.py decomposes all of R-50 on the card's host)."""
    split = list(split)
    ds = dict(
        type="VOCTask",
        data_root=voc_root,
        ann_file="VOC2007/ImageSets/Main/trainval.txt",
        data_prefix=dict(sub_data_root="VOC2007/"),
        task_split=split,
        task_id=task_id,
    )
    val_ds = dict(
        type="VOCTask",
        data_root=voc_root,
        ann_file="VOC2007/ImageSets/Main/test.txt",
        data_prefix=dict(sub_data_root="VOC2007/"),
        task_split=[0, split[task_id]],
        task_id=1,
        test_mode=True,
    )
    return dict(
        task_id=task_id,
        train_task_split=split,
        offset=0.0,
        ignore_keys=["rpn", "roi_head", "backbone/layer3_0/conv2", "backbone/layer4_0/conv2",
                     "neck/fpn_conv"],
        previous_dir=osp.join(work_root, f"task_{task_id - 1}"),
        ckpt_keywords="best",
        max_prototype=3,
        rr_thresh=[0.05, 0.1],  # low thresholds so pseudo-labels flow
        img_scale=(100, 60),
        seed=0,
        model=dict(
            type="FasterRCNNRoIReplay",
            backbone=dict(stage_blocks=(1, 1, 1, 1)),
            roi_head=dict(
                type="StandardMultiPrototypeReplayHead",
                bbox_head=dict(num_classes=4),
            ),
            train_cfg=dict(
                rpn=dict(sampler=dict(num=16)),
                rpn_proposal=dict(nms_pre=64, max_per_img=32),
                rcnn=dict(sampler=dict(num=16)),
            ),
            test_cfg=dict(rcnn=dict(max_per_img=8)),
        ),
        train_dataloader=dict(batch_size=2, dataset=ds),
        val_dataloader=dict(batch_size=2, dataset=val_ds),
        train_cfg=dict(max_epochs=1),
        optim_wrapper=dict(optimizer=dict(type="SGDNSCL", lr=0.001)),
        val_evaluator=dict(type="VOCMetric", eval_mode="11points"),
        work_dir=osp.join(work_root, f"task_{task_id}"),
    )


def write_cfg(cfg: dict, path) -> str:
    """A config dict as a python config file (one assignment per key)."""
    Path(path).write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return str(path)
