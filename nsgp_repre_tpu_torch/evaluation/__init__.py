"""VOC and COCO detection metrics on the host (numpy)."""
from .coco_map import eval_coco_map
from .voc_map import eval_voc_map

__all__ = ["eval_voc_map", "eval_coco_map"]
