"""Datasets (VOC, DIOR, COCO), the batch loader and the prefetcher."""
