"""User-facing inference API."""
from .inference import DetInferencer, inference_detector, init_detector

__all__ = ["init_detector", "inference_detector", "DetInferencer"]
