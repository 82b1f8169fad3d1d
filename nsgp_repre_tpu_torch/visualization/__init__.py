from .visualizer import DetLocalVisualizer, draw_detections

__all__ = ["draw_detections", "DetLocalVisualizer"]
