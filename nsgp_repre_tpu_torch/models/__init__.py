"""Detector modules (nn.Module counterparts of the flax modules)."""
