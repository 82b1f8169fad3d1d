"""Data parallelism on torch.distributed (parallel/mesh.py)."""
