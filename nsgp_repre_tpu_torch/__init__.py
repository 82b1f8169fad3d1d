"""PyTorch and CUDA port of nsgp_repre_tpu for one NVIDIA H100.

The layout mirrors the JAX package (structures/, ops/, models/, engine/,
apis/, utils/, datasets/) so each module's counterpart is easy to find.
The JAX package is the reference; this package imports nothing from it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor every hand-written kernel's wrapper runs its plain
PyTorch version, on a CUDA tensor it launches the kernel or raises.
"""
__version__ = "0.1.0"
