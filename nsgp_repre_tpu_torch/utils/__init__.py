"""Config loading, checkpoints and the JAX-to-torch weight bridge."""
