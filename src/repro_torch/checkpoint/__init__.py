"""Checkpoints in the JAX package's on-disk layout, readable by either package."""
