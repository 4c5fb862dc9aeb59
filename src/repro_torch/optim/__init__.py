"""Optimizers (AdamW, Adafactor) over params trees, as the JAX package's ``optim``."""
