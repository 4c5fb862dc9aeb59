"""Logical-axis sharding rules, fault-tolerance bookkeeping and gradient
compression (the JAX package's ``repro.distributed``, in PyTorch)."""
