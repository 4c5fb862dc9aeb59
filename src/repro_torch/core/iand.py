"""Spike residual connectives.

The paper replaces Spikformer's residual *addition* (which produces non-spike
values 0/1/2) with the element-wise IAND of SEW-ResNet:

    IAND(x, y) = x AND (NOT y) = x * (1 - y)

With both operands binary the output stays binary.  ``residual_add`` is the
Spikformer baseline (the Table-I comparison).
"""

from __future__ import annotations

import torch


def iand(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Element-wise IAND: ``x * (1 - y)``. Binary in -> binary out."""
    return x * (1.0 - y)


def residual_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spikformer baseline residual (non-spike output: values may reach 2)."""
    return x + y


def connective(kind: str):
    if kind == "iand":
        return iand
    if kind == "add":
        return residual_add
    raise ValueError(f"unknown residual connective: {kind}")


def is_binary(x: torch.Tensor, atol: float = 0.0) -> bool:
    """Every element of ``x`` is 0 or 1 (the spike invariant)."""
    return bool(((x.abs() <= atol) | ((x - 1.0).abs() <= atol)).all())
