"""RMSNorm, the one layer of the JAX package's ``models/layers.py`` that the
spiking LM uses (the rest comes with the generic LM substrate)."""

from __future__ import annotations

import torch


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_raw(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in f32 and
    cast back to ``x``'s dtype, written as the reference writes it.  The
    deploy plan's head and :func:`rmsnorm_apply` share it.  Against XLA on
    the CPU, ``torch.rsqrt`` and the mean's order may differ in the last
    bit."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dtype)


def rmsnorm_apply(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as a layer of the oracle view and of the embedding fold:
    :func:`rmsnorm_raw` inside a ``record_function`` region named
    ``rmsnorm_apply``, which ``engine.analysis.rmsnorm_op_count`` counts (the
    JAX package jits it to count it in a jaxpr by name)."""
    with torch.profiler.record_function("rmsnorm_apply"):
        return rmsnorm_raw(p, x, eps=eps)
