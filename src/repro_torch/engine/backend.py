"""Backend selection as a plan property.

:class:`Backend` ``kind`` is ``"torch"`` (the plain PyTorch versions, on any
device -- the twin of the JAX package's ``"jnp"``) or ``"cuda"`` (the
hand-written kernels -- the twin of ``"pallas"``).  A ``"cuda"`` plan routes
every LIF, every spike GEMM (linears and im2col 3x3 convs) and every
quadratic-ordering SSA through the kernel wrappers, which launch the CUDA
kernel for a CUDA tensor and take the plain version only for a CPU tensor.

Every compute op of the deploy plan goes through this module, so a plan's
kernel route is a property of its Backend, with no exemptions at call sites.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import nn as cnn
from repro_torch.core.lif import lif as _lif_dispatch


@dataclass(frozen=True)
class Backend:
    kind: str = "cuda"                 # "torch" | "cuda"

    def __post_init__(self):
        if self.kind not in ("torch", "cuda"):
            raise ValueError(f"unknown backend kind: {self.kind}")

    @property
    def use_kernels(self) -> bool:
        return self.kind == "cuda"


def resolve(spec) -> Backend:
    """Coerce a user-facing spec into a Backend: Backend | "torch" | "cuda"."""
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, str):
        return Backend(spec)
    raise TypeError(f"cannot resolve backend from {spec!r}")


def lif_apply(backend: Backend, drive: torch.Tensor, *, theta, lam, schedule,
              chain_len, iand_skip=None, reset: str = "hard") -> torch.Tensor:
    """Route a LIF (optionally with the fused IAND epilogue) through the
    unified neuron dispatch on this backend."""
    return _lif_dispatch(drive, theta=theta, lam=lam, reset=reset,
                         schedule=schedule, chain_len=chain_len,
                         use_kernel=backend.use_kernels, iand_skip=iand_skip)


def linear_apply(backend: Backend, p, x2d: torch.Tensor) -> torch.Tensor:
    """Folded linear (w, b) on tick-folded 2-D activations."""
    if backend.use_kernels:
        from repro_torch.kernels.spike_matmul.ops import spike_matmul_op

        y = spike_matmul_op(x2d, p["w"])
    else:
        y = x2d @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def conv3x3_apply(backend: Backend, p, x: torch.Tensor) -> torch.Tensor:
    """Folded 3x3 SAME conv on (N, H, W, C) spikes."""
    if backend.use_kernels:
        from repro_torch.kernels.spike_matmul.ops import conv3x3_op

        y = conv3x3_op(x, p["w"])
        if "b" in p:
            y = y + p["b"]
        return y
    return cnn.conv_apply(p, x)


def ssa_apply(backend: Backend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *, scale: float, ordering: str = "quadratic",
              causal: bool = False) -> torch.Tensor:
    """Spiking self-attention on this backend. q/k/v: (T, B, H, N, Dh) binary
    spikes -> (T, B, H, N, Dh) f32 drive.  The kernel is the quadratic N^2
    dataflow; the linear ordering Q(K^T V) always takes the plain einsum."""
    if ordering == "quadratic" and backend.use_kernels:
        from repro_torch.kernels.spiking_attention.ops import ssa_op

        return ssa_op(q, k, v, scale=scale, causal=causal)
    from repro_torch.core.spiking_attention import ssa

    return ssa(q, k, v, scale=scale, ordering=ordering, causal=causal)
