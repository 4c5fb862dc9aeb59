"""Backend selection as a plan property.

:class:`Backend` ``kind`` is ``"torch"`` (the plain PyTorch versions, on any
device -- the twin of the JAX package's ``"jnp"``) or ``"cuda"`` (the
hand-written kernels -- the twin of ``"pallas"``).  A ``"cuda"`` plan routes
every LIF, every spike GEMM (linears and im2col 3x3 convs) and every
quadratic-ordering SSA through the kernel wrappers, which launch the CUDA
kernel for a CUDA tensor and take the plain version only for a CPU tensor.

``packed`` carries the inter-layer spikes bit-packed along time
(``repro_torch.core.packing``): LIF epilogues emit words, the IAND residual
is a bitwise ``skip & ~s``.  On ``"cuda+packed"`` the words are the operands
of the packed GEMM and packed SSA kernels (:attr:`Backend.closes_ssa_boundary`);
on ``"torch+packed"`` they are unpacked at each op boundary and the plain
dense ops run -- the JAX package's ``"jnp+packed"`` route.

Every compute op of the deploy plan goes through this module, so a plan's
kernel route is a property of its Backend, with no exemptions at call sites.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import nn as cnn
from repro_torch.core import packing
from repro_torch.core.lif import lif as _lif_dispatch


@dataclass(frozen=True)
class Backend:
    kind: str = "cuda"                 # "torch" | "cuda"
    packed: bool = False               # bit-packed inter-layer spikes

    def __post_init__(self):
        if self.kind not in ("torch", "cuda"):
            raise ValueError(f"unknown backend kind: {self.kind}")

    @property
    def use_kernels(self) -> bool:
        return self.kind == "cuda"

    @property
    def closes_ssa_boundary(self) -> bool:
        """True when packed q/k/v words feed the packed SSA kernel directly:
        no unpack at the attention boundary."""
        return self.packed and self.kind == "cuda"


def resolve(spec) -> Backend:
    """Coerce a user-facing spec into a Backend: Backend | "torch" | "cuda" |
    "torch+packed" | "cuda+packed"."""
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, str):
        kind, sep, rest = spec.partition("+")
        flags = rest.split("+") if sep else []
        if sep and (not kind or "" in flags):
            raise ValueError(f"malformed backend spec: {spec!r}")
        if "sparse" in flags:
            raise NotImplementedError(
                f"the sparse datapath ({spec!r}) is not ported yet (ROADMAP "
                "queue item 9)")
        bad = sorted(set(flags) - {"packed"})
        if bad:
            raise ValueError(f"unknown backend flag(s): {bad} in {spec!r}")
        return Backend(kind, packed=bool(flags))
    raise TypeError(f"cannot resolve backend from {spec!r}")


def lif_apply(backend: Backend, drive: torch.Tensor, *, theta, lam, schedule,
              chain_len, iand_skip=None, reset: str = "hard", pack_output: bool = False):
    """Route a LIF (optionally with the fused IAND epilogue) through the
    unified neuron dispatch on this backend.  With ``pack_output`` the spike
    train returns bit-packed (and ``iand_skip`` must be packed)."""
    return _lif_dispatch(drive, theta=theta, lam=lam, reset=reset,
                         schedule=schedule, chain_len=chain_len,
                         use_kernel=backend.use_kernels, iand_skip=iand_skip,
                         pack_output=pack_output)


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


def ssa_apply_packed(backend: Backend, qp: packing.PackedSpikes,
                     kp: packing.PackedSpikes, vp: packing.PackedSpikes, *,
                     scale: float, ordering: str = "quadratic",
                     causal: bool = False) -> torch.Tensor:
    """Spiking self-attention on packed q/k/v trains (words (W, B, H, N, Dh))
    -> dense drive (T, B, H, N, Dh).

    Under :attr:`Backend.closes_ssa_boundary` the words are the attention
    operands: the quadratic ordering through the packed SSA kernel, the
    linear ordering through the shift-and-mask ``ssa_linear_packed``.
    Otherwise the trains are unpacked at the op boundary and the dense route
    runs."""
    if ordering == "quadratic" and backend.closes_ssa_boundary:
        from repro_torch.kernels.spiking_attention.ops import packed_ssa_op

        return packed_ssa_op(qp.words, kp.words, vp.words, t=qp.t, scale=scale,
                             causal=causal)
    if ordering == "linear" and backend.closes_ssa_boundary:
        from repro_torch.core.spiking_attention import ssa_linear_packed

        return ssa_linear_packed(qp.words, kp.words, vp.words, t=qp.t, scale=scale,
                                 causal=causal)
    q, k, v = (packing.unpack(p) for p in (qp, kp, vp))
    return ssa_apply(backend, q, k, v, scale=scale, ordering=ordering, causal=causal)


def _kernel_takes_packed(backend: Backend, xp: packing.PackedSpikes) -> bool:
    """Feed words straight to the packed GEMM kernel?  Needs the kernel route
    and a single-word train (T <= 32); longer trains unpack and take the
    dense GEMM kernel, as in the JAX package."""
    return backend.use_kernels and xp.words.shape[0] == 1


def linear_apply_packed(backend: Backend, p, xp: packing.PackedSpikes) -> torch.Tensor:
    """Folded linear on a packed spike train (W, ..., Din) -> dense drive
    (T, ..., Dout): the words are the GEMM operand on the kernel route,
    otherwise the train is unpacked at the op boundary."""
    lead = xp.elem_shape[:-1]
    d_in = xp.elem_shape[-1]
    if _kernel_takes_packed(backend, xp):
        from repro_torch.kernels.spike_matmul.ops import packed_spike_matmul_op

        y = packed_spike_matmul_op(xp.words[0].reshape(-1, d_in), p["w"], t=xp.t)
        y = y.reshape((xp.t,) + lead + (p["w"].shape[1],))
        if "b" in p:
            y = y + p["b"]
        return y
    x = packing.unpack(xp)                           # (T, ..., Din)
    y2d = linear_apply(backend, p, x.reshape(-1, d_in))
    return y2d.reshape((xp.t,) + lead + (-1,))


def conv3x3_apply_packed(backend: Backend, p, xp: packing.PackedSpikes) -> torch.Tensor:
    """Folded 3x3 SAME conv on packed spikes (W, N, H, Wd, C) -> dense drive
    (T, N, H, Wd, Cout)."""
    if _kernel_takes_packed(backend, xp):
        from repro_torch.kernels.spike_matmul.ops import packed_conv3x3_op

        y = packed_conv3x3_op(xp.words[0], p["w"], t=xp.t)
        if "b" in p:
            y = y + p["b"]
        return y
    x = packing.unpack(xp)                           # (T, N, H, Wd, C)
    t, n = x.shape[0], x.shape[1]
    y = conv3x3_apply(backend, p, x.reshape((t * n,) + tuple(x.shape[2:])))
    return y.reshape((t, n) + tuple(y.shape[1:]))
