"""Leaky integrate-and-fire neurons with parallel tick-batching.

Paper semantics (Sec. II): threshold theta = 0.5, leak lambda = 0.25 (a power
of two -> a shift in the ASIC), hard reset to zero on fire:

    u_t = lam * v_{t-1} + I_t
    s_t = H(u_t - theta)
    v_t = u_t * (1 - s_t)          (hard reset; soft reset: v_t = u_t - theta*s_t)

``lif_serial`` steps the membrane through a loop over T (the serial
tick-batching baseline); ``lif_parallel`` is the paper's unrolled chain with
the reconfigurable ``chain_len`` mux (T slots form ``T // chain_len``
independent chains whose membranes restart from zero).  Both are bit-equal.

Training differentiates through the Heaviside with a surrogate gradient
(:class:`SurrogateSpike`: boxcar by default, or the ATan derivative), so both
plain versions are differentiable by autograd; the ``use_kernel`` route
differentiates through the LIF backward kernel (boxcar, width 1).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import packing

THETA_DEFAULT = 0.5
LAM_DEFAULT = 0.25


class SurrogateSpike(torch.autograd.Function):
    """Heaviside step with a surrogate derivative.

    Forward: ``(x >= 0)`` in ``x.dtype``.  Backward: boxcar
    ``[|x| < width/2] / width`` or the ATan derivative ``1 / (1 + (pi*x)^2)``,
    times the incoming gradient."""

    @staticmethod
    def forward(ctx, x, width, kind):
        if kind not in ("boxcar", "atan"):
            raise ValueError(f"unknown surrogate kind: {kind}")
        ctx.save_for_backward(x)
        ctx.width, ctx.kind = width, kind
        return (x >= 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        if ctx.kind == "boxcar":
            surr = (x.abs() < (ctx.width / 2.0)).to(x.dtype) / ctx.width
        else:
            surr = 1.0 / (1.0 + (math.pi * x) ** 2)
        return surr * grad, None, None


def surrogate_spike(x: torch.Tensor, width: float = 1.0,
                    kind: str = "boxcar") -> torch.Tensor:
    """``(x >= 0)`` with the surrogate derivative of :class:`SurrogateSpike`."""
    return SurrogateSpike.apply(x, width, kind)


def _step(v, i_t, *, theta, lam, reset, surrogate):
    u = lam * v + i_t
    s = surrogate_spike(u - theta, kind=surrogate)
    v = u * (1.0 - s) if reset == "hard" else u - theta * s
    return v, s


def lif_serial(drive: torch.Tensor, *, theta: float = THETA_DEFAULT,
               lam: float = LAM_DEFAULT, reset: str = "hard",
               v0: torch.Tensor | None = None,
               surrogate: str = "boxcar") -> torch.Tensor:
    """Serial tick-batching LIF. ``drive``: (T, ...). Returns spikes (T, ...).
    ``v0``: the membrane before the first step (default zeros)."""
    v = torch.zeros_like(drive[0]) if v0 is None else v0
    spikes = []
    for i_t in drive:
        v, s = _step(v, i_t, theta=theta, lam=lam, reset=reset, surrogate=surrogate)
        spikes.append(s)
    return _stack(spikes, drive)


def _stack(spikes, drive):
    """The steps' spikes as (T, ...); an empty (0, ...) train for T = 0, as a
    scan over no steps gives."""
    return torch.stack(spikes) if spikes else drive.new_zeros(drive.shape)


def lif_serial_with_state(drive: torch.Tensor, v0: torch.Tensor, *,
                          theta: float = THETA_DEFAULT, lam: float = LAM_DEFAULT,
                          reset: str = "hard") -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`lif_serial` from the membrane ``v0``, but also returns the
    final membrane (for serving): ``(spikes (T, ...), v_T)``.  A train split
    at any step and resumed from the returned membrane gives the same spikes
    and membrane.  Forward only (the spike is a plain Heaviside)."""
    v, spikes = v0, []
    for i_t in drive:
        u = lam * v + i_t
        s = (u >= theta).to(drive.dtype)
        v = u * (1.0 - s) if reset == "hard" else u - theta * s
        spikes.append(s)
    return _stack(spikes, drive), v


def lif_parallel(drive: torch.Tensor, *, theta: float = THETA_DEFAULT,
                 lam: float = LAM_DEFAULT, reset: str = "hard",
                 chain_len: int | None = None, surrogate: str = "boxcar",
                 iand_skip: torch.Tensor | None = None) -> torch.Tensor:
    """Fully parallel tick-batching LIF with an unrolled membrane chain.

    ``drive``: (T, ...).  ``chain_len`` (default T) must divide T.
    ``iand_skip``: optional spikes of the same shape; if given, the IAND
    residual ``skip * (1 - s)`` is applied as the epilogue.  This is the
    plain version of the ``lif_parallel`` CUDA kernels: its forward of K1,
    and its autograd VJP (``surrogate="boxcar"``) of the backward kernel.
    """
    t_total = drive.shape[0]
    chain_len = chain_len or t_total
    if t_total % chain_len:
        raise ValueError(f"T={t_total} not divisible by chain_len={chain_len}")
    spikes = []
    v = torch.zeros_like(drive[0])
    for t in range(t_total):
        if t % chain_len == 0:   # mux: chain boundary -> fresh membrane
            v = torch.zeros_like(v)
        v, s = _step(v, drive[t], theta=theta, lam=lam, reset=reset,
                     surrogate=surrogate)
        spikes.append(s)
    out = torch.stack(spikes)
    if iand_skip is not None:
        out = iand_skip * (1.0 - out)
    return out


def lif(drive: torch.Tensor, *, theta: float = THETA_DEFAULT,
        lam: float = LAM_DEFAULT, reset: str = "hard",
        schedule: str = "parallel", chain_len: int | None = None,
        surrogate: str = "boxcar", use_kernel: bool = False, iand_skip=None,
        pack_output: bool = False, pack_occupancy: bool = False):
    """THE neuron dispatch: every LIF of the model and the deploy engine goes
    through this entry point.

    ``use_kernel=True`` routes through the ``lif_parallel`` kernel wrappers
    (the CUDA kernel for a CUDA tensor, its plain version for a CPU tensor);
    otherwise the plain unrolled chain runs.  Both are differentiable: the
    plain chain by autograd with the ``surrogate`` derivative, the kernel
    route through the LIF backward kernel, whose surrogate is the boxcar of
    width 1 (another ``surrogate`` there is a ValueError).  ``iand_skip``
    fuses the AND-NOT residual ``skip * (1 - s)`` into the neuron's output
    stage on every route; the kernel route's fused epilogue, like its packed
    forms, is forward-only and raises where a gradient is asked of it.

    ``pack_output=True`` returns the spike train bit-packed along time as a
    :class:`repro_torch.core.packing.PackedSpikes` instead of a dense (T, ...)
    tensor; the kernel route packs inside the kernel's epilogue, so dense
    spikes never reach device memory.  With ``pack_output``, ``iand_skip``
    must itself be a ``PackedSpikes`` -- the residual becomes the bitwise
    ``skip & ~spikes`` on words -- and a ``PackedSpikes`` skip without
    ``pack_output`` is a TypeError.

    ``pack_occupancy=True`` (requires ``pack_output``) attaches the per-tile
    popcount occupancy map (``packing.occupancy_map``) of the FINAL words,
    IAND applied, to the returned train -- the sparse datapath's skip index.
    The kernel route counts it in the pack kernel's epilogue.
    """
    if pack_occupancy and not pack_output:
        raise ValueError("pack_occupancy=True requires pack_output=True")
    if pack_output and iand_skip is not None:
        if not isinstance(iand_skip, packing.PackedSpikes):
            raise TypeError("pack_output=True requires a PackedSpikes iand_skip")
        if iand_skip.t != drive.shape[0]:
            raise ValueError(f"time-step mismatch: drive T={drive.shape[0]}, "
                             f"iand_skip t={iand_skip.t}")
    if not pack_output and isinstance(iand_skip, packing.PackedSpikes):
        raise TypeError("PackedSpikes iand_skip requires pack_output=True")

    def _pack(out):
        packed = packing.pack(out)
        if iand_skip is not None:
            packed = packing.iand(iand_skip, packed)
        return packed.with_occupancy() if pack_occupancy else packed

    if schedule == "serial":
        out = lif_serial(drive, theta=theta, lam=lam, reset=reset, surrogate=surrogate)
        if pack_output:
            return _pack(out)
        return out if iand_skip is None else iand_skip * (1.0 - out)
    if schedule != "parallel":
        raise ValueError(f"unknown schedule: {schedule}")
    if use_kernel:
        from repro_torch.kernels.lif_parallel import ops as lif_ops

        if surrogate != "boxcar":
            raise ValueError(f"the LIF kernel route's surrogate is the boxcar, "
                             f"not {surrogate!r}")
        kw = dict(theta=theta, lam=lam, reset=reset, chain_len=chain_len)
        if pack_output:
            kw["occupancy"] = pack_occupancy
            res = (lif_ops.lif_pack_op(drive, **kw) if iand_skip is None
                   else lif_ops.lif_iand_pack_op(drive, iand_skip.words, **kw))
            words, occ = res if pack_occupancy else (res, None)
            return packing.PackedSpikes(words=words, t=drive.shape[0], occ=occ)
        if iand_skip is not None:
            return lif_ops.lif_iand_op(drive, iand_skip, **kw)
        return lif_ops.lif_parallel_op(drive, **kw)
    if pack_output:
        return _pack(lif_parallel(drive, theta=theta, lam=lam, reset=reset,
                                  chain_len=chain_len, surrogate=surrogate))
    return lif_parallel(drive, theta=theta, lam=lam, reset=reset,
                        chain_len=chain_len, surrogate=surrogate, iand_skip=iand_skip)
