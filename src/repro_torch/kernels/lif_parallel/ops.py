"""Wrappers of the lif_parallel CUDA kernel (``csrc/lif_parallel.cu``).

:func:`lif_parallel_fwd` is the one launch site: a CUDA tensor goes to the
kernel (or the call raises), a CPU tensor to the plain version
(:func:`repro_torch.kernels.lif_parallel.ref.lif_parallel_ref`).  Its
``launches`` attribute counts kernel launches.  :func:`lif_parallel_op` and
:func:`lif_iand_op` accept any (T, ...) shape and flatten it to (T, N); the
kernel masks the ragged tail itself, so nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lif_parallel.ref import lif_parallel_ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p)


def lif_parallel_fwd(drive: torch.Tensor, *, chain_len: int, lam: float,
                     theta: float, reset: str,
                     skip: torch.Tensor | None = None) -> torch.Tensor:
    """drive: (T, N) -> spikes (T, N), or IAND(skip, spikes) if skip is given."""
    t_total, n = drive.shape
    if reset not in ("hard", "soft"):
        raise ValueError(f"unknown reset mode: {reset}")
    if chain_len < 1 or t_total % chain_len:
        raise ValueError(f"T={t_total} not divisible by chain_len={chain_len}")
    if skip is not None and skip.shape != drive.shape:
        raise ValueError(f"skip shape {tuple(skip.shape)} != drive shape "
                         f"{tuple(drive.shape)}")
    if drive.device.type == "cpu":
        return lif_parallel_ref(drive, chain_len=chain_len, lam=lam, theta=theta,
                                reset=reset, skip=skip)
    operands = (drive,) if skip is None else (drive, skip)
    _build.check_operands("lif_parallel_fwd", *operands)
    out = torch.empty_like(drive)
    if out.numel() == 0:
        return out
    fn = _build.kernel("lif_parallel", "lif_parallel_fwd", _ARGTYPES)
    with torch.cuda.device(drive.device):
        err = fn(drive.data_ptr(), None if skip is None else skip.data_ptr(),
                 out.data_ptr(), t_total, n, chain_len, lam, theta,
                 int(reset == "soft"), _build.stream(drive.device))
    _build.check(err, "lif_parallel", "lif_parallel_fwd")
    lif_parallel_fwd.launches += 1
    return out


lif_parallel_fwd.launches = 0


def lif_parallel_op(drive: torch.Tensor, *, chain_len: int | None = None,
                    lam: float = 0.25, theta: float = 0.5,
                    reset: str = "hard") -> torch.Tensor:
    """Unrolled parallel tick-batching LIF. drive: (T, ...) -> spikes (T, ...)."""
    t = drive.shape[0]
    out = lif_parallel_fwd(drive.reshape(t, -1).contiguous(),
                           chain_len=chain_len or t, lam=float(lam),
                           theta=float(theta), reset=reset)
    return out.reshape(drive.shape)


def lif_iand_op(drive: torch.Tensor, skip: torch.Tensor, *,
                chain_len: int | None = None, lam: float = 0.25,
                theta: float = 0.5, reset: str = "hard") -> torch.Tensor:
    """LIF with the fused IAND epilogue: ``skip * (1 - LIF(drive))``."""
    t = drive.shape[0]
    out = lif_parallel_fwd(drive.reshape(t, -1).contiguous(),
                           chain_len=chain_len or t, lam=float(lam),
                           theta=float(theta), reset=reset,
                           skip=skip.reshape(t, -1).contiguous())
    return out.reshape(drive.shape)
