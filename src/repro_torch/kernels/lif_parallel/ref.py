"""Plain PyTorch versions of the lif_parallel kernels (delegate to
``repro_torch.core.lif`` and ``repro_torch.core.packing``)."""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.lif import lif_parallel as _core_lif_parallel


def lif_parallel_ref(drive: torch.Tensor, *, chain_len: int | None = None,
                     lam: float = 0.25, theta: float = 0.5, reset: str = "hard",
                     skip: torch.Tensor | None = None) -> torch.Tensor:
    """(T, N) drive -> (T, N) spikes; optional fused IAND with ``skip``."""
    return _core_lif_parallel(drive, theta=theta, lam=lam, reset=reset,
                              chain_len=chain_len, iand_skip=skip)


def lif_pack_ref(drive: torch.Tensor, *, chain_len: int | None = None,
                 lam: float = 0.25, theta: float = 0.5, reset: str = "hard",
                 skip_words: torch.Tensor | None = None) -> torch.Tensor:
    """(T, N) drive -> (ceil(T/32), N) int32 spike words; with ``skip_words``
    the bitwise IAND ``skip_words & ~words``."""
    words = packing.pack(lif_parallel_ref(drive, chain_len=chain_len, lam=lam,
                                          theta=theta, reset=reset)).words
    return words if skip_words is None else skip_words & ~words


def lif_parallel_ref_grad(drive: torch.Tensor, g: torch.Tensor, *,
                          chain_len: int | None = None, lam: float = 0.25,
                          theta: float = 0.5, reset: str = "hard") -> torch.Tensor:
    """(T, N) drive, (T, N) spike cotangent ``g`` -> (T, N) drive cotangent:
    the VJP of :func:`lif_parallel_ref` with respect to the drive under the
    boxcar surrogate of width 1, by eager autograd (every product and sum
    rounded on its own, which the backward kernel reproduces)."""
    with torch.enable_grad():
        d = drive.detach().requires_grad_(True)
        out = _core_lif_parallel(d, theta=theta, lam=lam, reset=reset,
                                 chain_len=chain_len, surrogate="boxcar")
        (dx,) = torch.autograd.grad(out, d, g)
    return dx
