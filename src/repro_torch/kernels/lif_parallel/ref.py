"""Plain PyTorch version of the lif_parallel kernel (delegates to
``repro_torch.core.lif``)."""

from __future__ import annotations

import torch

from repro_torch.core.lif import lif_parallel as _core_lif_parallel


def lif_parallel_ref(drive: torch.Tensor, *, chain_len: int | None = None,
                     lam: float = 0.25, theta: float = 0.5, reset: str = "hard",
                     skip: torch.Tensor | None = None) -> torch.Tensor:
    """(T, N) drive -> (T, N) spikes; optional fused IAND with ``skip``."""
    return _core_lif_parallel(drive, theta=theta, lam=lam, reset=reset,
                              chain_len=chain_len, iand_skip=skip)
