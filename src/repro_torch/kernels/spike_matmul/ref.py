"""Plain PyTorch versions of the spike_matmul kernels."""

from __future__ import annotations

import torch

from repro_torch.core.spiking_attention import _bitplanes


def spike_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, C) -> (M, C) in f32."""
    return x.float() @ w.float()


def packed_spike_matmul_ref(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """(M, K) int32 words (T <= 32 steps each) x (K, C) -> (T, M, C) f32:
    each bitplane shifted out of the words, then ``plane @ w``."""
    return _bitplanes(xw[None], t) @ w.float()
