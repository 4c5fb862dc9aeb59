"""Plain PyTorch version of the spike_matmul kernel."""

from __future__ import annotations

import torch


def spike_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, C) -> (M, C) in f32."""
    return x.float() @ w.float()
