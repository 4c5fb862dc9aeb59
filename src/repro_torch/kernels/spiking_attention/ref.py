"""Plain PyTorch version of the spiking_attention kernel."""

from __future__ import annotations

import torch


def ssa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """(G, N, D), (G, M, D), (G, M, D) -> (G, N, D); no softmax.  ``causal``
    masks the score matrix to the lower triangle (mask -> 0, not -inf)."""
    scores = torch.einsum("gnd,gmd->gnm", q, k)
    if causal:
        n, m = q.shape[1], k.shape[1]
        mask = torch.arange(m, device=q.device)[None, :] <= torch.arange(n, device=q.device)[:, None]
        scores = torch.where(mask, scores, 0.0)
    return torch.einsum("gnm,gmd->gnd", scores, v) * scale
