"""Plain PyTorch versions of the spiking_attention kernels."""

from __future__ import annotations

import torch

from repro_torch.core.spiking_attention import _bitplanes


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


def packed_ssa_ref(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                   scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """q words (W, G, N, D), k/v words (W, G, M, D) -> (T, G, N, D): each
    bitplane shifted out of the words, then :func:`ssa_ref`."""
    q, k, v = (_bitplanes(x, t) for x in (qw, kw, vw))
    fold = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    out = ssa_ref(fold(q), fold(k), fold(v), scale=scale, causal=causal)
    return out.reshape(q.shape)


def sparse_packed_ssa_ref(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                          live: torch.Tensor, *, t: int, scale: float = 0.125,
                          causal: bool = False) -> torch.Tensor:
    """The plane-gated packed SSA: output plane t of fold g is
    :func:`packed_ssa_ref`'s where ``live[g, t]`` is nonzero, else zero."""
    out = packed_ssa_ref(qw, kw, vw, t=t, scale=scale, causal=causal)
    return torch.where((live != 0).T[:, :, None, None], out, 0.0)
