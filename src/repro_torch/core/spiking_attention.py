"""Spiking self-attention (SSA): softmax-free attention over binary Q, K, V.

With binary (non-negative) Q, K, V the score matrix QK^T is already
non-negative, so the softmax is dropped entirely:

    SSA(Q, K, V) = (Q K^T) V * scale            (then BN + LIF -> spikes)

Two algebraically identical orderings: ``quadratic`` (Q K^T) V, O(N^2 d),
the ASIC dataflow; ``linear`` Q (K^T V), O(N d^2), legal only because there
is no softmax.  All T time steps are tick-batched into the contraction batch.
This module covers the vision model's non-causal attention (plus the causal
mask of the quadratic ordering); the causal linear ordering and the decode
states of the spiking LM belong to its later slice.
"""

from __future__ import annotations

import torch


def ssa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        scale: float = 0.125, ordering: str = "quadratic",
        causal: bool = False) -> torch.Tensor:
    """q, k, v: (T, B, H, N, Dh) binary spikes -> (T, B, H, N, Dh) real-valued
    attention drive (fed to BN+LIF by the caller to re-spike)."""
    if ordering == "quadratic":
        scores = torch.einsum("tbhnd,tbhmd->tbhnm", q, k)
        if causal:
            s = q.shape[3]
            mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
            scores = torch.where(mask, scores, 0.0)   # no softmax: mask -> 0
        out = torch.einsum("tbhnm,tbhmd->tbhnd", scores, v)
    elif ordering == "linear":
        if causal:
            raise NotImplementedError(
                "causal linear-ordering SSA (the spiking LM's chunked scan) is "
                "not ported yet")
        kv = torch.einsum("tbhmd,tbhme->tbhde", k, v)
        out = torch.einsum("tbhnd,tbhde->tbhne", q, kv)
    else:
        raise ValueError(f"unknown ordering: {ordering}")
    return out * scale


def split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(T, B, N, D) -> (T, B, H, N, D/H).  Returns a transposed VIEW: make it
    contiguous before handing its storage to a kernel."""
    t, b, n, d = x.shape
    return x.reshape(t, b, n, h, d // h).permute(0, 1, 3, 2, 4)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(T, B, H, N, Dh) -> (T, B, N, H*Dh)."""
    t, b, h, n, dh = x.shape
    return x.permute(0, 1, 3, 2, 4).reshape(t, b, n, h * dh)
