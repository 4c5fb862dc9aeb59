"""Plain PyTorch versions of the spiking_attention kernels."""

from __future__ import annotations

import torch

from repro_torch.core.spiking_attention import _bitplanes


MAX_SUM = 2 ** 24    # every partial sum of S v below it is an integer exact in f32
KEY_TILE = 64        # keys per staged tile of the kernels (kKeys in ssa.cu)


def key_range(m: int, d: int) -> int:
    """Keys per range of the S v sum: all ``m`` while m * d < 2^24, else the
    largest multiple of KEY_TILE keys whose sums (integers <= R * d for
    binary operands) stay below 2^24.  ``ssa.cu::key_range`` is the same."""
    if m * d < MAX_SUM:
        return m
    return max(1, (MAX_SUM - 1) // d // KEY_TILE * KEY_TILE)


def ssa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            scale: float = 0.125, causal: bool = False, q0: int = 0) -> torch.Tensor:
    """(G, N, D), (G, M, D), (G, M, D) -> (G, N, D); no softmax.  ``causal``
    masks the score matrix to the lower triangle (mask -> 0, not -inf),
    key j kept for query i iff j <= q0 + i: ``q0`` is the position of q's
    first row when q is a slice of a longer query sequence.

    The S v sum runs over ranges of :func:`key_range` keys in ascending
    order: each range's partial is exact in f32 for binary operands, the
    partials are added into the output one by one, and the scale multiplies
    last -- the kernels' order, so they equal this bit for bit at any M.
    Below M * D = 2^24 there is one range."""
    n, m = q.shape[1], k.shape[1]
    r = max(1, key_range(m, q.shape[2]))
    out = None
    for k0 in range(0, max(m, 1), r):
        scores = torch.einsum("gnd,gmd->gnm", q, k[:, k0:k0 + r])
        if causal:
            keys = torch.arange(k0, min(m, k0 + r), device=q.device)
            queries = torch.arange(q0, q0 + n, device=q.device)
            scores = torch.where(keys[None, :] <= queries[:, None], scores, 0.0)
        part = torch.einsum("gnm,gmd->gnd", scores, v[:, k0:k0 + r])
        out = part if out is None else out + part
    return out * scale


def ssa_linear_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float = 0.125) -> torch.Tensor:
    """Linear ordering Q (K^T V): the same result as :func:`ssa_ref` (not
    causal), at O(N d^2) cost."""
    kv = torch.einsum("gmd,gme->gde", k, v)
    return torch.einsum("gnd,gde->gne", q, kv) * scale


def packed_ssa_ref(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                   scale: float = 0.125, causal: bool = False, q0: int = 0) -> torch.Tensor:
    """q words (W, G, N, D), k/v words (W, G, M, D) -> (T, G, N, D): each
    bitplane shifted out of the words, then :func:`ssa_ref`."""
    q, k, v = (_bitplanes(x, t) for x in (qw, kw, vw))
    fold = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    out = ssa_ref(fold(q), fold(k), fold(v), scale=scale, causal=causal, q0=q0)
    return out.reshape(q.shape)


def sparse_packed_ssa_ref(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                          live: torch.Tensor, *, t: int, scale: float = 0.125,
                          causal: bool = False, q0: int = 0) -> torch.Tensor:
    """The plane-gated packed SSA: output plane t of fold g is
    :func:`packed_ssa_ref`'s where ``live[g, t]`` is nonzero, else zero."""
    out = packed_ssa_ref(qw, kw, vw, t=t, scale=scale, causal=causal, q0=q0)
    return torch.where((live != 0).T[:, :, None, None], out, 0.0)
