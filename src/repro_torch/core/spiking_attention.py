"""Spiking self-attention (SSA): softmax-free attention over binary Q, K, V.

With binary (non-negative) Q, K, V the score matrix QK^T is already
non-negative, so the softmax is dropped entirely:

    SSA(Q, K, V) = (Q K^T) V * scale            (then BN + LIF -> spikes)

Two algebraically identical orderings: ``quadratic`` (Q K^T) V, O(N^2 d),
the ASIC dataflow; ``linear`` Q (K^T V), O(N d^2), legal only because there
is no softmax.  All T time steps are tick-batched into the contraction batch.
This module covers the vision model's non-causal attention (plus the causal
mask of the quadratic ordering), and its packed-operand forms on bit-packed
q/k/v words (``repro_torch.core.packing`` layout) and its plane-gated sparse
form (:func:`ssa_packed_sparse`); the causal linear ordering and the decode
states of the spiking LM belong to its later slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing


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


def split_heads_packed(xp: packing.PackedSpikes, h: int) -> packing.PackedSpikes:
    """Head split on a bit-packed spike train: words (W, B, N, D) ->
    (W, B, H, N, D/H).  Packing is elementwise over (B, N, D), so the split
    commutes with it and the word axis rides along.  The words are a
    transposed VIEW, as in :func:`split_heads`; the occupancy map, tiled over
    D, is dropped (the attention consumers take their own liveness)."""
    w, b, n, d = xp.words.shape
    words = xp.words.reshape(w, b, n, h, d // h).permute(0, 1, 3, 2, 4)
    return packing.PackedSpikes(words=words, t=xp.t)


def _bitplanes(words: torch.Tensor, t: int, dtype=torch.float32) -> torch.Tensor:
    """(W, *S) int32 bitplane words -> (T, *S) dense spikes by shift and mask
    -- the mirror of the packed kernels' per-tile unpack, kept apart from
    ``packing.unpack`` so that the packed datapath provably never calls it."""
    planes = []
    for w in range(words.shape[0]):
        t_here = min(packing.WORD_BITS, t - w * packing.WORD_BITS)
        shifts = torch.arange(t_here, dtype=torch.int32, device=words.device)
        shifts = shifts.reshape((t_here,) + (1,) * (words.ndim - 1))
        planes.append((words[w][None] >> shifts) & 1)
    return torch.cat(planes).to(dtype)


def ssa_kv_state(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The K^T V state of a whole prefix: k/v (..., S, Dh) spikes ->
    (..., Dh, Dh)."""
    return torch.einsum("...md,...me->...de", k, v)


def ssa_kv_state_packed(kw: torch.Tensor, vw: torch.Tensor, *, t: int) -> torch.Tensor:
    """Packed-operand :func:`ssa_kv_state`: (W, ..., S, Dh) k/v words -> the
    (T, ..., Dh, Dh) K^T V state, words consumed by shift and mask."""
    return ssa_kv_state(_bitplanes(kw, t), _bitplanes(vw, t))


def ssa_linear_packed(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                      scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """Linear-ordering Q(K^T V) SSA on packed q/k/v words (W, B, H, S, Dh) ->
    dense drive (T, B, H, S, Dh), words consumed by shift and mask."""
    if causal:
        raise NotImplementedError(
            "causal packed linear-ordering SSA (the spiking LM's chunked scan) is "
            "not ported yet; it comes with the spiking-LM slice")
    kv = ssa_kv_state_packed(kw, vw, t=t)
    return torch.einsum("tbhnd,tbhde->tbhne", _bitplanes(qw, t), kv) * scale


# -- sparsity-aware variant ----------------------------------------------------
#
# A bitplane of the SSA output is zero whenever its q, k or v plane carries
# no spike, and planes are computed independently, so skipping a dead plane
# is exact and re-associates nothing.


def plane_occupancy(words: torch.Tensor, *, t: int) -> torch.Tensor:
    """(W, *S) words -> (T,) int32 spike counts per bitplane (time step)."""
    planes = []
    for ti in range(t):
        wi, bit = divmod(ti, packing.WORD_BITS)
        planes.append(((words[wi] >> bit) & 1).sum(dtype=torch.int32))
    return torch.stack(planes)


def ssa_packed_sparse(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                      scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """Quadratic-ordering SSA on packed words (W, B, H, N, Dh) with a
    per-bitplane early-out: plane t of the drive (T, B, H, N, Dh) is computed
    only when q, k and v all spike at time step t somewhere in the batch;
    dead planes are exact zeros.  (The liveness is per whole batch here; the
    kernel route's is per (b, h) fold.  Both are exact.)"""
    _, b, h, n, dh = qw.shape
    alive = ((plane_occupancy(qw, t=t) > 0) & (plane_occupancy(kw, t=t) > 0)
             & (plane_occupancy(vw, t=t) > 0)).tolist()
    out = torch.zeros((t, b, h, n, dh), dtype=torch.float32, device=qw.device)
    for ti in range(t):
        if alive[ti]:
            wi, bit = divmod(ti, packing.WORD_BITS)
            plane = lambda w: ((w[wi] >> bit) & 1).float()[None]
            out[ti] = ssa(plane(qw), plane(kw), plane(vw), scale=scale,
                          causal=causal)[0]
    return out
