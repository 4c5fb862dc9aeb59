"""Spiking self-attention (SSA): softmax-free attention over binary Q, K, V.

With binary (non-negative) Q, K, V the score matrix QK^T is already
non-negative, so the softmax is dropped entirely:

    SSA(Q, K, V) = (Q K^T) V * scale            (then BN + LIF -> spikes)

Two algebraically identical orderings: ``quadratic`` (Q K^T) V, O(N^2 d),
the ASIC dataflow; ``linear`` Q (K^T V), O(N d^2), legal only because there
is no softmax.  All T time steps are tick-batched into the contraction batch.
This module covers the vision model's non-causal attention, the spiking LM's
causal one in both orderings -- the linear ordering as a chunked running
K^T V state scan, whose carry is also the O(d^2) decode state -- and the
decode step, state read and prefill state, each also on bit-packed q/k/v
words (``repro_torch.core.packing`` layout), and the plane-gated sparse forms
(:func:`ssa_packed_sparse`, :func:`ssa_linear_decode_step_packed_sparse`).
All of these are plain PyTorch, as the reference runs them outside any
kernel.  On binary spikes every contraction is exact integer arithmetic in
f32 (while the sums stay below 2^24), so the order of the sums does not
change the result and each function equals the JAX package's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import packing


def _pad_tokens(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the token axis (axis 3) of a (T|W, B, H, S, Dh) tensor."""
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def _causal_linear(q, k, v, *, chunk: int, state=None):
    """Chunked running-state causal linear ordering, O(S d^2), exactly equal
    to the masked quadratic product (no softmax, so chunking is exact).
    Returns ``(out, final_state)``: the scan's carry after the last chunk is
    the end-of-prefix K^T V decode state.  ``state`` seeds the carry with an
    earlier prefix's state (default zeros).  Ragged lengths are zero-padded
    to the chunk multiple (padded keys and values add exact zeros, padded
    query rows are sliced away)."""
    s = q.shape[3]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    q, k, v = (_pad_tokens(x, pad) for x in (q, k, v))
    out, state = _causal_linear_aligned(q, k, v, chunk=chunk, state0=state)
    return out[:, :, :, :s], state


def _causal_step(state, q_i, k_i, v_i, mask):
    """One chunk of the causal scan: intra-chunk masked (Q K^T) V plus the
    read of the carried state, then the state advanced by the chunk's K^T V."""
    intra = torch.einsum("tbhnd,tbhmd->tbhnm", q_i, k_i)
    intra = torch.where(mask, intra, 0.0)
    y = torch.einsum("tbhnm,tbhmd->tbhnd", intra, v_i)
    y = y + torch.einsum("tbhnd,tbhde->tbhne", q_i, state)
    state = state + torch.einsum("tbhmd,tbhme->tbhde", k_i, v_i)
    return state, y


def _causal_linear_aligned(q, k, v, *, chunk: int, state0=None):
    s, dh = q.shape[3], q.shape[-1]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    state = state0
    if state is None:
        state = torch.zeros(tuple(q.shape[:3]) + (dh, dh), dtype=q.dtype, device=q.device)
    ys = []
    for c0 in range(0, s, chunk):
        state, y = _causal_step(state, q[:, :, :, c0:c0 + chunk], k[:, :, :, c0:c0 + chunk],
                                v[:, :, :, c0:c0 + chunk], mask)
        ys.append(y)
    return torch.cat(ys, dim=3), state


def ssa_causal_linear_with_state(q, k, v, *, scale: float = 0.125, chunk: int = 512,
                                 state=None):
    """Causal linear-ordering SSA that also returns the end-of-prefix K^T V
    state: ``(drive, state)``, the drive equal to ``ssa(..., ordering="linear",
    causal=True)`` and the state to ``ssa_kv_state(k, v)`` (plus ``state``),
    bit for bit on binary spikes.  Fed a prompt in any chunking, each call
    seeded with the previous call's state, it gives the per-chunk drives and
    the final state of one call over the whole prompt."""
    out, state = _causal_linear(q, k, v, chunk=chunk, state=state)
    return out * scale, state


def ssa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        scale: float = 0.125, ordering: str = "quadratic",
        causal: bool = False, chunk: int = 512) -> torch.Tensor:
    """q, k, v: (T, B, H, N, Dh) binary spikes -> (T, B, H, N, Dh) real-valued
    attention drive (fed to BN+LIF by the caller to re-spike).  ``causal``
    masks the score matrix to the lower triangle; in the linear ordering it
    runs as the chunked K^T V state scan, ``chunk`` tokens a step."""
    if ordering == "quadratic":
        scores = torch.einsum("tbhnd,tbhmd->tbhnm", q, k)
        if causal:
            s = q.shape[3]
            mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
            scores = torch.where(mask, scores, 0.0)   # no softmax: mask -> 0
        out = torch.einsum("tbhnm,tbhmd->tbhnd", scores, v)
    elif ordering == "linear":
        if causal:
            out, _ = _causal_linear(q, k, v, chunk=chunk)
        else:
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


def ssa_linear_state_init(t: int, b: int, h: int, dh: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """The O(d^2) running state of linear-ordering decode: one K^T V
    accumulator per (time step, batch, head), (T, B, H, Dh, Dh), constant in
    context length."""
    return torch.zeros((t, b, h, dh, dh), dtype=dtype, device=device)


def ssa_linear_decode_step(state, q_t, k_t, v_t, *, scale: float = 0.125):
    """One decode step of linear SSA on any leading batch dims: q/k/v of the
    new token(s) (..., N, Dh), ``state`` (..., Dh, Dh).

        state' = state + k^T v ;  out = q state' * scale

    The state updates before the query reads it (a token attends to itself)
    and ``scale`` multiplies the output only.  Returns ``(state', out)``,
    bit-identical to the full causal forward in either ordering on binary
    spikes."""
    state = state + torch.einsum("...md,...me->...de", k_t, v_t)
    out = torch.einsum("...nd,...de->...ne", q_t, state) * scale
    return state, out


def ssa_linear_decode_step_packed(state, qw, kw, vw, *, t: int, scale: float = 0.125):
    """Packed-operand decode step: q/k/v words (W, ..., N, Dh) carrying all
    ``t`` time steps, consumed by shift and mask (no ``packing.unpack``)."""
    return ssa_linear_decode_step(state, _bitplanes(qw, t), _bitplanes(kw, t),
                                  _bitplanes(vw, t), scale=scale)


def _or_bits(words: torch.Tensor) -> torch.Tensor:
    """(W, *S) words -> (W, 32) bool: bit b of word plane w is set in some
    element (the bitwise OR over the elements, bit by bit: PyTorch has no OR
    reduction)."""
    bits = torch.arange(packing.WORD_BITS, dtype=torch.int32, device=words.device)
    return ((words.reshape(words.shape[0], -1, 1) >> bits) & 1).amax(dim=1).bool()


def ssa_linear_decode_step_packed_sparse(state, qw, kw, vw, *, t: int,
                                         scale: float = 0.125):
    """Sparse packed decode step: a k word plane whose bits meet none of the v
    word plane's (the OR of k and the OR of v share no bit) contributes no
    ``k^T v`` term, so its k words are zeroed before any bit becomes
    arithmetic -- exact, since the state increment is zero wherever either
    factor's plane is.  With one word (t <= 32) there is no granule to skip
    against and the words ride :func:`ssa_linear_decode_step_packed` bare."""
    if kw.shape[0] > 1:
        live = (_or_bits(kw) & _or_bits(vw)).any(dim=1)          # (W,)
        kw = torch.where(live.reshape((-1,) + (1,) * (kw.ndim - 1)), kw, 0)
    return ssa_linear_decode_step_packed(state, qw, kw, vw, t=t, scale=scale)


def _pad_words_s(words: torch.Tensor, chunk: int):
    """Zero-pad the token axis (axis 3) of (W, B, H, S, Dh) words up to a
    chunk multiple -- exact: the all-zero word is the all-zero spike train.
    Returns ``(padded, s)``."""
    s = words.shape[3]
    return _pad_tokens(words, (-s) % chunk), s


def ssa_state_read(state, q, *, scale: float = 0.125):
    """Drive that an earlier prefix's K^T V ``state`` (..., Dh, Dh) gives this
    chunk's queries (..., N, Dh); added to the intra-chunk causal drive it
    completes the lower triangle across a chunk boundary, exactly."""
    return torch.einsum("...nd,...de->...ne", q, state) * scale


def ssa_state_read_packed(state, qw, *, t: int, scale: float = 0.125):
    """Packed-operand :func:`ssa_state_read`: query words (W, ..., N, Dh)
    consumed by shift and mask."""
    return ssa_state_read(state, _bitplanes(qw, t), scale=scale)


def ssa_causal_linear_with_state_packed(qw, kw, vw, *, t: int, scale: float = 0.125,
                                        chunk: int = 512, state=None):
    """Packed-operand :func:`ssa_causal_linear_with_state`: the chunked causal
    scan on q/k/v words (W, B, H, S, Dh), each chunk's planes shifted out of
    the words inside the scan -> ``(drive (T, B, H, S, Dh), state)``, bit for
    bit the dense scan's at any chunking."""
    s = qw.shape[3]
    chunk = min(chunk, s)
    (qp, _), (kp, _), (vp, _) = (_pad_words_s(x, chunk) for x in (qw, kw, vw))
    dh = qw.shape[-1]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=qw.device))
    if state is None:
        state = torch.zeros((t,) + tuple(qw.shape[1:3]) + (dh, dh), dtype=torch.float32,
                            device=qw.device)
    ys = []
    for c0 in range(0, qp.shape[3], chunk):
        planes = (_bitplanes(x[:, :, :, c0:c0 + chunk], t) for x in (qp, kp, vp))
        state, y = _causal_step(state, *planes, mask)
        ys.append(y)
    return torch.cat(ys, dim=3)[:, :, :, :s] * scale, state


def ssa_linear_packed(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                      scale: float = 0.125, causal: bool = False,
                      chunk: int = 512) -> torch.Tensor:
    """Linear-ordering Q(K^T V) SSA on packed q/k/v words (W, B, H, S, Dh) ->
    dense drive (T, B, H, S, Dh), words consumed by shift and mask;
    ``causal`` rides the packed chunked scan."""
    if causal:
        out, _ = ssa_causal_linear_with_state_packed(qw, kw, vw, t=t, scale=scale,
                                                     chunk=chunk)
        return out
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
