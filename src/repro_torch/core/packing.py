"""Bit-packed spike tensors: all T time steps of one element in one word.

The model's inter-layer tensors are binary spikes (the IAND residual keeps
them binary end to end), yet the dense deploy path moves them between layers
as f32 -- 32 bits per spike, times T time steps.  This module packs the time
axis into 32-bit bitplane words, mirroring the paper's tick-batching: bit
``t % 32`` of word ``t // 32`` at element ``e`` is the spike of ``e`` at time
step ``t``, so the whole T-step train of one neuron is one word for T <= 32.

    dense  (T, *S) f32    -> 4*T bytes / element
    packed (W, *S) words  -> 4*W bytes / element,  W = ceil(T / 32)

The two spike-level ops the deploy engine needs stay in the packed domain:

* IAND residual: ``skip * (1 - s)`` on {0,1} tensors is exactly the bitwise
  ``skip & ~s`` on packed words (:func:`iand`);
* rate decoding: the per-neuron spike count over T is a popcount
  (:func:`spike_counts`), so the classification head never unpacks.

Real spike trains are mostly zeros.  The sparse datapath summarises that once
at pack time: :func:`occupancy_map` popcounts each word plane in tiles of
:data:`OCC_TILE` contiguous elements along the feature axis, a small map the
sparse kernels consult to skip all-zero word tiles without reading them.

Words are **int32 tensors holding the uint32 bit pattern** (numpy's
``.view(np.uint32)`` of them is the JAX package's words, see
:mod:`repro_torch.bridge`): PyTorch on the CPU has no ``>>``, ``<<`` or ``~``
for ``uint32`` and no popcount.  Every right shift here is arithmetic, so
each one is masked before use.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

WORD_BITS = 32
OCC_TILE = 128       # feature elements per occupancy tile


def num_words(t: int) -> int:
    """Words needed for a T-step train: ``ceil(t / 32)``."""
    if t < 1:
        raise ValueError(f"need at least one time step, got t={t}")
    return -(-t // WORD_BITS)


@dataclass(frozen=True)
class PackedSpikes:
    """A spike train (T, *S) packed along time into int32 words (W, *S).

    Bit ``t % 32`` of ``words[t // 32]`` is the spike at time step ``t``;
    bits at positions >= t (the ragged tail of the last word) are zero by
    construction -- :func:`iand` and :func:`spike_counts` rely on that.

    ``occ`` is the optional occupancy map (:func:`occupancy_map`): per-tile
    popcounts over :data:`OCC_TILE`-element feature tiles, computed once at
    pack time (the LIF pack epilogue attaches it under ``Backend.sparse``)
    and carried along, so sparse consumers can skip all-zero word tiles.
    """

    words: torch.Tensor       # int32 with the uint32 bit pattern, (W,) + elem_shape
    t: int                    # time steps packed in the word axis
    occ: torch.Tensor | None = None   # int32, (W, *S[:-1], ceil(D / OCC_TILE))

    def __post_init__(self):
        if self.words.dtype != torch.int32:
            raise TypeError(f"packed words must be int32, got {self.words.dtype}")
        if self.occ is not None and self.occ.dtype != torch.int32:
            raise TypeError(f"occupancy maps are int32, got {self.occ.dtype}")

    @property
    def elem_shape(self) -> tuple[int, ...]:
        return tuple(self.words.shape[1:])

    @property
    def dense_shape(self) -> tuple[int, ...]:
        return (self.t,) + self.elem_shape

    def reshape_elems(self, *shape) -> "PackedSpikes":
        """Reshape the element axes, keeping the word axis.  The occupancy
        map is tiled over the LAST element axis, so it survives only reshapes
        that keep that axis; otherwise it is recomputed."""
        w = self.words.shape[0]
        words = self.words.reshape((w,) + tuple(shape))
        occ = self.occ
        if occ is not None:
            if shape and words.shape[-1] == self.words.shape[-1]:
                occ = occ.reshape((w,) + tuple(shape[:-1]) + (occ.shape[-1],))
            else:
                occ = occupancy_map(words)
        return PackedSpikes(words, self.t, occ=occ)

    def with_occupancy(self) -> "PackedSpikes":
        """This train with its occupancy map attached (itself if it has one)."""
        if self.occ is not None:
            return self
        return PackedSpikes(self.words, self.t, occ=occupancy_map(self.words))


def pack(spikes: torch.Tensor, t: int | None = None, *,
         occupancy: bool = False) -> PackedSpikes:
    """Pack a (T, *S) spike tensor (any dtype, values in {0, 1}) into words.

    Nonzero is treated as a spike; the ragged tail of the last word is zero.
    Words are built by OR (never by a sum and a cast, which would promote
    int32 to int64 and wrap bit 31 wrongly).  ``occupancy`` also attaches
    the occupancy map (:func:`occupancy_map`).
    """
    if spikes.ndim < 1:
        raise ValueError("spikes must have a leading time axis")
    t_total = spikes.shape[0]
    if t is not None and t != t_total:
        raise ValueError(f"t={t} does not match leading axis {t_total}")
    bits = (spikes != 0).to(torch.int32)
    words = []
    for w in range(num_words(t_total)):
        acc = torch.zeros_like(bits[0])
        for step in range(w * WORD_BITS, min((w + 1) * WORD_BITS, t_total)):
            acc |= bits[step] << (step % WORD_BITS)
        words.append(acc)
    stacked = torch.stack(words)
    return PackedSpikes(words=stacked, t=t_total,
                        occ=occupancy_map(stacked) if occupancy else None)


def occupancy_map(words: torch.Tensor, tile: int = OCC_TILE) -> torch.Tensor:
    """Per-tile popcounts of a (W, *S) word tensor: (W, *S[:-1], n_tiles)
    int32, where tile ``i`` covers elements ``[i*tile, (i+1)*tile)`` of the
    last (feature) axis -- a ragged tail counts as a short tile.

    This is the sparse datapath's skip index: a zero entry proves the whole
    word tile carries no spike at any of its time steps.  Summed over all
    tiles and word planes it equals :func:`spike_counts` summed over
    elements.  (The JAX package's map is uint32; the counts fit int32.)
    """
    if words.ndim < 1:
        raise ValueError("words must have at least the word axis")
    if words.ndim == 1:
        words = words[:, None]               # scalar elements: one lane
    pad = (-words.shape[-1]) % tile
    counts = F.pad(popcount(words), (0, pad))
    grouped = counts.reshape(tuple(words.shape[:-1]) + (-1, tile))
    return grouped.sum(dim=-1, dtype=torch.int32)


def unpack(ps: PackedSpikes, dtype=torch.float32) -> torch.Tensor:
    """(W, *S) words -> (T, *S) dense spikes in ``dtype``."""
    planes = []
    for w in range(ps.words.shape[0]):
        t_here = min(WORD_BITS, ps.t - w * WORD_BITS)
        shifts = torch.arange(t_here, dtype=torch.int32, device=ps.words.device)
        shifts = shifts.reshape((t_here,) + (1,) * (ps.words.ndim - 1))
        planes.append((ps.words[w][None] >> shifts) & 1)
    return torch.cat(planes).to(dtype)


def iand(skip: PackedSpikes, spikes: PackedSpikes) -> PackedSpikes:
    """AND-NOT residual in the packed domain: ``skip & ~spikes``, bitwise.

    Because the ragged-tail bits of ``skip`` are zero, ``~spikes`` setting
    them is harmless -- the invariant is preserved without a mask.  When the
    skip train carries an occupancy map, the result carries its own.
    """
    if skip.t != spikes.t:
        raise ValueError(f"time-step mismatch: skip t={skip.t}, spikes t={spikes.t}")
    words = skip.words & ~spikes.words
    occ = occupancy_map(words) if skip.occ is not None else None
    return PackedSpikes(words=words, t=skip.t, occ=occ)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (SWAR; each arithmetic right shift is
    masked, so a set bit 31 never smears into the count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F            # per-byte counts, each <= 8
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def spike_counts(ps: PackedSpikes) -> torch.Tensor:
    """Per-element spike count over T via popcount: (W, *S) -> (*S) int32.

    This is the rate-decoding numerator -- the head computes
    ``popcount(words) / T`` instead of unpacking and averaging.
    """
    return popcount(ps.words).sum(dim=0, dtype=torch.int32)


def packed_nbytes(t: int, num_elems: int) -> int:
    """Inter-layer bytes of a packed (t, num_elems) spike tensor."""
    return num_words(t) * num_elems * 4


def dense_nbytes(t: int, num_elems: int, itemsize: int = 4) -> int:
    """Inter-layer bytes of the same tensor moved dense (f32 by default)."""
    return t * num_elems * itemsize


def occupancy_nbytes(t: int, num_elems: int, tile: int = OCC_TILE) -> int:
    """Bytes of the occupancy map riding alongside a packed (t, num_elems)
    spike tensor: one 32-bit count per word plane per OCC_TILE elements (the
    sparse datapath's metadata, 1/128 of the packed words)."""
    return num_words(t) * (-(-num_elems // tile)) * 4
