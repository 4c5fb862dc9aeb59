"""Wrappers mapping the model's layer types onto ONE GEMM kernel
(``csrc/spike_matmul.cu``).

Mirrors the accelerator's reconfigurable PE dataflow (Fig. 4): the same GEMM
serves 3x3 conv (im2col -> GEMM), 1x1 conv and matmul.  Inputs are spike
tensors with T already folded into the leading dim, so each weight tile is
fetched once for all time steps.

:func:`spike_matmul_fwd` (dense spikes), :func:`packed_spike_matmul_fwd`
(spikes bit-packed along time into int32 words, ``repro_torch.core.packing``
layout) and :func:`sparse_packed_spike_matmul_fwd` (packed, with all-zero
word tiles skipped by their occupancy counts) are the launch sites: a CUDA
tensor goes to the kernel (or the call raises), a CPU tensor to the plain
version.  Each has a ``launches`` attribute counting kernel launches.  The
kernels mask ragged M, K and C, so nothing is padded.

Operand contract of the kernels: the activations are integers of magnitude
at most 256, which bf16 holds exactly.  Packed words are bits.  The dense
GEMM gets LIF outputs in {0, 1} (``engine/backend.py`` ``linear_apply``, and
``conv3x3_apply`` through :func:`_im2col`, whose zero padding is 0; the rate
head never reaches it), and in the residual='add' configs also the residual
stream, a sum of at most 2L + 1 spike trains.  On the card all three run one
tensor-core tile body (``spike_matmul.cu``): the f32 weights split into three
bf16 pieces (hi + mid + lo == w exactly), the activations exact in bf16,
``mma.sync.m16n8k16`` bf16 x bf16 -> f32 for each piece, and a fresh partial
sum per 32 features added to an f32 accumulator.  They agree with the plain
f32 versions within f32 reassociation (rtol 1e-5, atol 1e-4 at the main
path's K <= 1728) and with each other bit for bit: the packed GEMM equals the
dense one on the unpacked operand, the gated one the packed one.  An
activation outside the contract would be rounded to bf16 first: no caller
may pass one.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels.spike_matmul.ref import (
    OCC_ROWS, packed_spike_matmul_ref, sparse_packed_spike_matmul_ref, spike_matmul_ref)

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_PACKED_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_SPARSE_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
MAX_PACKED_T = 32    # time steps one word carries


def spike_matmul_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) f32 spikes, or spike counts of at most 256 (the operand
    contract above), w: (K, C) weights -> (M, C) f32; no zero-sized dims.

    Replaces the TPU kernel ``repro.kernels.spike_matmul.kernel.spike_matmul_fwd``.
    On the card: ``spike_matmul_tc_kernel``, warp-specialized: per 128 x 96
    output tile two producer warpgroups load each 32-feature stage, convert x
    to bf16 (exact on the contract's integers) and split each weight into
    three bf16 pieces once per block into one of two shared buffers, and
    eight consumer warps read their fragments with ``ldmatrix`` and issue
    three ``mma.sync.m16n8k16`` per k16 step."""
    (m, k), (k2, c) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return spike_matmul_ref(x, w)
    _build.check_operands("spike_matmul_fwd", (x, torch.float32), (w, torch.float32))
    out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel("spike_matmul", "spike_matmul_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, c,
                 _build.stream(x.device))
    _build.check(err, "spike_matmul", "spike_matmul_fwd")
    spike_matmul_fwd.launches += 1
    _build.report_launch("spike_matmul_fwd", x, w, out)
    return out


spike_matmul_fwd.launches = 0


def packed_spike_matmul_fwd(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """xw: (M, K) int32 spike words carrying ``t`` <= 32 time steps, w: (K, C)
    weights -> (T, M, C) f32; no zero-sized dims.

    Replaces the TPU kernel
    ``repro.kernels.spike_matmul.kernel.packed_spike_matmul_fwd``.  On the
    card: ``packed_spike_matmul_tc_kernel<P>``, the tile body of
    :func:`spike_matmul_fwd` with its A rows the P planes (1, 2 or 4) of
    each word row: one word read serves P planes, each plane's bf16
    fragment built from the bits (1.0 is 0x3F80).  Equal bit for bit to
    :func:`spike_matmul_fwd` on the unpacked (T*M, K) operand."""
    (m, k), (k2, c) = xw.shape, w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: xw {tuple(xw.shape)}, w {tuple(w.shape)}")
    if not 1 <= t <= MAX_PACKED_T:
        raise ValueError(f"packed GEMM holds T<=32 steps per word, got {t}")
    if xw.device.type == "cpu":
        return packed_spike_matmul_ref(xw, w, t=t)
    _build.check_operands("packed_spike_matmul_fwd", (xw, torch.int32), (w, torch.float32))
    out = torch.empty((t, m, c), dtype=torch.float32, device=xw.device)
    fn = _build.kernel("spike_matmul", "packed_spike_matmul_fwd", _PACKED_ARGTYPES)
    with torch.cuda.device(xw.device):
        err = fn(xw.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, c, t,
                 _build.stream(xw.device))
    _build.check(err, "spike_matmul", "packed_spike_matmul_fwd")
    packed_spike_matmul_fwd.launches += 1
    _build.report_launch("packed_spike_matmul_fwd", xw, w, out)
    return out


packed_spike_matmul_fwd.launches = 0


def grid_tiles_shape(m: int, k: int) -> tuple[int, int]:
    """Shape of the occupancy-gated GEMM's tile counts for (M, K) words:
    one count per (64-row, 128-feature) tile."""
    return -(-m // OCC_ROWS), -(-k // packing.OCC_TILE)


def sparse_packed_spike_matmul_fwd(xw: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor,
                                   *, t: int) -> torch.Tensor:
    """xw: (M, K) int32 spike words carrying ``t`` <= 32 time steps, w: (K, C)
    weights, tiles: (ceil(M/64), ceil(K/128)) int32 spike counts of ``xw``
    -> (T, M, C) f32, with every (64, 128) word tile whose count is 0
    skipped; no zero-sized dims.

    Replaces the TPU kernel
    ``repro.kernels.spike_matmul.kernel.sparse_packed_spike_matmul_fwd``.  On
    the card: ``sparse_packed_spike_matmul_tc_kernel<P>``, the packed tile
    body that skips a 32-feature stage dead in all of a block's tiles (no
    load, no MMA) and a warp's MMAs where its own tile is dead.  Where the
    counts are those of ``xw``, a skipped tile adds exactly 0, so the result
    equals :func:`packed_spike_matmul_fwd` bit for bit."""
    (m, k), (k2, c) = xw.shape, w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: xw {tuple(xw.shape)}, w {tuple(w.shape)}")
    if not 1 <= t <= MAX_PACKED_T:
        raise ValueError(f"packed GEMM holds T<=32 steps per word, got {t}")
    if tuple(tiles.shape) != grid_tiles_shape(m, k):
        raise ValueError(f"tile counts {tuple(tiles.shape)} do not match the "
                         f"{grid_tiles_shape(m, k)} tiling of {m}x{k} words")
    if xw.device.type == "cpu":
        return sparse_packed_spike_matmul_ref(xw, w, tiles, t=t)
    _build.check_operands("sparse_packed_spike_matmul_fwd", (xw, torch.int32),
                          (w, torch.float32), (tiles, torch.int32))
    out = torch.empty((t, m, c), dtype=torch.float32, device=xw.device)
    fn = _build.kernel("spike_matmul", "sparse_packed_spike_matmul_fwd", _SPARSE_ARGTYPES)
    with torch.cuda.device(xw.device):
        err = fn(xw.data_ptr(), w.data_ptr(), tiles.data_ptr(), out.data_ptr(), m, k, c,
                 t, _build.stream(xw.device))
    _build.check(err, "spike_matmul", "sparse_packed_spike_matmul_fwd")
    sparse_packed_spike_matmul_fwd.launches += 1
    _build.report_launch("sparse_packed_spike_matmul_fwd", xw, w, tiles, out)
    return out


sparse_packed_spike_matmul_fwd.launches = 0


def spike_matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) spikes x (K, C) -> (M, C) f32.

    Zero-sized dims never reach the kernel: an empty M/C yields an empty
    result, an empty K (summing over nothing) yields zeros.
    """
    (m, k), (_, c) = x.shape, w.shape
    if 0 in (m, k, c):
        return torch.zeros((m, c), dtype=torch.float32, device=x.device)
    return spike_matmul_fwd(x.contiguous(), w.contiguous())


def packed_spike_matmul_op(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """Packed-operand GEMM: (M, K) int32 spike words x (K, C) -> (T, M, C) f32.

    ``xw`` carries all ``t`` (<= 32) time steps of each spike in one word,
    so the activation read is 1/t of the dense GEMM's.  Zero-sized dims never
    reach the kernel, as in :func:`spike_matmul_op`.
    """
    (m, k), (_, c) = xw.shape, w.shape
    if 0 in (m, k, c):
        return torch.zeros((t, m, c), dtype=torch.float32, device=xw.device)
    return packed_spike_matmul_fwd(xw.contiguous(), w.contiguous(), t=t)


def _count_tiles(counts: torch.Tensor) -> torch.Tensor:
    """(M, K) per-word spike counts -> the (ceil(M/64), ceil(K/128)) tile sums;
    the padding counts 0."""
    m, k = counts.shape
    counts = F.pad(counts, (0, (-k) % packing.OCC_TILE, 0, (-m) % OCC_ROWS))
    mt, kt = grid_tiles_shape(m, k)
    return counts.reshape(mt, OCC_ROWS, kt, packing.OCC_TILE).sum(dim=(1, 3),
                                                                   dtype=torch.int32)


def _occ_to_grid_tiles(occ: torch.Tensor | None, xw: torch.Tensor) -> torch.Tensor:
    """Reduce the occupancy of the (M, K) words ``xw`` to the gated GEMM's
    (64-row, 128-feature) tiling: (ceil(M/64), ceil(K/128)) int32.

    ``occ`` is the pack-time map of ``xw`` with the word axis dropped,
    (M, ceil(K/128)): its rows are summed in groups of 64 (the ragged last
    group is padded with zero rows).  Without a carried map the counts come
    from one popcount pass over the words."""
    if occ is None:
        return _count_tiles(packing.popcount(xw))
    m = occ.shape[0]
    padded = F.pad(occ, (0, 0, 0, (-m) % OCC_ROWS))
    return padded.reshape(-1, OCC_ROWS, occ.shape[1]).sum(dim=1, dtype=torch.int32)


def sparse_packed_spike_matmul_op(xw: torch.Tensor, w: torch.Tensor, *, t: int,
                                  occ: torch.Tensor | None = None) -> torch.Tensor:
    """Occupancy-gated packed GEMM: (M, K) int32 spike words x (K, C) ->
    (T, M, C) f32, equal to :func:`packed_spike_matmul_op` bit for bit, with
    every all-zero (64-row, 128-feature) word tile skipped.

    ``occ``: the pack-time occupancy map of ``xw`` with the word axis
    dropped, (M, ceil(K/128)) int32; without it the tile counts come from
    one popcount pass over the words."""
    (m, k), (_, c) = xw.shape, w.shape
    if 0 in (m, k, c):
        return torch.zeros((t, m, c), dtype=torch.float32, device=xw.device)
    tiles = _occ_to_grid_tiles(occ, xw)
    return sparse_packed_spike_matmul_fwd(xw.contiguous(), w.contiguous(), tiles, t=t)


def conv1x1_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv as direct GEMM. x: (N, H, W, Cin), w: (Cin, Cout)."""
    n, h, wd, c = x.shape
    return spike_matmul_op(x.reshape(n * h * wd, c), w).reshape(n, h, wd, w.shape[1])


def _im2col(x: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """(N, H, W, C) -> (N*H*W, ksize*ksize*C) patches, SAME padding.

    Column order is HWIO: column ``(i*ksize + j)*C + c`` holds pixel
    (h+i-p, w+j-p) channel c, so an HWIO weight reshaped to
    (ksize*ksize*C, Cout) lines up row for row.  (``F.unfold`` orders the
    columns channel-major instead, ``c*ksize*ksize + i*ksize + j``.)
    """
    n, h, w, c = x.shape
    p = ksize // 2
    xp = F.pad(x, (0, 0, p, p, p, p))        # pads W then H of NHWC
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(ksize) for j in range(ksize)]
    return torch.cat(cols, dim=-1).reshape(n * h * w, ksize * ksize * c)


def conv3x3_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv as im2col GEMM. x: (N, H, W, Cin), w: (3, 3, Cin, Cout)."""
    n, h, wd, c = x.shape
    cout = w.shape[-1]
    out = spike_matmul_op(_im2col(x, 3), w.reshape(9 * c, cout))
    return out.reshape(n, h, wd, cout)


def packed_conv3x3_op(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """3x3 conv on packed spike words. xw: (N, H, W, Cin) int32 words (t <= 32
    time steps each), w: (3, 3, Cin, Cout) -> (T, N, H, W, Cout).

    Packing is elementwise over (N, H, W, C), so im2col commutes with it: the
    patches are gathered as words (SAME padding is the all-zero word) in the
    HWIO column order of :func:`_im2col`, and the packed GEMM unpacks them.
    """
    n, h, wd, c = xw.shape
    cout = w.shape[-1]
    out = packed_spike_matmul_op(_im2col(xw, 3), w.reshape(9 * c, cout), t=t)
    return out.reshape(t, n, h, wd, cout)


def sparse_packed_conv3x3_op(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """Occupancy-gated 3x3 conv on packed words: im2col, then the gated
    packed GEMM; equal to :func:`packed_conv3x3_op` bit for bit.

    The patch gather scrambles the feature axis, so the tile counts are
    recomputed for the gathered words.  Popcount is elementwise and the
    gather only copies (its SAME padding is the zero word, count 0), so the
    popcounts are taken once on the (N, H, W, Cin) words and gathered beside
    them: the counts of the gathered words, from a pass over a ninth of them.
    """
    n, h, wd, c = xw.shape
    cout = w.shape[-1]
    cols = _im2col(xw, 3)
    if 0 in (*cols.shape, cout):
        return torch.zeros((t, n, h, wd, cout), dtype=torch.float32, device=xw.device)
    tiles = _count_tiles(_im2col(packing.popcount(xw), 3))
    out = sparse_packed_spike_matmul_fwd(cols, w.reshape(9 * c, cout).contiguous(), tiles,
                                         t=t)
    return out.reshape(t, n, h, wd, cout)
