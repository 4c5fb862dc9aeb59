"""Wrapper of the spiking_attention CUDA kernel (``csrc/ssa.cu``).

:func:`ssa_fwd` (dense spikes), :func:`packed_ssa_fwd` (spikes bit-packed
along time into int32 words, ``repro_torch.core.packing`` layout) and
:func:`sparse_packed_ssa_fwd` (packed, with dead bitplanes skipped) are the
launch sites: a CUDA tensor goes to the kernel (or the call raises), a CPU
tensor to the plain version.  Each has a ``launches`` attribute counting
kernel launches.  :func:`ssa_op` folds (T, B, H, N, Dh) into (G, N, Dh), and
:func:`packed_ssa_op` and :func:`sparse_packed_ssa_op` words (W, B, H, N, Dh)
into (W, G, N, Dh); all make the operands contiguous: the head split hands
over a transposed view, and the kernels assume a dense layout.  Ragged token
counts are masked in the kernels, so nothing is padded.

Operand contract of the kernels: q, k and v are spikes in {0, 1} (every
caller passes LIF outputs) and Dh <= 512; the shape half is checked
(:func:`check_exact_shape`) on the card route, the CPU route runs the plain
f32 version whatever the shape, as the reference does.  All three run both
products on the f16 tensor cores with f32 accumulation, which is exact there
(scores are integers <= 512); the keys are summed in ranges whose sums stay
integers below 2^24 (``ref.key_range``; one range below M * Dh = 2^24), and
the range partials are added in ascending order as the plain versions add
them, so the kernels equal the plain f32 versions bit for bit at any key
count.  Past Dh = 128 (the spiking LM's heads) the three share one kernel,
``ssa_wide_tc_kernel``, whose block covers 64 query rows and the whole head:
it computes each key tile's scores once for all output features and keeps
the next key tile's loads in flight while the current tile's MMAs run.

:func:`ssa_op` is differentiable on both devices (:class:`_SsaOp`): the
forward is :func:`ssa_fwd`, the backward the three bilinear contractions of
:func:`ssa_ref`'s VJP on ``torch.bmm`` -- the JAX package, too, runs that
backward outside any kernel, by differentiating its oracle.  The packed
forms take integer words, which carry no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import WORD_BITS, num_words
from repro_torch.kernels import _build
from repro_torch.kernels.spiking_attention.ref import (
    packed_ssa_ref, sparse_packed_ssa_ref, ssa_ref)

MAX_HEAD_DIM = 512   # the kernels' widest head (kMaxD in ssa.cu): scores stay <= 2048


def check_exact_shape(what: str, d: int) -> None:
    """The shape half of the kernels' operand contract: Dh <= 512 (every
    score, an integer <= Dh, exact in f16; the wide kernel's shared memory).
    Any key count is taken: the S v sum runs over key ranges whose partial
    sums stay exact in f32 (``ref.key_range``).  Raises ``ValueError``
    outside it; ``ssa.cu``'s entry points refuse the same operands."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} > {MAX_HEAD_DIM}")


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_PACKED_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_SPARSE_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def ssa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
            causal: bool = False) -> torch.Tensor:
    """q (G, N, D), k/v (G, M, D) f32 spikes in {0, 1} -> (G, N, D); no
    zero-sized dims, D <= 512.

    Replaces the TPU kernel ``repro.kernels.spiking_attention.kernel.ssa_fwd``.
    On the card: ``ssa_tc_kernel``, one block of 16 warps (16 query rows
    each; 4 warps up to 64 tokens) per fold and query tile, so that a
    196-token fold is one block; q, k, v read as f32 and converted to f16
    (k and v through shared memory), both products on
    ``mma.sync.m16n8k16`` with f32 accumulators, S handed from the C to the
    A fragment in registers.  Past D = 128, ``ssa_wide_tc_kernel``: one
    block of 8 warps per 64 query rows and every output feature; per 16-key
    tile the scores are computed once (each warp a partial over half of D,
    the two added exactly in f32 through shared memory), then multiplied by
    V, each warp holding 16 rows x D/2 outputs; the next k and v tiles load
    into registers while the current tile's MMAs run, every operand is f16
    in shared memory.  Bound by device bytes (q, k, v read and out written
    once); at 2048 tokens it is held back by the keys each query tile
    re-reads and by the latency 8 warps an SM can hide (``ssa.cu``).
    Exact while the operands are binary: f16 holds 0/1 and every score
    (<= 512), f32 every partial sum of a key range, and the ranges' partials
    are added in :func:`ssa_ref`'s order, so the result equals it bit for
    bit at any M."""
    g, n, d = q.shape
    m = k.shape[1]
    if k.shape != (g, m, d) or v.shape != (g, m, d):
        raise ValueError(f"ssa operand shapes differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return ssa_ref(q, k, v, scale=scale, causal=causal)
    check_exact_shape("ssa_fwd", d)
    _build.check_operands("ssa_fwd", *((x, torch.float32) for x in (q, k, v)))
    out = torch.empty_like(q)
    fn = _build.kernel("ssa", "ssa_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g, n, m,
                 d, scale, int(causal), _build.stream(q.device))
    _build.check(err, "ssa", "ssa_fwd")
    ssa_fwd.launches += 1
    _build.report_launch("ssa_fwd", q, k, v, out)
    return out


ssa_fwd.launches = 0


def packed_ssa_fwd(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                   scale: float, causal: bool = False) -> torch.Tensor:
    """q words (W, G, N, D), k/v words (W, G, M, D), int32 with W = ceil(t/32)
    -> (T, G, N, D) f32; no zero-sized dims, D <= 512.

    Replaces the TPU kernel
    ``repro.kernels.spiking_attention.kernel.packed_ssa_fwd``.  On the card:
    ``packed_ssa_tc_kernel<Dp, P, kGated=false>``, the kernel of
    :func:`sparse_packed_ssa_fwd` with every plane computed: one block of
    four warps per (fold, 64 query rows, P planes of one word), each plane's
    f16 fragments built straight from the bits, both products on
    ``mma.sync.m16n8k16`` with f32 accumulators; past D = 128 the wide
    kernel of :func:`ssa_fwd` with one plane a block, its f16 operands built
    from that plane's bits.  Bound by device bytes.  Exact for any words
    (key ranges as in :func:`ssa_fwd`), so the result equals
    :func:`packed_ssa_ref` bit for bit."""
    _check_packed("packed ssa", qw, kw, vw, t)
    w, g, n, d = qw.shape
    m = kw.shape[2]
    if qw.device.type == "cpu":
        return packed_ssa_ref(qw, kw, vw, t=t, scale=scale, causal=causal)
    check_exact_shape("packed_ssa_fwd", d)
    _build.check_operands("packed_ssa_fwd", *((x, torch.int32) for x in (qw, kw, vw)))
    out = torch.empty((t, g, n, d), dtype=torch.float32, device=qw.device)
    fn = _build.kernel("ssa", "packed_ssa_fwd", _PACKED_ARGTYPES)
    with torch.cuda.device(qw.device):
        err = fn(qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), out.data_ptr(), g, n, m,
                 d, t, scale, int(causal), _build.stream(qw.device))
    _build.check(err, "ssa", "packed_ssa_fwd")
    packed_ssa_fwd.launches += 1
    _build.report_launch("packed_ssa_fwd", qw, kw, vw, out)
    return out


packed_ssa_fwd.launches = 0


def _check_packed(what, qw, kw, vw, t):
    w, g, n, d = qw.shape
    m = kw.shape[2]
    if kw.shape != (w, g, m, d) or vw.shape != (w, g, m, d):
        raise ValueError(f"{what} operand shapes differ: q {tuple(qw.shape)}, "
                         f"k {tuple(kw.shape)}, v {tuple(vw.shape)}")
    if w != num_words(t):
        raise ValueError(f"{w} word planes cannot carry t={t} time steps")


def sparse_packed_ssa_fwd(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                          live: torch.Tensor, *, t: int, scale: float,
                          causal: bool = False) -> torch.Tensor:
    """:func:`packed_ssa_fwd` with a (G, T) int32 plane liveness ``live``:
    output plane t of fold g is computed only where ``live[g, t]`` is
    nonzero and is zero elsewhere; no zero-sized dims, D <= 512.

    Replaces the TPU kernel
    ``repro.kernels.spiking_attention.kernel.sparse_packed_ssa_fwd``.  On the
    card: ``packed_ssa_tc_kernel<Dp, P, kGated=true>``, one block of four
    warps per (fold, 64 query rows, P planes of one word); the words are
    read once for all P planes, each plane's f16 fragments are built
    straight from the bits (1.0 is 0x3C00), and both products run on
    ``mma.sync.m16n8k16`` with f32 accumulators.  A block whose P planes are
    all dead writes zeros without staging; past D = 128 the wide kernel of
    :func:`packed_ssa_fwd`, gated by plane.  Bound by device bytes (the words
    read and the f32 output written once).  Exact for any words (bits are
    0/1, scores <= 512, key ranges as in :func:`ssa_fwd`), so the result equals
    :func:`packed_ssa_fwd` and :func:`sparse_packed_ssa_ref` bit for bit."""
    _check_packed("sparse packed ssa", qw, kw, vw, t)
    w, g, n, d = qw.shape
    m = kw.shape[2]
    if tuple(live.shape) != (g, t):
        raise ValueError(f"plane liveness {tuple(live.shape)} != {(g, t)}")
    if qw.device.type == "cpu":
        return sparse_packed_ssa_ref(qw, kw, vw, live, t=t, scale=scale, causal=causal)
    check_exact_shape("sparse_packed_ssa_fwd", d)
    _build.check_operands("sparse_packed_ssa_fwd", *((x, torch.int32)
                                                      for x in (qw, kw, vw, live)))
    out = torch.empty((t, g, n, d), dtype=torch.float32, device=qw.device)
    fn = _build.kernel("ssa", "sparse_packed_ssa_fwd", _SPARSE_ARGTYPES)
    with torch.cuda.device(qw.device):
        err = fn(qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), live.data_ptr(),
                 out.data_ptr(), g, n, m, d, t, scale, int(causal),
                 _build.stream(qw.device))
    _build.check(err, "ssa", "sparse_packed_ssa_fwd")
    sparse_packed_ssa_fwd.launches += 1
    _build.report_launch("sparse_packed_ssa_fwd", qw, kw, vw, live, out)
    return out


sparse_packed_ssa_fwd.launches = 0


def _causal_mask(scores: torch.Tensor) -> torch.Tensor:
    n, m = scores.shape[-2:]
    keep = (torch.arange(m, device=scores.device)[None, :]
            <= torch.arange(n, device=scores.device)[:, None])
    return torch.where(keep, scores, 0.0)


class _SsaOp(torch.autograd.Function):
    """Folded q (G, N, D), k/v (G, M, D) -> :func:`ssa_fwd`; backward, with
    P = (q k^T) and dP = (g v^T) * scale, both masked where ``causal``:
    dq = dP k, dk = dP^T q, dv = P^T g * scale."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        return ssa_fwd(q, k, v, scale=scale, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        mask = _causal_mask if ctx.causal else (lambda x: x)
        gs = g * ctx.scale
        d_scores = mask(torch.bmm(gs, v.transpose(1, 2)))
        dq = torch.bmm(d_scores, k) if ctx.needs_input_grad[0] else None
        dk = torch.bmm(d_scores.transpose(1, 2), q) if ctx.needs_input_grad[1] else None
        dv = None
        if ctx.needs_input_grad[2]:
            dv = torch.bmm(mask(torch.bmm(q, k.transpose(1, 2))).transpose(1, 2), gs)
        return dq, dk, dv, None, None


def ssa_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """Tick-batched spiking attention. q,k,v: (T, B, H, N, Dh) -> same shape,
    differentiable (:class:`_SsaOp`).  ``causal`` masks the spike score
    matrix to the lower triangle in-kernel."""
    t, b, h, n, dh = q.shape
    if 0 in (q.numel(), k.numel()):
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    fold = lambda x: x.reshape(t * b * h, x.shape[3], dh).contiguous()
    out = _SsaOp.apply(fold(q), fold(k), fold(v), float(scale), causal)
    return out.reshape(t, b, h, n, dh)


def packed_ssa_op(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                  scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """Packed-operand tick-batched spiking attention.  qw/kw/vw: (W, B, H, N,
    Dh) int32 words carrying all ``t`` time steps (W = ceil(t/32)) -> dense
    drive (T, B, H, N, Dh) f32.  The operand read is 1/min(t, 32) of the
    dense kernel's."""
    w, b, h, n, dh = qw.shape
    if 0 in (qw.numel(), kw.numel()):
        return torch.zeros((t, b, h, n, dh), dtype=torch.float32, device=qw.device)
    fold = lambda x: x.reshape(w, b * h, x.shape[3], dh).contiguous()
    out = packed_ssa_fwd(fold(qw), fold(kw), fold(vw), t=t, scale=float(scale),
                         causal=causal)
    return out.reshape(t, b, h, n, dh)


def _plane_liveness(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor,
                    t: int) -> torch.Tensor:
    """Per-(fold, bitplane) liveness of three packed operands, q words
    (W, G, N, D) and k/v words (W, G, M, D): (G, T) int32, 1 iff q, k and v
    each have a spike at time step t somewhere in fold g.

    A bitwise-OR reduce of each operand over its tokens and features, taken
    bit by bit (PyTorch has no OR reduction): the maximum of bit b over the
    fold says whether plane 32*w + b has a spike."""
    live = None
    for x in (qw, kw, vw):
        w, g = x.shape[:2]
        bits = torch.arange(min(t, WORD_BITS), dtype=torch.int32, device=x.device)
        planes = ((x.reshape(w, g, -1, 1) >> bits) & 1).amax(dim=2)   # (W, G, bits)
        planes = planes.permute(1, 0, 2).reshape(g, -1)[:, :t]
        live = planes if live is None else live & planes
    return live.contiguous()


def sparse_packed_ssa_op(qw: torch.Tensor, kw: torch.Tensor, vw: torch.Tensor, *, t: int,
                         scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """Plane-gated packed spiking attention: equal to :func:`packed_ssa_op`
    bit for bit, but a time step at which q, k or v of a (b, h) fold is
    silent is never unpacked or multiplied; its output plane is zero.
    qw/kw/vw: (W, B, H, N, Dh) int32 words -> (T, B, H, N, Dh) f32."""
    w, b, h, n, dh = qw.shape
    if 0 in (qw.numel(), kw.numel()):
        return torch.zeros((t, b, h, n, dh), dtype=torch.float32, device=qw.device)
    fold = lambda x: x.reshape(w, b * h, x.shape[3], dh).contiguous()
    qf, kf, vf = fold(qw), fold(kw), fold(vw)
    out = sparse_packed_ssa_fwd(qf, kf, vf, _plane_liveness(qf, kf, vf, t), t=t,
                                scale=float(scale), causal=causal)
    return out.reshape(t, b, h, n, dh)
