"""Backend selection as a plan property.

:class:`Backend` ``kind`` is ``"torch"`` (the plain PyTorch versions, on any
device -- the twin of the JAX package's ``"jnp"``) or ``"cuda"`` (the
hand-written kernels -- the twin of ``"pallas"``).  A ``"cuda"`` plan routes
every LIF, every spike GEMM (linears and im2col 3x3 convs) and every
quadratic-ordering SSA through the kernel wrappers, which launch the CUDA
kernel for a CUDA tensor and take the plain version only for a CPU tensor.

``packed`` carries the inter-layer spikes bit-packed along time
(``repro_torch.core.packing``): LIF epilogues emit words, the IAND residual
is a bitwise ``skip & ~s``.  On ``"cuda+packed"`` the words are the operands
of the packed GEMM and packed SSA kernels (:attr:`Backend.closes_ssa_boundary`);
on ``"torch+packed"`` they are unpacked at each op boundary and the plain
dense ops run -- the JAX package's ``"jnp+packed"`` route.

``sparse`` (requires ``packed``) skips work that provably contributes
nothing: every LIF pack epilogue attaches the occupancy map of its words,
and on ``"cuda+packed+sparse"`` the occupancy-gated packed GEMM skips
all-zero (64-row, 128-feature) word tiles and the plane-gated packed SSA
skips dead bitplanes; on ``"torch+packed+sparse"`` the plain route skips
8-token granules and dead planes.  Every skip is exact.

The spiking LM's ops route the same way: its Linear+RMSNorm units ride the
GEMM routes (:func:`normed_linear_apply`), its full causal SSA the quadratic
kernels, and the ops of incremental decode -- the decode step, the prefill
state, the resumable prefill chunk -- run as plain PyTorch on every backend
(the reference runs them outside any kernel), consuming words under the
closed packed boundary.

Every compute op of the deploy plan goes through this module, so a plan's
kernel route is a property of its Backend, with no exemptions at call sites.
So does every cross-rank spike edge of a sharded plan (:func:`spike_allgather`
and the packed-word collectives), on a mesh axis of ``launch.mesh``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core import nn as cnn
from repro_torch.core import packing
from repro_torch.core.lif import lif as _lif_dispatch


@dataclass(frozen=True)
class Backend:
    kind: str = "cuda"                 # "torch" | "cuda"
    packed: bool = False               # bit-packed inter-layer spikes
    sparse: bool = False               # occupancy-gated zero-word skipping

    def __post_init__(self):
        if self.kind not in ("torch", "cuda"):
            raise ValueError(f"unknown backend kind: {self.kind}")
        if self.sparse and not self.packed:
            raise ValueError(
                "Backend.sparse requires packed=True: occupancy maps are "
                "pack-time metadata of the bit-packed datapath")

    @property
    def use_kernels(self) -> bool:
        return self.kind == "cuda"

    @property
    def closes_ssa_boundary(self) -> bool:
        """True when packed q/k/v words feed the packed SSA kernel directly:
        no unpack at the attention boundary."""
        return self.packed and self.kind == "cuda"


def resolve(spec) -> Backend:
    """Coerce a user-facing spec into a Backend: Backend | "torch" | "cuda" |
    "torch+packed" | "cuda+packed" | "torch+packed+sparse" |
    "cuda+packed+sparse" (or the shorthand "cuda+sparse", which implies
    packed)."""
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, str):
        kind, sep, rest = spec.partition("+")
        flags = rest.split("+") if sep else []
        if sep and (not kind or "" in flags):
            raise ValueError(f"malformed backend spec: {spec!r}")
        bad = sorted(set(flags) - {"packed", "sparse"})
        if bad:
            raise ValueError(f"unknown backend flag(s): {bad} in {spec!r}")
        return Backend(kind, packed=bool(flags), sparse="sparse" in flags)
    raise TypeError(f"cannot resolve backend from {spec!r}")


# -- packed-word collectives: the cross-rank face of the closed boundary ----------
#
# Under a sharded plan the tensor-parallel shards exchange inter-layer spike
# activations.  These helpers keep that exchange in the packed domain: the
# collective operand is the int32 word tensor of a ``PackedSpikes`` train
# (the uint32 bit pattern; never the unpacked f32 spikes), so cross-rank
# activation bytes shrink by the same ceil(T/32)/T factor as on-chip traffic.
# Occupancy maps move alongside when their OCC_TILE tiling survives the cut
# (local feature dim a multiple of the tile), and are recomputed from the
# moved words otherwise -- either way the map stays consistent with the
# words.  ``axis`` is a ``launch.mesh.MeshAxis`` (the model axis of the
# plan's mesh); every rank of it calls the helper alike.


def word_allgather(xp: packing.PackedSpikes, axis) -> packing.PackedSpikes:
    """All-gather a feature-sharded packed train along its last (feature)
    axis: local words (W, ..., F/m) -> full words (W, ..., F), int32 on the
    wire.  Shard i's columns land at block i -- the single-device feature
    order, which keeps the downstream GEMMs exact."""
    words = axis.all_gather(xp.words, -1)
    occ = None
    if xp.occ is not None:
        occ = (axis.all_gather(xp.occ, -1) if xp.words.shape[-1] % packing.OCC_TILE == 0
               else packing.occupancy_map(words))
    return packing.PackedSpikes(words, xp.t, occ=occ)


def word_psum(xp: packing.PackedSpikes, axis) -> packing.PackedSpikes:
    """Sum partial packed trains across shards -- valid only when the shards'
    set bits are disjoint (each spike produced by exactly one shard), where
    the integer sum IS the bitwise OR (no bit carries; the int32 pattern is
    the uint32 one).  Occupancy popcounts add under the same disjointness,
    so the map sums alongside and stays exact."""
    words = axis.all_reduce(xp.words)
    occ = None if xp.occ is None else axis.all_reduce(xp.occ)
    return packing.PackedSpikes(words, xp.t, occ=occ)


def word_reduce_scatter(xp: packing.PackedSpikes, axis) -> packing.PackedSpikes:
    """Disjoint-support sum (see :func:`word_psum`) that leaves each shard
    only its block of the feature axis: words (W, ..., F) -> (W, ..., F/m).
    ``word_reduce_scatter`` then ``word_allgather`` is :func:`word_psum`."""
    words = axis.reduce_scatter(xp.words, -1)
    occ = None
    if xp.occ is not None:
        # scatter blocks align with OCC_TILE boundaries iff the local feature
        # dim is a tile multiple; otherwise recompute from the words
        occ = (axis.reduce_scatter(xp.occ, -1) if words.shape[-1] % packing.OCC_TILE == 0
               else packing.occupancy_map(words))
    return packing.PackedSpikes(words, xp.t, occ=occ)


def spike_allgather(x, axis):
    """Feature all-gather of one spike edge on any backend: packed trains
    take :func:`word_allgather` (int32 words on the wire), dense trains a
    plain f32 all-gather of the last axis.  The one entry point the executor
    uses for a cross-rank edge, so "packed backends never move unpacked
    spikes between ranks" is a property of this dispatch."""
    if isinstance(x, packing.PackedSpikes):
        return word_allgather(x, axis)
    return axis.all_gather(x, -1)


def spike_shard(x, axis):
    """This shard's feature block of a replicated spike tensor: (..., F) ->
    (..., F/m), shard i taking columns [i*F/m, (i+1)*F/m) -- the inverse of
    :func:`spike_allgather`, moving nothing.  It lands the replicated
    tokenizer output on the feature-sharded residual stream."""
    if isinstance(x, packing.PackedSpikes):
        words = axis.block(x.words, -1)
        occ = None
        if x.occ is not None:
            occ = (axis.block(x.occ, -1) if words.shape[-1] % packing.OCC_TILE == 0
                   else packing.occupancy_map(words))
        return packing.PackedSpikes(words, x.t, occ=occ)
    return axis.block(x, -1)


def unit_partition_specs(u, params: dict, rules: dict) -> dict:
    """Specs (``distributed.sharding.spec``) of one folded unit's parameter
    dict, from the layout's logical ``w_axes`` through the plan's rules: the
    weight is (d_in, d_out)-annotated, every other leaf (bias, RMS
    normalizer) is a per-output-feature vector and shards with the output
    dim."""
    from repro_torch.distributed.sharding import spec

    wspec = spec(*u.w_axes, rules=rules)
    outspec = spec(u.w_axes[1], rules=rules)
    return {k: (wspec if k == "w" else outspec) for k in params}


def lif_apply(backend: Backend, drive: torch.Tensor, *, theta, lam, schedule,
              chain_len, iand_skip=None, reset: str = "hard", pack_output: bool = False,
              occupancy: bool | None = None):
    """Route a LIF (optionally with the fused IAND epilogue) through the
    unified neuron dispatch on this backend.  With ``pack_output`` the spike
    train returns bit-packed (and ``iand_skip`` must be packed); under
    ``Backend.sparse`` the pack epilogue also attaches the occupancy map, so
    every packed train the executor produces carries its skip index
    (``occupancy`` overrides that default)."""
    if occupancy is None:
        occupancy = pack_output and backend.sparse
    return _lif_dispatch(drive, theta=theta, lam=lam, reset=reset,
                         schedule=schedule, chain_len=chain_len,
                         use_kernel=backend.use_kernels, iand_skip=iand_skip,
                         pack_output=pack_output,
                         pack_occupancy=pack_output and occupancy)


def linear_apply(backend: Backend, p, x2d: torch.Tensor) -> torch.Tensor:
    """Folded linear (w, b) on tick-folded 2-D activations."""
    if backend.use_kernels:
        from repro_torch.kernels.spike_matmul.ops import spike_matmul_op

        y = spike_matmul_op(x2d, p["w"])
    else:
        y = x2d @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def conv3x3_apply(backend: Backend, p, x: torch.Tensor) -> torch.Tensor:
    """Folded 3x3 SAME conv on (N, H, W, C) spikes."""
    if backend.use_kernels:
        from repro_torch.kernels.spike_matmul.ops import conv3x3_op

        y = conv3x3_op(x, p["w"])
        if "b" in p:
            y = y + p["b"]
        return y
    return cnn.conv_apply(p, x)


def ssa_apply(backend: Backend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *, scale: float, ordering: str = "quadratic",
              causal: bool = False) -> torch.Tensor:
    """Spiking self-attention on this backend. q/k/v: (T, B, H, N, Dh) binary
    spikes -> (T, B, H, N, Dh) f32 drive.  The kernel is the quadratic N^2
    dataflow; the linear ordering Q(K^T V) always takes the plain einsum."""
    if ordering == "quadratic" and backend.use_kernels:
        from repro_torch.kernels.spiking_attention.ops import ssa_op

        return ssa_op(q, k, v, scale=scale, causal=causal)
    from repro_torch.core.spiking_attention import ssa

    return ssa(q, k, v, scale=scale, ordering=ordering, causal=causal)


def ssa_apply_packed(backend: Backend, qp: packing.PackedSpikes,
                     kp: packing.PackedSpikes, vp: packing.PackedSpikes, *,
                     scale: float, ordering: str = "quadratic",
                     causal: bool = False) -> torch.Tensor:
    """Spiking self-attention on packed q/k/v trains (words (W, B, H, N, Dh))
    -> dense drive (T, B, H, N, Dh).

    Under :attr:`Backend.closes_ssa_boundary` the words are the attention
    operands: the quadratic ordering through the packed SSA kernel (the
    plane-gated one under ``Backend.sparse``), the linear ordering through
    the shift-and-mask ``ssa_linear_packed``.  Otherwise the quadratic
    ordering under ``Backend.sparse`` takes the plane-gated plain
    ``ssa_packed_sparse``, and everything else unpacks the trains at the op
    boundary and runs the dense route."""
    if ordering == "quadratic" and backend.closes_ssa_boundary:
        from repro_torch.kernels.spiking_attention import ops

        op = ops.sparse_packed_ssa_op if backend.sparse else ops.packed_ssa_op
        return op(qp.words, kp.words, vp.words, t=qp.t, scale=scale, causal=causal)
    if ordering == "linear" and backend.closes_ssa_boundary:
        from repro_torch.core.spiking_attention import ssa_linear_packed

        return ssa_linear_packed(qp.words, kp.words, vp.words, t=qp.t, scale=scale,
                                 causal=causal)
    if ordering == "quadratic" and backend.sparse:
        from repro_torch.core.spiking_attention import ssa_packed_sparse

        return ssa_packed_sparse(qp.words, kp.words, vp.words, t=qp.t, scale=scale,
                                 causal=causal)
    q, k, v = (packing.unpack(p) for p in (qp, kp, vp))
    return ssa_apply(backend, q, k, v, scale=scale, ordering=ordering, causal=causal)


def _kernel_takes_packed(backend: Backend, xp: packing.PackedSpikes) -> bool:
    """Feed words straight to the packed GEMM kernel?  Needs the kernel route
    and a single-word train (T <= 32); longer trains unpack and take the
    dense GEMM kernel, as in the JAX package."""
    return backend.use_kernels and xp.words.shape[0] == 1


_SPARSE_TOKEN_TILE = 8   # token rows per skip granule of the plain sparse route


def _sparse_linear_packed_torch(xp: packing.PackedSpikes, w: torch.Tensor) -> torch.Tensor:
    """Occupancy-gated packed x weight GEMM of the plain route: (W, M, K)
    words -> (T, M, C).

    The token axis is cut into :data:`_SPARSE_TOKEN_TILE`-row granules; a
    granule with no spike at any feature and time step is written as exact
    zeros and never unpacked, and the live granules are unpacked and
    contracted over the full K together, as the dense route contracts all
    rows.  The granule liveness comes from the pack-time occupancy map when
    the train carries one, else from one popcount pass over the words."""
    words, t = xp.words, xp.t
    _, m, kdim = words.shape
    tile = _SPARSE_TOKEN_TILE
    counts = xp.occ if xp.occ is not None else packing.popcount(words)
    row_occ = counts.sum(dim=(0, 2))                             # (M,)
    granule_occ = F.pad(row_occ, (0, (-m) % tile)).reshape(-1, tile).sum(dim=1)
    rows = (granule_occ > 0).repeat_interleave(tile)[:m].nonzero()[:, 0]
    y = torch.zeros((t, m, w.shape[1]), dtype=torch.float32, device=words.device)
    if rows.numel():
        live = packing.unpack(packing.PackedSpikes(words[:, rows], t))  # (T, R, K)
        y[:, rows] = (live.reshape(-1, kdim) @ w).reshape(t, rows.numel(), -1)
    return y


def linear_apply_packed(backend: Backend, p, xp: packing.PackedSpikes) -> torch.Tensor:
    """Folded linear on a packed spike train (W, ..., Din) -> dense drive
    (T, ..., Dout): the words are the GEMM operand on the kernel route,
    otherwise the train is unpacked at the op boundary.  Under
    ``Backend.sparse`` both routes consult the occupancy map and skip
    all-zero word tiles (kernel) or token granules (plain), exactly."""
    lead = xp.elem_shape[:-1]
    d_in = xp.elem_shape[-1]
    if _kernel_takes_packed(backend, xp):
        from repro_torch.kernels.spike_matmul import ops

        words = xp.words[0].reshape(-1, d_in)
        if backend.sparse:
            occ = None if xp.occ is None else xp.occ[0].reshape(-1, xp.occ.shape[-1])
            y = ops.sparse_packed_spike_matmul_op(words, p["w"], t=xp.t, occ=occ)
        else:
            y = ops.packed_spike_matmul_op(words, p["w"], t=xp.t)
        y = y.reshape((xp.t,) + lead + (p["w"].shape[1],))
    elif backend.sparse and not backend.use_kernels and math.prod(lead) >= _SPARSE_TOKEN_TILE:
        y = _sparse_linear_packed_torch(xp.reshape_elems(-1, d_in), p["w"])
        y = y.reshape((xp.t,) + lead + (p["w"].shape[1],))
    else:
        # the kernel route with multi-word trains unpacks and takes the dense
        # GEMM kernel, as on "cuda+packed"; the plain route with fewer token
        # rows than one skip granule has nothing to skip (exact either way)
        x = packing.unpack(xp)                           # (T, ..., Din)
        return linear_apply(backend, p, x.reshape(-1, d_in)).reshape((xp.t,) + lead + (-1,))
    if "b" in p:
        y = y + p["b"]
    return y


def conv3x3_apply_packed(backend: Backend, p, xp: packing.PackedSpikes) -> torch.Tensor:
    """Folded 3x3 SAME conv on packed spikes (W, N, H, Wd, C) -> dense drive
    (T, N, H, Wd, Cout).  Under ``Backend.sparse`` the patch GEMM skips
    all-zero word tiles (kernel) or patch-row granules (plain), exactly."""
    if _kernel_takes_packed(backend, xp):
        from repro_torch.kernels.spike_matmul import ops

        op = ops.sparse_packed_conv3x3_op if backend.sparse else ops.packed_conv3x3_op
        y = op(xp.words[0], p["w"], t=xp.t)
    elif backend.sparse and not backend.use_kernels and xp.words.shape[0] == 1:
        # im2col on the words; the gather scrambles the feature axis, so the
        # granule liveness is recomputed on the gathered words
        from repro_torch.kernels.spike_matmul.ops import _im2col

        n, h, wd, c = xp.words.shape[1:]
        cout = p["w"].shape[-1]
        cols = packing.PackedSpikes(_im2col(xp.words[0], 3)[None], xp.t)
        y = _sparse_linear_packed_torch(cols, p["w"].reshape(9 * c, cout))
        y = y.reshape(xp.t, n, h, wd, cout)
    else:
        x = packing.unpack(xp)                           # (T, N, H, Wd, C)
        t, n = x.shape[0], x.shape[1]
        y = conv3x3_apply(backend, p, x.reshape((t * n,) + tuple(x.shape[2:])))
        return y.reshape((t, n) + tuple(y.shape[1:]))
    if "b" in p:
        y = y + p["b"]
    return y


# -- spiking LM -----------------------------------------------------------------

def normed_linear_apply(backend: Backend, p, x2d: torch.Tensor, *, eps: float) -> torch.Tensor:
    """Folded Linear+RMSNorm unit (``fold_linear_rmsnorm``) on tick-folded 2-D
    spikes: the GEMM on the backend's route, as :func:`linear_apply`; the
    gain-free normalizer as the epilogue."""
    return cnn.rms_epilogue(p["nrm"], linear_apply(backend, p, x2d), eps=eps)


def normed_linear_apply_packed(backend: Backend, p, xp: packing.PackedSpikes, *,
                               eps: float) -> torch.Tensor:
    """Folded Linear+RMSNorm on a packed train (W, ..., Din) -> dense
    normalized drive (T, ..., Dout); the GEMM routed as in
    :func:`linear_apply_packed`."""
    return cnn.rms_epilogue(p["nrm"], linear_apply_packed(backend, p, xp), eps=eps)


def _unpack(*trains):
    return tuple(packing.unpack(p) for p in trains)


def ssa_decode_step(backend: Backend, state, q, k, v, *, scale: float):
    """One O(d^2) linear-SSA decode step: ``state`` (T, B, H, Dh, Dh), q/k/v
    (T, B, H, 1, Dh) spikes of the new token -> ``(state', drive)``.  Plain
    PyTorch on every backend: the step is two small contractions with no
    score tile to hand to a kernel."""
    from repro_torch.core.spiking_attention import ssa_linear_decode_step

    return ssa_linear_decode_step(state, q, k, v, scale=scale)


def ssa_decode_step_packed(backend: Backend, state, qp: packing.PackedSpikes,
                           kp: packing.PackedSpikes, vp: packing.PackedSpikes, *,
                           scale: float):
    """Decode step on packed q/k/v trains (words (W, B, H, 1, Dh)):
    ``Backend.sparse`` takes the word-gated step on either packed route, the
    closed boundary the word-consuming step; otherwise the trains are
    unpacked at the op boundary."""
    from repro_torch.core import spiking_attention as sa

    if backend.sparse:
        return sa.ssa_linear_decode_step_packed_sparse(state, qp.words, kp.words, vp.words,
                                                       t=qp.t, scale=scale)
    if backend.closes_ssa_boundary:
        return sa.ssa_linear_decode_step_packed(state, qp.words, kp.words, vp.words,
                                                t=qp.t, scale=scale)
    return ssa_decode_step(backend, state, *_unpack(qp, kp, vp), scale=scale)


def ssa_prefill_state(backend: Backend, k, v):
    """K^T V decode state after a whole prefix: k/v (T, B, H, S, Dh) ->
    (T, B, H, Dh, Dh); plain PyTorch on every route (one batched GEMM)."""
    from repro_torch.core.spiking_attention import ssa_kv_state

    return ssa_kv_state(k, v)


def ssa_prefill_state_packed(backend: Backend, kp: packing.PackedSpikes,
                             vp: packing.PackedSpikes):
    """Prefill decode state from packed k/v trains: word-consuming under the
    closed boundary, unpacked at the op boundary otherwise."""
    if backend.closes_ssa_boundary:
        from repro_torch.core.spiking_attention import ssa_kv_state_packed

        return ssa_kv_state_packed(kp.words, vp.words, t=kp.t)
    return ssa_prefill_state(backend, *_unpack(kp, vp))


def ssa_prefill_apply(backend: Backend, q, k, v, *, scale: float, ordering: str):
    """Full causal SSA over a prompt plus the end-of-prefix K^T V state:
    ``(drive, state)``.  Linear ordering: the causal scan, whose final carry
    is the state; quadratic: the backend's causal SSA plus one state GEMM."""
    if ordering == "linear":
        from repro_torch.core.spiking_attention import ssa_causal_linear_with_state

        return ssa_causal_linear_with_state(q, k, v, scale=scale)
    drive = ssa_apply(backend, q, k, v, scale=scale, ordering=ordering, causal=True)
    return drive, ssa_prefill_state(backend, k, v)


def ssa_prefill_apply_packed(backend: Backend, qp: packing.PackedSpikes,
                             kp: packing.PackedSpikes, vp: packing.PackedSpikes, *,
                             scale: float, ordering: str):
    """Packed-train :func:`ssa_prefill_apply`: under the closed boundary the
    words feed the packed SSA kernel plus the word-consuming state GEMM
    (quadratic) or the packed causal scan (linear); otherwise the trains are
    unpacked at the op boundary."""
    if ordering == "quadratic" and backend.closes_ssa_boundary:
        from repro_torch.core.spiking_attention import ssa_kv_state_packed

        drive = ssa_apply_packed(backend, qp, kp, vp, scale=scale, ordering=ordering,
                                 causal=True)
        return drive, ssa_kv_state_packed(kp.words, vp.words, t=kp.t)
    if ordering == "linear" and backend.closes_ssa_boundary:
        from repro_torch.core.spiking_attention import ssa_causal_linear_with_state_packed

        return ssa_causal_linear_with_state_packed(qp.words, kp.words, vp.words, t=qp.t,
                                                   scale=scale)
    return ssa_prefill_apply(backend, *_unpack(qp, kp, vp), scale=scale, ordering=ordering)


def ssa_prefill_chunk(backend: Backend, state, q, k, v, *, scale: float, ordering: str):
    """One resumable prefill chunk: causal SSA over the chunk's q/k/v, seeded
    by the running K^T V ``state`` of everything consumed before ->
    ``(drive, state')``; chained over any chunking of a prompt it equals
    :func:`ssa_prefill_apply` over the whole prompt, bit for bit.  Linear:
    the scan seeded with the state; quadratic: the backend's intra-chunk
    causal SSA plus the read of the state and one state GEMM."""
    if ordering == "linear":
        from repro_torch.core.spiking_attention import ssa_causal_linear_with_state

        return ssa_causal_linear_with_state(q, k, v, scale=scale, state=state)
    from repro_torch.core.spiking_attention import ssa_state_read

    drive = ssa_apply(backend, q, k, v, scale=scale, ordering=ordering, causal=True)
    drive = drive + ssa_state_read(state, q, scale=scale)
    return drive, state + ssa_prefill_state(backend, k, v)


def ssa_prefill_chunk_packed(backend: Backend, state, qp: packing.PackedSpikes,
                             kp: packing.PackedSpikes, vp: packing.PackedSpikes, *,
                             scale: float, ordering: str):
    """Packed-train :func:`ssa_prefill_chunk`: the chunk's words are the
    operands everywhere under the closed boundary; otherwise unpacked at the
    op boundary."""
    from repro_torch.core import spiking_attention as sa

    if ordering == "linear" and backend.closes_ssa_boundary:
        return sa.ssa_causal_linear_with_state_packed(qp.words, kp.words, vp.words, t=qp.t,
                                                      scale=scale, state=state)
    if ordering == "quadratic" and backend.closes_ssa_boundary:
        drive = ssa_apply_packed(backend, qp, kp, vp, scale=scale, ordering=ordering,
                                 causal=True)
        drive = drive + sa.ssa_state_read_packed(state, qp.words, t=qp.t, scale=scale)
        return drive, state + ssa_prefill_state_packed(backend, kp, vp)
    return ssa_prefill_chunk(backend, state, *_unpack(qp, kp, vp), scale=scale,
                             ordering=ordering)
