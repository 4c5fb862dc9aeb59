"""Deploy-plan executor: folded weights in, logits out.

Walks the same layer list (``engine.layout``) as the eval graph, in the
accelerator's deploy view:

* each stage/unit is ONE folded weight read (Conv/Linear with the BN baked
  in) -- no separate BN pass over the activations;
* every AND-NOT residual executes inside the LIF dispatch's epilogue
  (``iand_skip``), so spikes are written once -- no standalone IAND pass;
* all Conv/Linear compute is tick-batched (T folded into the batch: one
  weight read serves all time steps).

On a ``packed`` backend the spikes between layers are bit-packed along time
(``repro_torch.core.packing``): every LIF epilogue emits words, the residual
is the bitwise AND-NOT on words, and the head rate-decodes by popcount, so
the packed executor never unpacks a train itself.  Under ``Backend.sparse``
every LIF pack epilogue also attaches the occupancy map of its words, which
rides along with the train (``reshape_elems`` keeps it, the head split drops
it) to the sparse consumers.

LM plans (``PlanMeta.family == "lm"``) walk the same unit list with the LM
specifics: folded Linear+RMSNorm units (GEMM on gain-folded weights plus the
gain-free normalizer epilogue), causal SSA, every residual join fused, the
pre-normalized embedding table in place of the tokenizer, and the
rate-decoded head, whose inline RMSNorm is the one norm the plan keeps.  They
also decode incrementally (:func:`prefill`, :func:`prefill_chunk`,
:func:`decode_step` and their ``make_*_fn`` factories): the causal SSA's
linear ordering has an O(d^2)-per-head running K^T V state
(:class:`DecodeState`), so generation never re-scores the prefix.

All compute -- linears, convs and attention -- goes through
``repro_torch.engine.backend``; the executor never calls a kernel or a plain
version directly, so the plan's backend decides the compute route.

A plan compiled with ``mesh=`` runs SPMD over a ``torch.distributed`` world:
every rank calls the same executor with the same global arguments, runs its
data shard through the same walkers with its model shard, and all-gathers
the head's input over ``data``, so every rank returns the global result,
equal to the ``mesh=None`` plan's bit for bit.  Every cross-rank exchange of the
walkers goes through one small op table (:class:`_MeshOps`) whose null value
is the identity.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import nn as cnn
from repro_torch.core import packing
from repro_torch.core.iand import connective
from repro_torch.core.spiking_attention import merge_heads, split_heads, split_heads_packed
from repro_torch.engine import backend as B
from repro_torch.engine.plan import DeployPlan, PlanMeta


# active spike tap (``capture_spikes``): every packed train a LIF epilogue
# emits is appended here -- None when no capture is active
_spike_tap: list | None = None


@contextlib.contextmanager
def capture_spikes():
    """Capture every packed spike train the executor's LIF epilogues emit.

    ``with capture_spikes() as taps: engine.apply(plan, batch)`` leaves
    ``taps`` holding one ``PackedSpikes`` per LIF dispatch, in execution
    order -- the input of ``engine.analysis.sparsity_report``."""
    global _spike_tap
    prev, _spike_tap = _spike_tap, []
    try:
        yield _spike_tap
    finally:
        _spike_tap = prev


def _lif(meta: PlanMeta, drive, iand_skip=None, pack_output: bool = False,
         occupancy: bool | None = None):
    cfg = meta.cfg
    out = B.lif_apply(meta.backend, drive, theta=cfg.theta, lam=cfg.lam,
                      schedule=cfg.lif_schedule, chain_len=cfg.chain_len,
                      iand_skip=iand_skip, pack_output=pack_output, occupancy=occupancy)
    if _spike_tap is not None and isinstance(out, packing.PackedSpikes):
        _spike_tap.append(out)
    return out


# -- mesh execution ------------------------------------------------------------
#
# A sharded plan runs the SAME walkers, with every cross-shard exchange routed
# through one small op table (:class:`_MeshOps`).  The table's null value is
# the identity on every method, and the walkers default to it -- so the
# single-device path is unchanged and the sharded path cannot structurally
# diverge from it.  The two families shard differently
# (``distributed.sharding.ENGINE_FAMILY_OVERRIDES``):
#
# * vision (``feature_tp``): column-parallel units -- the residual spike
#   stream lives feature-sharded between joins, and each unit consumes the
#   gathered full-feature stream (``gather_stream``, cached per stream
#   version) while producing only its local output columns.  Four feature
#   all-gathers per block, each of packed words under packed backends.
# * lm: units replicated (the folded RMSNorm epilogue reduces over the full
#   feature row -- column slices would reassociate it); the model axis
#   shards the SSA heads instead: ``wrap_ssa`` slices the local heads out of
#   the head-split q/k/v, and the attention LIF output is the one cross-rank
#   spike edge per block (``gather_heads``).


def _slice_heads(x, idx: int, h_loc: int):
    """Local head block of head-split q/k/v: dense (T, B, H, N, Dh) or packed
    words (W, B, H, N, Dh) -> the ``h_loc`` heads from ``idx * h_loc`` (the
    head axis is axis 2 in both layouts; the head split carries no
    occupancy map)."""
    if isinstance(x, packing.PackedSpikes):
        return packing.PackedSpikes(x.words.narrow(2, idx * h_loc, h_loc), x.t)
    return x.narrow(2, idx * h_loc, h_loc)


@dataclass(frozen=True)
class _MeshOps:
    """Cross-shard exchange table of one sharded execution: ``tp_axis`` and
    ``dp_axis`` are the mesh's model and data axes
    (``launch.mesh.MeshAxis``); with none, or ones of size 1, every method
    is the identity (:data:`_NULL_OPS`)."""

    tp_axis: Any = None
    dp_axis: Any = None
    feature_tp: bool = True     # vision column-parallel vs LM head-sharded

    @property
    def tp(self) -> int:
        return 1 if self.tp_axis is None else self.tp_axis.size

    def batch_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This data shard's rows of a global batch (the batch must divide by
        the data axis)."""
        if self.dp_axis is None or self.dp_axis.size == 1:
            return x
        if x.shape[0] % self.dp_axis.size:
            raise ValueError(f"the global batch {x.shape[0]} must divide by the mesh's "
                             f"data axis {self.dp_axis.size}")
        return self.dp_axis.block(x, 0)

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The data shards' rows of a head's input -> the global batch, so the
        replicated head runs on exactly the single-device plan's rows (an
        f32 GEMM's sum order may depend on its row count -- cuBLAS and the
        CPU's BLAS both pick kernels by shape -- so the head never runs on
        a shard's rows alone).  Every rank then holds the global result."""
        if self.dp_axis is None or self.dp_axis.size == 1:
            return x
        return self.dp_axis.all_gather(x, 0, kind="output")

    def local_heads(self, h: int) -> int:
        """Heads resident on this shard (vision: the q/k/v units already
        produced only the local head columns)."""
        return h // self.tp if (self.feature_tp and self.tp > 1) else h

    def gather_stream(self, x):
        """Feature-sharded residual stream -> full feature row (the view every
        column-parallel unit GEMM consumes)."""
        if self.feature_tp and self.tp > 1:
            return B.spike_allgather(x, self.tp_axis)
        return x

    def shard_stream(self, x):
        """Replicated spikes -> this shard's feature block (lands the
        tokenizer output on the feature-sharded residual stream)."""
        if self.feature_tp and self.tp > 1:
            return B.spike_shard(x, self.tp_axis)
        return x

    def gather_heads(self, x):
        """Locally produced spike features -> full feature row (the
        post-attention / post-fc1 all-gather; packed words on the wire under
        packed backends)."""
        if self.tp > 1:
            return B.spike_allgather(x, self.tp_axis)
        return x

    def wrap_ssa(self, ssa):
        """LM head parallelism: run the walker's attention on this shard's
        head block only (binary-spike SSA is exact integer arithmetic per
        head, so head-local compute is bit-exact)."""
        if self.feature_tp or self.tp == 1:
            return ssa

        def sharded_ssa(q, k, v):
            h = (q.words if isinstance(q, packing.PackedSpikes) else q).shape[2]
            idx, h_loc = self.tp_axis.rank, h // self.tp
            return ssa(_slice_heads(q, idx, h_loc), _slice_heads(k, idx, h_loc),
                       _slice_heads(v, idx, h_loc))

        return sharded_ssa


_NULL_OPS = _MeshOps()


def _encode(p, image, ops: _MeshOps):
    """The analog encoding conv (the input is not binary, so it stays on the
    plain conv on every backend).  It runs on the GLOBAL batch and each data
    shard keeps its rows: the conv library picks its algorithm, and so its
    sum order, by shape, and only the single-device plan's shape gives the
    single-device plan's bits.  The rest of the tokenizer runs on the
    shard's rows."""
    return ops.batch_rows(cnn.conv_apply(p, image))


def _tokenizer_exec(meta: PlanMeta, tok_params, image, ops: _MeshOps = _NULL_OPS):
    """image: (B, H, W, C) analog in [0, 1] -> spikes (T, B, N, D) (under a
    data-sharded mesh: the global images in, this shard's rows out)."""
    cfg = meta.cfg
    x = None
    for stage, p in zip(meta.tok_stages, tok_params):
        if stage.encode:
            # encoding layer: analog conv once, broadcast across T
            y = _encode(p, image, ops)
            if stage.pool:
                y = cnn.maxpool(y)
            drive = y[None].expand((cfg.t,) + tuple(y.shape))
        else:
            y = B.conv3x3_apply(meta.backend, p, cnn.fold_time(x))  # one weight read
            if stage.pool:
                y = cnn.maxpool(y)
            drive = cnn.unfold_time(y, cfg.t)
        x = _lif(meta, drive)
    t, b, h, w, d = x.shape
    return x.reshape(t, b, h * w, d)


def _unit_linear(meta: PlanMeta, p, x):
    """Tick-batched folded linear on (T, B, N, Din) spikes."""
    t, b, n, _ = x.shape
    return B.linear_apply(meta.backend, p, x.reshape(t * b * n, -1)).reshape(t, b, n, -1)


def _block_exec(meta: PlanMeta, bparams, x, *, ops: _MeshOps = _NULL_OPS, xg=None):
    """One block in deploy form. x: (T, B, N, D) spikes (the local feature
    block under a feature-sharded mesh; ``xg`` caches the gathered full row
    per residual-stream version -- a caller that already holds the full row,
    like the first block after the replicated tokenizer, passes it in, so no
    redundant gather runs)."""
    cfg = meta.cfg
    res = connective(cfg.residual)   # only reached for residual="add"
    acts: dict = {}
    h = None
    for u in meta.block_units:
        if u.role == "qkv":
            if xg is None:
                xg = ops.gather_stream(x)
            acts[u.name] = _lif(meta, _unit_linear(meta, bparams[u.name], xg))
            continue
        if u.role == "attn_out":
            heads = ops.local_heads(cfg.num_heads)
            attn = B.ssa_apply(
                meta.backend, *(split_heads(acts[n], heads) for n in "qkv"),
                scale=cfg.attn_scale, ordering=cfg.attn_ordering)
            attn = _lif(meta, merge_heads(attn))          # attn spikes
            drive = _unit_linear(meta, bparams[u.name], ops.gather_heads(attn))
        elif u.role == "mlp_hidden":
            if xg is None:
                xg = ops.gather_stream(x)
            h = _lif(meta, _unit_linear(meta, bparams[u.name], xg))
            continue
        elif u.role == "mlp_out":
            drive = _unit_linear(meta, bparams[u.name], ops.gather_heads(h))
        else:
            raise ValueError(f"unknown unit role: {u.role}")
        if u.fuse_residual:      # AND-NOT inside the LIF epilogue
            x = _lif(meta, drive, iand_skip=x)
        else:
            x = res(x, _lif(meta, drive))
        xg = None                # the residual stream advanced: stale gather
    return x


# -- packed datapath ---------------------------------------------------------

def _tokenizer_exec_packed(meta: PlanMeta, tok_params, image,
                           ops: _MeshOps = _NULL_OPS) -> packing.PackedSpikes:
    """image: (B, H, W, C) analog -> packed spikes, words (W, B, N, D)."""
    cfg = meta.cfg
    xp = None
    for stage, p in zip(meta.tok_stages, tok_params):
        if stage.encode:
            # analog encoding conv: same as the dense path (input not binary)
            y = _encode(p, image, ops)
            if stage.pool:
                y = cnn.maxpool(y)
            drive = y[None].expand((cfg.t,) + tuple(y.shape))
        else:
            drive = B.conv3x3_apply_packed(meta.backend, p, xp)   # (T, B, H, W, C)
            if stage.pool:
                drive = cnn.unfold_time(cnn.maxpool(cnn.fold_time(drive)), cfg.t)
        xp = _lif(meta, drive, pack_output=True)
    _, b, h, wd, d = xp.words.shape
    return xp.reshape_elems(b, h * wd, d)


def _unit_linear_packed(meta: PlanMeta, p, xp: packing.PackedSpikes):
    """Packed-operand folded linear: words (W, B, N, Din) -> drive (T, B, N, Dout)."""
    return B.linear_apply_packed(meta.backend, p, xp)


def _block_exec_packed(meta: PlanMeta, bparams, xp: packing.PackedSpikes, *,
                       ops: _MeshOps = _NULL_OPS, xg=None):
    """One block on packed activations.  Only reached for residual='iand'
    (compile_plan rejects packed ADD plans), so every residual join is the
    bitwise AND-NOT in a LIF epilogue.  Under a mesh every cross-shard
    gather here moves int32 words (``backend.word_allgather``); ``xg`` as in
    :func:`_block_exec`."""
    cfg = meta.cfg
    acts: dict = {}
    h = None
    for u in meta.block_units:
        if u.role == "qkv":
            if xg is None:
                xg = ops.gather_stream(xp)
            acts[u.name] = _lif(meta, _unit_linear_packed(meta, bparams[u.name], xg),
                                pack_output=True)
            continue
        if u.role == "attn_out":
            # q/k/v stay packed through the head split; the backend feeds the
            # words to the packed SSA kernel (or unpacks at its own op boundary)
            heads = ops.local_heads(cfg.num_heads)
            attn = B.ssa_apply_packed(
                meta.backend, *(split_heads_packed(acts[n], heads) for n in "qkv"),
                scale=cfg.attn_scale, ordering=cfg.attn_ordering)
            attn_sp = _lif(meta, merge_heads(attn), pack_output=True)
            drive = _unit_linear_packed(meta, bparams[u.name], ops.gather_heads(attn_sp))
        elif u.role == "mlp_hidden":
            if xg is None:
                xg = ops.gather_stream(xp)
            h = _lif(meta, _unit_linear_packed(meta, bparams[u.name], xg),
                     pack_output=True)
            continue
        elif u.role == "mlp_out":
            drive = _unit_linear_packed(meta, bparams[u.name], ops.gather_heads(h))
        else:
            raise ValueError(f"unknown unit role: {u.role}")
        xp = _lif(meta, drive, iand_skip=xp, pack_output=True)
        xg = None                # the residual stream advanced: stale gather
    return xp


def _rate_head(head_params, counts: torch.Tensor, steps: int, ops: _MeshOps = _NULL_OPS):
    """Rate decoding: spike counts summed over (T, tokens) -> mean rate ->
    logits.  ``counts``: (B, N, D) per-token counts over T (exact integers),
    ``steps`` = T * N.  The dense and packed heads share this one division,
    so they agree bit for bit; the rates are gathered over the data shards
    before the head (``_MeshOps.gather_batch``)."""
    return cnn.linear_apply(head_params, ops.gather_batch(counts.sum(dim=1).float() / steps))


def _head_packed(meta: PlanMeta, head_params, xp: packing.PackedSpikes,
                 ops: _MeshOps = _NULL_OPS):
    """Rate decoding by popcount: mean over (T, tokens) without unpacking."""
    return _rate_head(head_params, packing.spike_counts(xp), xp.t * xp.elem_shape[1], ops)


def _execute(meta: PlanMeta, params, batch, *, ops: _MeshOps = _NULL_OPS):
    """The global batch -> the global logits, on every rank of a mesh."""
    if meta.family == "lm":
        return _lm_exec(meta, params, ops.batch_rows(batch), ops=ops)
    if meta.backend.packed:
        xg = _tokenizer_exec_packed(meta, params["tokenizer"], batch, ops)
        xp = ops.shard_stream(xg)       # land on the feature-sharded stream
        for bparams in params["blocks"]:
            # the replicated tokenizer output doubles as the first block's
            # gathered view: the tokenizer edge never crosses ranks
            xp = _block_exec_packed(meta, bparams, xp, ops=ops, xg=xg)
            xg = None
        return _head_packed(meta, params["head"], ops.gather_stream(xp), ops)
    xg = _tokenizer_exec(meta, params["tokenizer"], batch, ops)
    x = ops.shard_stream(xg)
    for bparams in params["blocks"]:
        x = _block_exec(meta, bparams, x, ops=ops, xg=xg)
        xg = None
    x = ops.gather_stream(x)                 # the replicated head reads the full row
    t, _, n, _ = x.shape                     # rate decoding over (T, tokens)
    return _rate_head(params["head"], x.sum(dim=0), t * n, ops)


# -- sharded executor construction ---------------------------------------------


def _mesh_ops(meta: PlanMeta) -> _MeshOps:
    """The op table of a sharded plan on its host mesh (the mesh laid out at
    compile time, shrunk if the world was short -- the table reads the
    actual axis sizes)."""
    scfg = meta.sharding
    return _MeshOps(tp_axis=meta.mesh.axis(scfg.model_axis),
                    dp_axis=meta.mesh.axis(scfg.data_axis), feature_tp=(meta.family != "lm"))


def make_apply_fn(plan: DeployPlan):
    """``fn(params, batch) -> logits`` with the plan's static metadata closed
    over.  ``batch``: (B, H, W, C) float32 images, or for an LM plan (B, S)
    int64 tokens (or ``{"tokens": ...}``), on the plan's device.

    Plans compiled with ``mesh=`` take the global batch on every rank: each
    rank runs its rows of it (the batch must divide by the data axis) with
    its parameter slices, and the head's input is all-gathered over ``data``, so
    every rank returns the global logits, bit-exact against the unsharded
    plan."""
    meta = plan.meta
    if meta.sharding is None:
        return functools.partial(_execute, meta)
    ops = _mesh_ops(meta)

    def fn(params, batch):
        return _execute(meta, params, batch["tokens"] if isinstance(batch, dict) else batch,
                        ops=ops)

    return fn


def _tokens(plan: DeployPlan, tokens) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))   # a copy: writable
    return tokens.to(device=plan.meta.device, dtype=torch.long)


def apply(plan: DeployPlan, batch) -> torch.Tensor:
    """One-shot convenience: run the plan on a batch (a tensor or a numpy
    array, moved to the plan's device): images, or for an LM plan (B, S)
    tokens (or ``{"tokens": ...}``) -> logits (B, S, V)."""
    if plan.meta.family == "lm":
        batch = _tokens(plan, batch["tokens"] if isinstance(batch, dict) else batch)
    else:
        batch = torch.as_tensor(batch, dtype=torch.float32, device=plan.meta.device)
    with torch.inference_mode():
        return make_apply_fn(plan)(plan.params, batch)


# -- spiking LM -----------------------------------------------------------------

def _require_full_f32(x: torch.Tensor) -> None:
    """The head and the decode-state contractions run on cuBLAS's f32 GEMMs;
    with TF32 allowed, cuBLAS would round their operands to 10 bits of
    mantissa (state entries are integers up to the context length, and the
    head's logits would drift)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the LM plan's f32 matmuls need "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _lm_unit(meta: PlanMeta, p, x):
    """Tick-batched folded Linear+RMSNorm unit on (T, B, S, Din) spikes."""
    t, b, s, _ = x.shape
    y = B.normed_linear_apply(meta.backend, p, x.reshape(t * b * s, -1), eps=meta.cfg.norm_eps)
    return y.reshape(t, b, s, -1)


def _lm_unit_packed(meta: PlanMeta, p, xp: packing.PackedSpikes):
    """Packed-operand folded Linear+RMSNorm: words (W, B, S, Din) -> drive
    (T, B, S, Dout)."""
    return B.normed_linear_apply_packed(meta.backend, p, xp, eps=meta.cfg.norm_eps)


def _lm_full_ssa(meta: PlanMeta, packed: bool, q, k, v):
    """The walker's default attention: full causal SSA on the plan's backend."""
    op = B.ssa_apply_packed if packed else B.ssa_apply
    return op(meta.backend, q, k, v, scale=meta.cfg.attn_scale,
              ordering=meta.cfg.attn_ordering, causal=True)


def _lm_block_exec(meta: PlanMeta, bparams, x, *, packed: bool, ssa=None,
                   lif_occupancy=None, ops: _MeshOps = _NULL_OPS):
    """One spiking-LM decoder block in deploy form: x is (T, B, S, D) spikes,
    or a ``PackedSpikes`` (words (W, B, S, D)) when ``packed``.

    One walker for every datapath: ``packed`` swaps the unit and head-split
    ops and makes the LIF epilogues emit words, and ``ssa`` (a callable over
    the head-split q/k/v, by default the full causal SSA) is the only thing
    the prefill, chunk and decode executors replace -- so the full, prefill
    and per-token plans cannot diverge.  Under a head-sharded mesh ``ops``
    runs the attention on this shard's heads and gathers its spikes."""
    cfg = meta.cfg
    unit = _lm_unit_packed if packed else _lm_unit
    split = split_heads_packed if packed else split_heads
    if ssa is None:
        ssa = functools.partial(_lm_full_ssa, meta, packed)
    ssa = ops.wrap_ssa(ssa)     # head-sharded mesh: the local head block only
    acts: dict = {}
    h = None
    for u in meta.block_units:
        if u.role == "qkv":
            acts[u.name] = _lif(meta, unit(meta, bparams[u.name], x), pack_output=packed,
                                occupancy=lif_occupancy)
            continue
        if u.role == "attn_out":
            attn = ssa(*(split(acts[n], cfg.num_heads) for n in "qkv"))
            attn_sp = _lif(meta, merge_heads(attn), pack_output=packed,
                           occupancy=lif_occupancy)
            # the LM's one cross-rank spike edge: local-head attention spikes
            # -> the full feature row the replicated proj consumes
            drive = unit(meta, bparams[u.name], ops.gather_heads(attn_sp))
        elif u.role == "mlp_hidden":
            h = _lif(meta, unit(meta, bparams[u.name], x), pack_output=packed,
                     occupancy=lif_occupancy)
            continue
        elif u.role == "mlp_out":
            drive = unit(meta, bparams[u.name], h)
        else:
            raise ValueError(f"unknown unit role: {u.role}")
        # AND-NOT inside the LIF epilogue (bitwise skip & ~s on words)
        x = _lif(meta, drive, iand_skip=x, pack_output=packed, occupancy=lif_occupancy)
    return x


def _lm_head(meta: PlanMeta, params, rate):
    """Rate (B, S, D) -> logits (B, S, V): the RMSNorm inline (the one norm of
    the plan: its input is the rate code, not a linear's output) and a plain
    f32 GEMM, as in the reference."""
    from repro_torch.models.layers import rmsnorm_raw

    normed = rmsnorm_raw(params["final_norm"], rate, eps=meta.cfg.norm_eps)
    return normed @ params["head"]["w"].to(normed.dtype)


def _lm_embed_drive(meta: PlanMeta, embed_params, tokens):
    """tokens (B, S) -> LIF drive (T, B, S, D) from the pre-normalized table,
    broadcast over T and made contiguous (the kernels take a dense layout)."""
    emb = embed_params["table"][tokens]
    return emb[None].expand((meta.cfg.t,) + tuple(emb.shape)).contiguous()


def _lm_rate(meta: PlanMeta, params, x, *, packed: bool):
    """Spike train -> analog rate code (B, S, D): the mean over T, or the
    popcount over T on words.  Counts are exact integers and each is divided
    once by T, so the two agree bit for bit."""
    if not packed:
        return x.mean(dim=0)
    dtype = params["embed"]["table"].dtype
    return packing.spike_counts(x).to(dtype) / x.t


def _lm_exec(meta: PlanMeta, params, tokens, ssas=None, *, lif_occupancy=None, x=None,
             ops: _MeshOps = _NULL_OPS):
    """tokens (B, S) -> logits (B, S, V): the encoding LIF (or the encoding
    train ``x`` given), every block (with its walker attention from ``ssas``,
    by default the full causal SSA), the head.  Under a data-sharded mesh
    ``tokens`` are this shard's rows and the logits the global batch's."""
    packed = meta.backend.packed
    _require_full_f32(params["head"]["w"])
    if x is None:
        x = _lif(meta, _lm_embed_drive(meta, params["embed"], tokens), pack_output=packed,
                 occupancy=lif_occupancy)
    for bparams, ssa in zip(params["blocks"], ssas or [None] * len(params["blocks"])):
        x = _lm_block_exec(meta, bparams, x, packed=packed, ssa=ssa,
                           lif_occupancy=lif_occupancy, ops=ops)
    # the rates of every data shard, so the head runs on the global rows
    return _lm_head(meta, params, ops.gather_batch(_lm_rate(meta, params, x, packed=packed)))


# -- incremental LM decode ---------------------------------------------------------
#
# Everything outside the SSA is positionally local in the LM block (folded
# units, RMS epilogues and LIF chains act per token; a token's IAND skip is its
# own residual spikes), so each layer's K^T V state is the only cross-token
# memory a decode needs, and stepping is bit-exact against the full forward
# (binary spikes make the attention exact integer arithmetic).


@dataclass(frozen=True)
class DecodeState:
    """Carried state of an incremental LM decode: one (T, B, H, Dh, Dh)
    linear-SSA K^T V accumulator per layer, and ``pos``, the tokens consumed
    (a 0-d int32 tensor, or one per slot of a serving batch).  Constant in
    size at any context length (``PlanMeta.decode`` records the geometry).
    A step returns a new state and leaves its input as it was.

    The state of a sharded plan is sharded as the JAX package shards it --
    batch over ``data``, heads over ``model``: ``kv`` holds this rank's
    (T, B/d, H/m, Dh, Dh) block of each layer, for good (no state moves per
    token), ``pos`` stays global, and ``mesh`` names the plan's host mesh
    (None for a single-device state).  :func:`decode_state_full` gathers it."""

    kv: tuple[torch.Tensor, ...]
    pos: torch.Tensor
    mesh: Any = None


def _decode_entry(meta: PlanMeta):
    if meta.decode is None:
        raise ValueError(
            f"incremental decode is an LM-plan mode; family={meta.family!r} "
            "plans have no causal running-state decomposition")
    return meta.decode


def _state_axes(mesh):
    """(data axis, model axis) of a sharded state's mesh, by the engine's
    axis names."""
    return mesh.axis(mesh.axis_names[0]), mesh.axis(mesh.axis_names[1])


def _zero_state(meta: PlanMeta, batch: int, pos_shape: tuple) -> DecodeState:
    entry = _decode_entry(meta)
    shapes = entry.state_shapes(batch)
    if meta.sharding is not None:
        data, model = _state_axes(meta.mesh)
        if batch % data.size:
            raise ValueError(f"a sharded decode state's batch {batch} must divide by the "
                             f"data axis {data.size}")
        t, b, h, dh, _ = shapes[0]
        shapes = [(t, b // data.size, h // model.size, dh, dh)] * len(shapes)
    return DecodeState(
        kv=tuple(torch.zeros(s, dtype=torch.float32, device=meta.device) for s in shapes),
        pos=torch.zeros(pos_shape, dtype=torch.int32, device=meta.device), mesh=meta.mesh)


def decode_state_init(meta: PlanMeta, batch: int) -> DecodeState:
    """Zero ``DecodeState`` for ``batch`` sequences on the plan's device (a
    sharded plan's: this rank's block of it)."""
    return _zero_state(meta, batch, ())


# -- decode-state paging (continuous batching) ---------------------------------------
#
# The rows of a batched DecodeState are independent (the K^T V accumulators carry
# no cross-row terms, and nothing in a step mixes rows), so a serving scheduler
# can page sequences in and out of one live batched state: prefill a new prompt
# at its own length, copy its per-layer planes into a freed slot, and keep
# stepping the one slot-batch shape (``launch.scheduler``).  Each helper returns
# a new state and leaves its inputs as they were.  On a sharded state a slot
# lives on the data shard that owns its row and each kv plane stays on the
# model shard that owns its heads; a row moves between ranks only when the
# source row and the slot lie on different data shards.


def decode_state_batch_init(meta: PlanMeta, slots: int) -> DecodeState:
    """Zero batched ``DecodeState`` for a ``slots``-wide serving batch on the
    plan's device, with a per-slot position vector ``pos`` of shape (slots,)
    int32 (slots decode at ragged depths; ``decode_step``'s ``pos + 1``
    advances it elementwise)."""
    return _zero_state(meta, slots, (slots,))


def decode_state_scatter(batch_state: DecodeState, slot: int, seq_state: DecodeState,
                         src: int = 0) -> DecodeState:
    """Page row ``src`` of ``seq_state`` into slot ``slot`` of a batched state:
    each per-layer plane is cloned and row ``src`` copied into it on the batch
    axis (axis 1 of the (T, B, H, Dh, Dh) planes), and the slot's position
    takes the source's token count (``seq_state.pos`` 0-d, or a vector read at
    ``src``).  The target must carry a per-slot ``pos`` vector.

    A sharded target takes a source of its own mesh (the row is broadcast
    over ``data`` from the rank holding it when another data shard owns the
    slot; the scheduler picks a source row on the slot's own shard, so no
    state moves) or a single-device source (this rank keeps its heads of
    the row).  Every rank calls it alike."""
    if batch_state.pos.ndim == 0:
        raise ValueError(
            "scatter target must carry a per-slot pos vector (use "
            "decode_state_batch_init for the serving batch)")
    src_pos = seq_state.pos if seq_state.pos.ndim == 0 else seq_state.pos[src]
    index = torch.full((1,), slot, dtype=torch.long, device=batch_state.pos.device)
    pos = batch_state.pos.clone().index_copy_(0, index, src_pos.reshape(1))
    if batch_state.mesh is None:
        if seq_state.mesh is not None:
            raise ValueError("a sharded state pages only into a state of its own mesh")
        kv = tuple(bkv.clone().index_copy_(1, index, skv.narrow(1, src, 1))
                   for bkv, skv in zip(batch_state.kv, seq_state.kv))
        return DecodeState(kv=kv, pos=pos)
    data, model = _state_axes(batch_state.mesh)
    bl = batch_state.kv[0].shape[1]
    owner, local = divmod(slot, bl)
    if seq_state.mesh is None:                  # a single-device row: take our heads
        h_loc = batch_state.kv[0].shape[2]
        rows = [skv.narrow(1, src, 1).narrow(2, model.rank * h_loc, h_loc)
                for skv in seq_state.kv]
    elif seq_state.mesh is batch_state.mesh:
        sl = seq_state.kv[0].shape[1]
        holder, src_local = divmod(src, sl)
        rows = [skv.narrow(1, min(src_local, sl - 1), 1) for skv in seq_state.kv]
        if holder != owner:
            rows = [data.broadcast(r.contiguous(), holder) for r in rows]
    else:
        raise ValueError("a sharded state pages only into a state of its own mesh")
    if data.rank != owner:
        return DecodeState(kv=batch_state.kv, pos=pos, mesh=batch_state.mesh)
    at = torch.full((1,), local, dtype=torch.long, device=batch_state.pos.device)
    kv = tuple(bkv.clone().index_copy_(1, at, r) for bkv, r in zip(batch_state.kv, rows))
    return DecodeState(kv=kv, pos=pos, mesh=batch_state.mesh)


def decode_state_gather(batch_state: DecodeState, slot: int) -> DecodeState:
    """Slot ``slot`` of a batched state as a batch-1 ``DecodeState`` (a copy;
    the inverse of :func:`decode_state_scatter`).  On a sharded state every
    rank gets the whole row as a single-device state (its heads gathered
    over ``model`` on the slot's data shard, then broadcast over ``data``)."""
    pos = batch_state.pos if batch_state.pos.ndim == 0 else batch_state.pos[slot]
    if batch_state.mesh is None:
        kv = tuple(bkv[:, slot:slot + 1].clone() for bkv in batch_state.kv)
        return DecodeState(kv=kv, pos=pos.clone())
    data, model = _state_axes(batch_state.mesh)
    owner, local = divmod(slot, batch_state.kv[0].shape[1])
    kv = tuple(data.broadcast(model.all_gather(bkv[:, local:local + 1].contiguous(), 2,
                                               kind="state"), owner)
               for bkv in batch_state.kv)
    return DecodeState(kv=kv, pos=pos.clone())


def decode_state_full(state: DecodeState) -> DecodeState:
    """The whole state of a sharded decode on every rank, as a single-device
    state: each layer's blocks all-gathered over ``data`` (batch, axis 1)
    and ``model`` (heads, axis 2).  A single-device state is returned as it
    is."""
    if state.mesh is None:
        return state
    data, model = _state_axes(state.mesh)
    kv = tuple(data.all_gather(model.all_gather(x, 2, kind="state"), 1, kind="state")
               for x in state.kv)
    return DecodeState(kv=kv, pos=state.pos)


def _check_layers(meta: PlanMeta, state: DecodeState) -> None:
    entry = _decode_entry(meta)
    if len(state.kv) != entry.num_layers:
        raise ValueError(f"DecodeState carries {len(state.kv)} layer states, plan has "
                         f"{entry.num_layers} layers")
    if state.mesh is not meta.mesh:
        raise ValueError("a plan steps only a DecodeState of its own mesh (sharded plans: "
                         "the state their prefill or decode_state_init made)")


def _prefill_ssa(meta: PlanMeta, packed: bool, out_kv: list):
    """Walker attention of prefill: the full causal SSA plus the layer's
    end-of-prefix K^T V state, appended to ``out_kv``."""

    def ssa(q, k, v):
        op = B.ssa_prefill_apply_packed if packed else B.ssa_prefill_apply
        drive, state = op(meta.backend, q, k, v, scale=meta.cfg.attn_scale,
                          ordering=meta.cfg.attn_ordering)
        out_kv.append(state)
        return drive

    return ssa


def _decode_ssa(meta: PlanMeta, packed: bool, kv, out_kv: list):
    """Walker attention of one decode step: the O(d^2) state update and read
    in place of the full causal SSA."""

    def ssa(q, k, v):
        step = B.ssa_decode_step_packed if packed else B.ssa_decode_step
        new_kv, drive = step(meta.backend, kv, q, k, v, scale=meta.cfg.attn_scale)
        out_kv.append(new_kv)
        return drive

    return ssa


def _chunk_ssa(meta: PlanMeta, packed: bool, kv, out_kv: list):
    """Walker attention of one resumable prefill chunk: intra-chunk causal SSA
    seeded by the layer's running state, the advanced state appended."""

    def ssa(q, k, v):
        op = B.ssa_prefill_chunk_packed if packed else B.ssa_prefill_chunk
        drive, new_kv = op(meta.backend, kv, q, k, v, scale=meta.cfg.attn_scale,
                           ordering=meta.cfg.attn_ordering)
        out_kv.append(new_kv)
        return drive

    return ssa


def _lm_prefill(meta: PlanMeta, params, tokens, *, ops: _MeshOps = _NULL_OPS):
    """tokens (B, S) -> (logits (B, S, V), DecodeState after the prompt).
    Under a head-sharded mesh the captured K^T V states are the local head
    block's (the walker's ssa runs inside ``ops.wrap_ssa``), so each layer's
    accumulator lives on its owning shard -- decode never gathers state."""
    kvs: list = []
    ssas = [_prefill_ssa(meta, meta.backend.packed, kvs) for _ in params["blocks"]]
    logits = _lm_exec(meta, params, ops.batch_rows(tokens), ssas, ops=ops)
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=meta.device)
    return logits, DecodeState(kv=tuple(kvs), pos=pos, mesh=meta.mesh)


def _lm_prefill_chunk(meta: PlanMeta, params, state: DecodeState, tokens, *,
                      ops: _MeshOps = _NULL_OPS):
    """One prefill chunk: tokens (B, C), the prompt's next C tokens ->
    (logits (B, C, V), advanced DecodeState).  Chained over a prompt split
    any way, the chunks' logits concatenate to :func:`_lm_prefill`'s and the
    final state is bit-equal."""
    _check_layers(meta, state)
    kvs: list = []
    ssas = [_chunk_ssa(meta, meta.backend.packed, kv, kvs) for kv in state.kv]
    logits = _lm_exec(meta, params, ops.batch_rows(tokens), ssas, ops=ops)
    return logits, DecodeState(kv=tuple(kvs), pos=state.pos + tokens.shape[1],
                               mesh=meta.mesh)


def _lm_decode_step(meta: PlanMeta, params, state: DecodeState, token, *,
                    ops: _MeshOps = _NULL_OPS):
    """One generated token: (B,) -> (logits (B, V), advanced state).  The
    pack epilogues attach no occupancy map (``occupancy=False``): no consumer
    of a one-token train reads it, as in the reference.  A plan with the
    train table (every sparse LM plan) fetches the token's encoding train
    from it, one gather in place of the encoding LIF."""
    _check_layers(meta, state)
    tokens = ops.batch_rows(token).reshape(-1, 1)
    x = None
    if meta.backend.packed and "train_words" in params["embed"]:
        # the encoding train is a function of the token's embedding row alone
        x = packing.PackedSpikes(params["embed"]["train_words"][:, tokens], meta.cfg.t)
    kvs: list = []
    ssas = [_decode_ssa(meta, meta.backend.packed, kv, kvs) for kv in state.kv]
    logits = _lm_exec(meta, params, tokens, ssas, lif_occupancy=False, x=x, ops=ops)
    return logits[:, 0], DecodeState(kv=tuple(kvs), pos=state.pos + 1, mesh=meta.mesh)


def make_prefill_fn(plan: DeployPlan):
    """``fn(params, tokens) -> (logits, DecodeState)`` (LM plans only);
    ``tokens``: (B, S) int64 on the plan's device.  A sharded plan takes the
    global tokens on every rank and returns the global logits and this
    rank's block of the state (batch over ``data``, heads over ``model``)."""
    meta = plan.meta
    _decode_entry(meta)
    if meta.sharding is None:
        return functools.partial(_lm_prefill, meta)
    return functools.partial(_lm_prefill, meta, ops=_mesh_ops(meta))


def make_prefill_chunk_fn(plan: DeployPlan):
    """``fn(params, state, tokens) -> (logits, state')``: the prompt's next
    chunk scored against the running state (sharded plans: global tokens and
    logits, the state resident on its shards, as for the decode step)."""
    meta = plan.meta
    _decode_entry(meta)
    if meta.sharding is None:
        return functools.partial(_lm_prefill_chunk, meta)
    return functools.partial(_lm_prefill_chunk, meta, ops=_mesh_ops(meta))


def make_decode_step_fn(plan: DeployPlan):
    """``fn(params, state, token) -> (logits, state')``: one token at a cost
    flat in context length.  A sharded plan steps with the K^T V state
    resident on its head shard (no state moves per token); the tokens and
    logits are global on every rank."""
    meta = plan.meta
    _decode_entry(meta)
    if meta.sharding is None:
        return functools.partial(_lm_decode_step, meta)
    return functools.partial(_lm_decode_step, meta, ops=_mesh_ops(meta))


def prefill(plan: DeployPlan, tokens) -> tuple[torch.Tensor, DecodeState]:
    """One-shot convenience: score a prompt (B, S) and initialise decode state."""
    with torch.inference_mode():
        return make_prefill_fn(plan)(plan.params, _tokens(plan, tokens))


def prefill_chunk(plan: DeployPlan, state: DecodeState, tokens):
    """One-shot convenience: consume the prompt's next chunk (B, C) resumably."""
    with torch.inference_mode():
        return make_prefill_chunk_fn(plan)(plan.params, state, _tokens(plan, tokens))


def decode_step(plan: DeployPlan, state: DecodeState, token):
    """One-shot convenience: advance the decode by one token (B,)."""
    with torch.inference_mode():
        return make_decode_step_fn(plan)(plan.params, state, _tokens(plan, token))
