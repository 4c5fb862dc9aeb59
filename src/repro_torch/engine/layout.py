"""The model's layer list, as data: ONE definition shared by training and
deploy.

``repro_torch.core.spikformer`` / ``repro_torch.core.tokenizer`` (eval graph,
live BatchNorm, standalone residual connective) and ``repro_torch.engine``
(deploy graph, folded weights, fused LIF+IAND dispatch) both iterate these
layouts instead of hand-inlining Linear -> BN -> LIF, so a layer added or
resized in one place exists in both worlds by construction.

This is a verbatim copy of the JAX package's ``engine/layout.py`` (pure
Python): the port keeps its own so that it imports nothing of that package.

Layouts are duck-typed over the configs (any object with the
``SpikformerConfig`` / ``TokenizerConfig`` attributes works) so this module
imports neither -- keeping ``core -> engine.layout`` dependency-cycle-free.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TokStage:
    """One Spiking-Tokenizer stage: ConvBN (+MaxPool) + LIF.

    ``encode`` marks the paper's encoding layer (stage 0): the analog frame is
    convolved ONCE and broadcast across T so the LIF dynamics produce the
    spike train (direct encoding); all later stages are tick-batched spike
    convolutions."""

    index: int
    conv: str           # param key, e.g. "conv0"
    bn: str             # param/state key, e.g. "bn0"
    c_in: int
    c_out: int
    pool: bool
    encode: bool


@dataclass(frozen=True)
class ProjUnit:
    """One Linear+BN+LIF unit of a Spike-(IAND-)Former block.

    ``fuse_residual`` marks the units whose LIF output feeds the block's
    AND-NOT residual: at deploy time the IAND executes inside the neuron's
    epilogue (one dispatch, no standalone residual pass).

    ``w_axes`` annotates the folded weight's (d_in, d_out) dims with LOGICAL
    sharding axes (``distributed.sharding`` rule names; None = replicated
    dim).  The engine resolves them through the plan's ``ShardingCfg`` rules
    into per-op ``PartitionSpec``s (``engine.backend.unit_partition_specs``).
    Only the OUTPUT dim is ever annotated: column-parallel slices keep every
    per-element contraction whole, which is what keeps the sharded plan
    bit-exact vs the single-device plan."""

    name: str           # param key within the block ("q", ..., "fc2")
    d_in: int
    d_out: int
    role: str           # "qkv" | "attn_out" | "mlp_hidden" | "mlp_out"
    fuse_residual: bool
    w_axes: tuple[str | None, str | None] = (None, None)


def tokenizer_layout(tcfg) -> tuple[TokStage, ...]:
    """Stage list for a ``TokenizerConfig``-shaped object."""
    stages = []
    c_in = tcfg.in_channels
    for i, c_out in enumerate(tcfg.stage_channels):
        stages.append(TokStage(
            index=i, conv=f"conv{i}", bn=f"bn{i}", c_in=c_in, c_out=c_out,
            pool=bool(tcfg.pool_stages[i]), encode=(i == 0)))
        c_in = c_out
    return tuple(stages)


@dataclass(frozen=True)
class SpikeEdge:
    """One inter-layer spike tensor of the deploy graph: a binary activation
    written by a LIF epilogue and read by the next consumer (the tensors the
    packed datapath compresses).  ``elems`` counts elements per image per
    time step.  ``ssa_boundary`` marks the q/k/v edges whose consumer is the
    SSA: whether they move packed or dense depends on the backend -- under
    ``Backend.closes_ssa_boundary`` the packed SSA kernel consumes the words
    directly (priced packed); otherwise they are unpacked at the attention
    op's boundary (priced dense by the conservative accounting in
    ``engine.analysis.spike_traffic``)."""

    name: str
    elems: int
    ssa_boundary: bool = False
    # logical axes of the edge tensor's (batch, position, feature) dims --
    # ``distributed.sharding`` rule names.  Under a mesh, an edge whose
    # FEATURE axis maps to a >1 mesh axis is produced feature-sharded; it
    # crosses devices (one packed-word all-gather) exactly when its consumer
    # needs the full feature row -- i.e. unless it is an ``ssa_boundary``
    # edge, whose consumer (the per-head-local SSA) reads only the local
    # head shard.  ``engine.analysis`` prices cross-device bytes from this.
    axes: tuple[str | None, ...] = ()


def tokenizer_grid(tcfg, img_size: int) -> tuple[tuple[int, int], ...]:
    """Per-stage output spatial dims: SAME 3x3 convs keep H x W, pooling
    stages halve it."""
    h = w = img_size
    dims = []
    for pool in tcfg.pool_stages:
        if pool:
            h, w = h // 2, w // 2
        dims.append((h, w))
    return tuple(dims)


def spike_edges(cfg, *, img_size: int | None = None) -> tuple[SpikeEdge, ...]:
    """Every inter-layer spike tensor of the model, in execution order.

    Drives (f32 pre-activations) and attention internals are intra-layer and
    excluded: this is the traffic the engine moves BETWEEN layer kernels,
    which the packed datapath bit-packs.
    """
    tcfg = cfg.tokenizer_config()
    img = img_size if img_size is not None else cfg.img_size
    grid = tokenizer_grid(tcfg, img)
    edges = [
        SpikeEdge(f"tok{st.index}", gh * gw * st.c_out,
                  axes=("batch", "seq", "channels"))
        for st, (gh, gw) in zip(tokenizer_layout(tcfg), grid)
    ]
    n = grid[-1][0] * grid[-1][1]     # token count
    for i in range(cfg.num_layers):
        for u in block_layout(cfg):
            if u.role == "attn_out":  # spikes of the SSA output, pre-proj
                edges.append(SpikeEdge(f"block{i}.attn", n * cfg.embed_dim,
                                       axes=("batch", "seq", "heads")))
            edges.append(SpikeEdge(
                f"block{i}.{u.name}", n * u.d_out,
                ssa_boundary=(u.role == "qkv"),
                axes=("batch", "seq", u.w_axes[1] or "embed")))
    return tuple(edges)


def block_layout(cfg) -> tuple[ProjUnit, ...]:
    """Unit list of one block for a ``SpikformerConfig``-shaped object.

    Order is execution order; the SSA sits between the ``qkv`` units and the
    ``attn_out`` unit, and the two residual joins follow ``attn_out`` and
    ``mlp_out``."""
    d = cfg.embed_dim
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    fuse = cfg.residual == "iand"
    # full column-parallel TP: q/k/v by heads, proj/fc2 back onto the
    # feature-sharded residual stream, fc1 by ffn columns -- every slice is
    # over the OUTPUT dim only, so the sharded GEMMs stay bit-exact
    return (
        ProjUnit("q", d, d, "qkv", False, w_axes=(None, "heads")),
        ProjUnit("k", d, d, "qkv", False, w_axes=(None, "heads")),
        ProjUnit("v", d, d, "qkv", False, w_axes=(None, "heads")),
        ProjUnit("proj", d, d, "attn_out", fuse, w_axes=(None, "embed")),
        ProjUnit("fc1", d, hidden, "mlp_hidden", False, w_axes=(None, "ffn")),
        ProjUnit("fc2", hidden, d, "mlp_out", fuse, w_axes=(None, "embed")),
    )


def lm_block_layout(cfg) -> tuple[ProjUnit, ...]:
    """Unit list of one spiking-LM decoder block for an ``ArchConfig``-shaped
    object (``d_model``/``d_ff`` attributes).

    Structurally the same six Linear->norm->LIF units as the vision block --
    the norm is RMSNorm instead of BatchNorm (folded by
    ``fold_linear_rmsnorm`` rather than ``fold_linear_bn``) and the SSA
    between ``qkv`` and ``attn_out`` is causal-masked.  The LM always uses
    the IAND residual (spikes stay binary), so both joins fuse.

    Every unit's ``w_axes`` stays replicated: the folded Linear+RMSNorm
    epilogue reduces over the FULL output-feature row (a data-dependent f32
    normalizer), so a column slice would split that reduction and reassociate
    it -- breaking bitwise equality with the single-device plan.  Under a
    mesh the LM's TP axis shards the SSA heads and the per-head K^T V decode
    state instead (``sharding.ENGINE_FAMILY_OVERRIDES['lm']``)."""
    d, f = cfg.d_model, cfg.d_ff
    return (
        ProjUnit("q", d, d, "qkv", False),
        ProjUnit("k", d, d, "qkv", False),
        ProjUnit("v", d, d, "qkv", False),
        ProjUnit("proj", d, d, "attn_out", True),
        ProjUnit("fc1", d, f, "mlp_hidden", False),
        ProjUnit("fc2", f, d, "mlp_out", True),
    )


def lm_spike_edges(cfg, *, seq_len: int) -> tuple[SpikeEdge, ...]:
    """Every inter-layer spike tensor of one spiking-LM forward pass at
    ``seq_len`` tokens, in execution order (the LM analogue of
    :func:`spike_edges`; elems counted per sequence per time step)."""
    d = cfg.d_model
    edges = [SpikeEdge("embed", seq_len * d, axes=("batch", "seq", "embed"))]
    feature = {"qkv": "heads", "attn_out": "embed", "mlp_hidden": "ffn",
               "mlp_out": "embed"}
    for i in range(cfg.num_layers):
        for u in lm_block_layout(cfg):
            if u.role == "attn_out":   # spikes of the causal SSA output
                edges.append(SpikeEdge(f"block{i}.attn", seq_len * d,
                                       axes=("batch", "seq", "heads")))
            edges.append(SpikeEdge(
                f"block{i}.{u.name}", seq_len * u.d_out,
                ssa_boundary=(u.role == "qkv"),
                axes=("batch", "seq", feature[u.role])))
    return tuple(edges)


def lm_decode_spike_edges(cfg) -> tuple[SpikeEdge, ...]:
    """Inter-layer spike tensors of ONE incremental decode step: the S=1
    column of :func:`lm_spike_edges`.  This is everything that moves per
    generated token in the prefill+step decode mode -- independent of the
    prefix length, which is the whole claim (the full-forward re-scoring loop
    moved ``lm_spike_edges(cfg, seq_len=S)`` per token instead).  The q/k/v
    edges feed the O(d^2) SSA state update rather than a score matrix, but
    their backend-dependent packed-vs-dense pricing is unchanged."""
    return lm_spike_edges(cfg, seq_len=1)
