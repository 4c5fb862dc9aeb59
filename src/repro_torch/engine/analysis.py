"""Measured spike sparsity of a plan's forward, the spiking LM's traffic
and serving pricers, and the graph checks (the parts of the JAX package's
``engine/analysis.py`` that the port's paths need).

:func:`sparsity_report` runs a packed plan once under
``engine.execute.capture_spikes`` and reports, per LIF tap and aggregated,
the skip rates each sparse consumer sees on those activations.

:func:`spike_traffic`, :func:`lm_spike_traffic` and :func:`lm_decode_traffic`
price the inter-layer spike edges (``engine.layout``) dense against packed,
and under ``mesh=`` the bytes each edge moves between ranks;
:func:`decode_slot_report` and :func:`prefill_chunk_report` size a continuous
service (decode-state bytes per slot, the slots a memory budget buys, the
warm-shape bill, chunked-prefill residency).  All are analytic: they count
bytes from shapes and run nothing.  :func:`collective_report` is their
measured face: every collective one real call of a sharded plan makes, with
its dtype and ring wire bytes.

The graph checks (:func:`op_histogram`, :func:`op_dims`, :func:`bn_op_count`,
:func:`rmsnorm_op_count`) verify a plan's structural promises -- no BatchNorm
in the folded vision graph, no RMSNorm layer in the LM plan, decode steps and
prefill chunks flat in the prompt length -- on the graph of one real call.
The JAX package walks the jaxpr, the trace of one call at concrete shapes;
here :class:`OpRecorder` records one call as it runs (on the CPU or on the
card): every aten op with its operand and result shapes, every
``record_function`` region entered, and every hand-kernel launch, which the
kernel wrappers report themselves (``kernels._build.report_launch``: a
ctypes launch never reaches the dispatcher), and every collective, which the
mesh axes report (``launch.mesh.MeshAxis``).
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import packing

_GRANULE = 8    # token rows per skip granule of the plain sparse route


def sparsity_report(plan, batch) -> dict:
    """MEASURED occupancy of every packed spike train a plan's forward moves
    on ``batch``:

    * ``word_zero_rate`` -- fraction of 32-bit words that are all-zero (the
      finest exact-skip granule);
    * ``occ_tile_zero_rate`` -- fraction of ``packing.OCC_TILE``-element
      occupancy tiles that are all-zero;
    * ``token_granule_zero_rate`` -- fraction of 8-token granules with no
      spike at any feature or time step (what the plain sparse GEMM skips);
    * ``spike_rate`` -- plain spike density over (T, elements).
    """
    from repro_torch.engine import execute

    with execute.capture_spikes() as taps:
        execute.apply(plan, batch)
    if not taps:
        raise ValueError(
            "plan produced no packed spike trains -- sparsity_report needs a "
            "packed backend (Backend.packed=True)")
    per_tap = []
    tot = dict.fromkeys(("words", "zero_words", "tiles", "zero_tiles", "granules",
                         "zero_granules", "spikes", "slots"), 0)
    for ps in taps:
        words = ps.words
        occ = ps.occ if ps.occ is not None else packing.occupancy_map(words)
        # token granules: rows of the (tokens, features) view, all word planes
        flat = words.reshape(words.shape[0], -1, words.shape[-1])
        row_alive = (flat != 0).any(dim=2).any(dim=0)
        row_alive = F.pad(row_alive, (0, (-row_alive.shape[0]) % _GRANULE))
        gran_alive = row_alive.reshape(-1, _GRANULE).any(dim=1)
        n = {"words": words.numel(), "zero_words": int((words == 0).sum()),
             "tiles": occ.numel(), "zero_tiles": int((occ == 0).sum()),
             "granules": gran_alive.numel(), "zero_granules": int((~gran_alive).sum()),
             "spikes": int(packing.spike_counts(ps).sum(dtype=torch.int64)),
             "slots": ps.t * math.prod(ps.elem_shape)}
        per_tap.append({
            "shape": tuple(int(s) for s in ps.dense_shape),
            "word_zero_rate": n["zero_words"] / n["words"],
            "occ_tile_zero_rate": n["zero_tiles"] / n["tiles"],
            "token_granule_zero_rate": n["zero_granules"] / n["granules"],
            "spike_rate": n["spikes"] / n["slots"],
        })
        for key in tot:
            tot[key] += n[key]
    return {
        "num_taps": len(per_tap),
        "taps": per_tap,
        "word_zero_rate": tot["zero_words"] / tot["words"],
        "occ_tile_zero_rate": tot["zero_tiles"] / tot["tiles"],
        "token_granule_zero_rate": tot["zero_granules"] / tot["granules"],
        "spike_rate": tot["spikes"] / tot["slots"],
    }


# -- LM traffic and serving pricers ------------------------------------------------


def _traffic_sharding(mesh, family: str):
    """Coerce a pricer's ``mesh=`` argument into the family's resolved
    ``ShardingCfg`` (None passes through)."""
    if mesh is None:
        return None
    from repro_torch.engine.plan import _resolve_sharding

    return _resolve_sharding(mesh, family)


def _edge_mesh_degree(edge, rules: dict, sizes: dict) -> int:
    """Tensor-parallel degree of one spike edge: the product of mesh-axis
    sizes its feature (last) logical axis maps to under the plan's rules (1 =
    the edge is replicated or shard-local)."""
    if not edge.axes:
        return 1
    mapped = rules.get(edge.axes[-1])
    if mapped is None:
        return 1
    names = mapped if isinstance(mapped, tuple) else (mapped,)
    return math.prod(sizes.get(n, 1) for n in names)


def _is_sparse(backend) -> bool:
    from repro_torch.engine.backend import resolve

    return backend is not None and resolve(backend).sparse


def _boundary_closed(backend, ordering: str) -> bool:
    """Do the q/k/v edges move packed words into the SSA?  Under a backend
    whose packed SSA consumes words directly, on either ordering."""
    from repro_torch.engine.backend import resolve

    if backend is None:
        return False
    return resolve(backend).closes_ssa_boundary and ordering in ("quadratic", "linear")


def _price_edges(edges, t: int, *, batch: int, boundary_closed: bool,
                 sparse: bool = False, scfg=None) -> dict:
    """Each spike edge priced dense (f32 over T) and packed (32-bit words),
    with the q/k/v edges priced dense unless the SSA boundary is closed, the
    occupancy maps' bytes under ``sparse``, and under a sharding ``scfg``
    each edge's cross-rank bytes."""
    per_edge = [{
        "name": e.name,
        "elems": e.elems * batch,
        "ssa_boundary": e.ssa_boundary,
        "dense_bytes": packing.dense_nbytes(t, e.elems * batch),
        "packed_bytes": packing.packed_nbytes(t, e.elems * batch),
        "occupancy_bytes": packing.occupancy_nbytes(t, e.elems * batch),
    } for e in edges]
    if scfg is not None:
        sizes = dict(zip(scfg.mesh_axes, scfg.mesh_shape))
        rules = scfg.rules_dict
        for e, pe in zip(edges, per_edge):
            m = _edge_mesh_degree(e, rules, sizes)
            # an ssa_boundary edge's consumer (the per-head-local SSA) reads
            # only the local head shard: sharded, but never on the wire
            crosses = m > 1 and not e.ssa_boundary
            pe["tp_degree"] = m
            pe["crosses_devices"] = crosses
            # fleet-total ring all-gather bytes over the whole (global) batch:
            # every shard's block travels to the m-1 other shards
            pe["cross_device_dense_bytes"] = (m - 1) * pe["dense_bytes"] if crosses else 0
            pe["cross_device_packed_bytes"] = (m - 1) * pe["packed_bytes"] if crosses else 0
    dense = sum(e["dense_bytes"] for e in per_edge)
    packed = sum(e["packed_bytes"] for e in per_edge)
    occupancy = sum(e["occupancy_bytes"] for e in per_edge)
    packed_ssa_dense = sum(
        e["dense_bytes"] if e["ssa_boundary"] and not boundary_closed else e["packed_bytes"]
        for e in per_edge)
    out = {
        "t": t,
        "batch": batch,
        "ssa_boundary_closed": boundary_closed,
        "edges": per_edge,
        "dense_bytes": dense,
        "packed_bytes": packed,
        "reduction": dense / packed,
        "packed_bytes_ssa_dense": packed_ssa_dense,
        "reduction_ssa_dense": dense / packed_ssa_dense,
    }
    if sparse:
        # the sparse datapath moves the same packed words plus the occupancy
        # maps (1/128 of the words); its gain is skipped compute, measured by
        # sparsity_report, not priced here
        out["occupancy_bytes"] = occupancy
        out["packed_sparse_bytes"] = packed + occupancy
        out["reduction_sparse"] = dense / (packed + occupancy)
    if scfg is not None:
        xd = sum(e["cross_device_dense_bytes"] for e in per_edge)
        xp = sum(e["cross_device_packed_bytes"] for e in per_edge)
        out["mesh"] = {"shape": tuple(scfg.mesh_shape), "axes": tuple(scfg.mesh_axes)}
        out["cross_device_dense_bytes"] = xd
        out["cross_device_packed_bytes"] = xp
        # exactly t / ceil(t/32): every crossing edge moves words
        out["cross_device_reduction"] = (xd / xp) if xp else None
    return out


def spike_traffic(cfg, *, batch: int = 1, img_size: int | None = None, backend=None,
                  mesh=None) -> dict:
    """Inter-layer spike bytes of one vision forward pass (``cfg`` a
    ``SpikformerConfig``), dense against packed, over
    ``layout.spike_edges``; the q/k/v edges count packed only where the
    backend's packed SSA consumes the words.  ``mesh`` (ShardingCfg | "dxm"
    | (data, model)) also prices each edge's cross-rank bytes under the
    column-parallel vision plan: an edge whose feature axis maps to a model
    axis of size m > 1 is produced feature-sharded and all-gathered by its
    consumer (fleet-total wire bytes = edge bytes x (m - 1)), except the
    q/k/v edges, whose consumer is the head-local SSA.  Data shards move no
    activations between them."""
    from repro_torch.engine.layout import spike_edges

    return _price_edges(spike_edges(cfg, img_size=img_size), cfg.t, batch=batch,
                        boundary_closed=_boundary_closed(backend, cfg.attn_ordering),
                        sparse=_is_sparse(backend), scfg=_traffic_sharding(mesh, "vision"))


def lm_spike_traffic(cfg, *, seq_len: int, batch: int = 1, backend=None,
                     ordering: str = "quadratic", mesh=None) -> dict:
    """Inter-layer spike bytes of one spiking-LM forward pass at ``seq_len``
    tokens (``cfg`` an ``ArchConfig``), dense against packed; the q/k/v edges
    count packed only where the backend's packed SSA consumes the words.
    ``mesh`` prices cross-rank bytes under the head-sharded LM schedule: the
    attention LIF output is the one crossing edge per block (the embed and
    ffn edges feed model-replicated units, q/k/v the head-local SSA)."""
    from repro_torch.engine.layout import lm_spike_edges

    return _price_edges(lm_spike_edges(cfg, seq_len=seq_len), cfg.spike_t, batch=batch,
                        boundary_closed=_boundary_closed(backend, ordering),
                        sparse=_is_sparse(backend), scfg=_traffic_sharding(mesh, "lm"))


def lm_decode_traffic(cfg, *, batch: int = 1, backend=None, mesh=None) -> dict:
    """Per-generated-token traffic of incremental decode: the S=1 spike edges
    (``layout.lm_decode_spike_edges``) plus the O(d^2) SSA state each step
    reads and writes back -- all flat in the prefix length.  The decode step
    consumes q/k/v words directly under ``Backend.closes_ssa_boundary``.
    ``mesh`` prices cross-rank bytes per step (the attention edge crosses);
    the K^T V state stays on its head shard, so state bytes never cross."""
    from repro_torch.engine.backend import resolve
    from repro_torch.engine.layout import lm_decode_spike_edges

    closed = backend is not None and resolve(backend).closes_ssa_boundary
    priced = _price_edges(lm_decode_spike_edges(cfg), cfg.spike_t, batch=batch,
                          boundary_closed=closed, sparse=_is_sparse(backend),
                          scfg=_traffic_sharding(mesh, "lm"))
    dh = cfg.d_model // cfg.num_heads
    state_bytes = 4 * cfg.num_layers * cfg.spike_t * batch * cfg.num_heads * dh * dh
    priced["decode_state_bytes"] = state_bytes
    # each step reads the state and writes the updated one back
    priced["state_bytes_per_step"] = 2 * state_bytes
    priced["dense_bytes_per_step"] = priced["dense_bytes"] + 2 * state_bytes
    priced["packed_bytes_per_step"] = priced["packed_bytes_ssa_dense"] + 2 * state_bytes
    if mesh is not None:
        priced["cross_device_state_bytes"] = 0   # the state is pinned to its shard
    return priced


def _lm_entry(plan, what: str):
    entry = plan.meta.decode
    if entry is None:
        raise ValueError(f"{what} stats are an LM-plan mode (family={plan.meta.family!r})")
    return entry


def decode_slot_report(plan, *, slots: int, budget_bytes: int | None = None,
                       prompt_lens=()) -> dict:
    """Decode-slot accounting of a continuous service on ``plan``: per-slot and
    whole-batch ``DecodeState`` bytes, per-step bytes at the slot count (state
    read and write plus the S=1 spike edges), the slot capacity a memory
    budget buys (``max_slots``, exact: the state has no context-length term),
    and the warm-shape bill: one step shape for the slot batch plus one
    prefill shape per distinct prompt length."""
    entry = _lm_entry(plan, "decode-slot")
    traffic = lm_decode_traffic(plan.meta.cfg.arch, batch=slots, backend=plan.meta.backend,
                                mesh=getattr(plan.meta, "sharding", None))
    report = {
        "slots": slots,
        "state_bytes_per_slot": entry.state_bytes(1),
        "state_bytes_batch": entry.state_bytes(slots),
        "bytes_per_step_dense": traffic["dense_bytes_per_step"],
        "bytes_per_step_packed": traffic["packed_bytes_per_step"],
        "warm_step_shapes": 1,
        "warm_prefill_shapes": len(set(prompt_lens)),
        "prompt_len_buckets": tuple(sorted(set(prompt_lens))),
    }
    if budget_bytes is not None:
        report["budget_bytes"] = budget_bytes
        report["max_slots"] = entry.max_slots(budget_bytes)
    return report


def prefill_chunk_report(plan, *, seq_len: int, chunk: int, batch: int = 1) -> dict:
    """Resident-memory accounting of chunked against one-shot prefill at prompt
    length ``seq_len``: the dominant activation plane of a prefill is a
    (T, B, S, d_model) f32 tensor per block edge, so one-shot residency grows
    with S while the chunked path holds a C-token plane plus the O(d^2)
    ``DecodeState``, flat in S.  ``chunk_buckets`` is the warm-shape bill (the
    chunk size and the ragged tail, if any)."""
    entry = _lm_entry(plan, "prefill-chunk")
    cfg = plan.meta.cfg.arch
    plane = 4 * cfg.spike_t * batch * cfg.d_model      # bytes per token column
    full, ragged = divmod(seq_len, chunk)
    buckets = ([chunk] if full else []) + ([ragged] if ragged else [])
    return {
        "seq_len": seq_len,
        "chunk": chunk,
        "num_chunks": full + (1 if ragged else 0),
        "chunk_buckets": buckets,
        "state_bytes": entry.state_bytes(batch),
        "oneshot_plane_bytes": plane * seq_len,
        "chunked_plane_bytes": plane * chunk + entry.state_bytes(batch),
        "plane_reduction": plane * seq_len / (plane * chunk + entry.state_bytes(batch)),
    }


# -- graph checks on a recorded call ---------------------------------------------

# BatchNorm's signature in the vision graph: core/nn.py::bn_apply normalises
# by torch.rsqrt in both modes, as the JAX package's _BN_PRIMS reads it.
# VISION ONLY: LM graphs use rsqrt legitimately (the folded units' normaliser
# and the head), so they are checked with rmsnorm_op_count.
_BN_OPS = ("aten.rsqrt.",)
_BN_NAMES = ("batch_norm",)
# models/layers.py::rmsnorm_apply runs inside a record_function region of
# this name: an RMSNorm LAYER is counted by name, as the JAX package counts
# its named pjit (the folded units' rsqrt epilogue is not such a layer).
RMSNORM_REGION = "rmsnorm_apply"
_REGION_OP = "profiler._record_function_enter_new"


def _tensors(tree):
    """The tensors of nested dicts, tuples, lists and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


class OpRecorder(TorchDispatchMode):
    """Records one call as it runs: ``ops`` lists ``(name, shapes)`` per
    operation in order -- ``aten.<op>.<overload>`` with the shapes of its
    tensor operands and results, ``region.<name>`` for a ``record_function``
    region entered, ``kernel.<entry point>`` with its operands' shapes for
    each hand-kernel launch (:meth:`record_launch`, called by the kernel
    wrappers), and ``collective.<primitive>`` for each collective of a mesh
    axis, whose details ``collectives`` keeps (:meth:`record_collective`)."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, tuple]] = []
        self.collectives: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if name.startswith(_REGION_OP):
            self.ops.append((f"region.{args[0]}", ()))
        else:
            shapes = tuple(tuple(x.shape) for x in _tensors((args, kwargs or {}, out)))
            self.ops.append((name, shapes))
        return out

    def record_launch(self, name: str, operands) -> None:
        self.ops.append((f"kernel.{name}", tuple(tuple(x.shape) for x in operands)))

    def record_collective(self, entry: dict) -> None:
        """One collective of a mesh axis (``launch.mesh.MeshAxis``): its
        primitive, axis, kind, dtype, output shape, group size and wire
        bytes."""
        self.collectives.append(entry)
        self.ops.append((f"collective.{entry['primitive']}", (entry["shape"],)))


def record(fn, *args, **kwargs) -> OpRecorder:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpRecorder` (no
    autograd graph is built) and return the recorder."""
    with torch.no_grad(), OpRecorder() as rec:
        fn(*args, **kwargs)
    return rec


def op_histogram(fn, *args, **kwargs) -> Counter:
    """Operation name -> count over one recorded call of ``fn`` (aten
    overloads, regions, hand-kernel entry points; see :class:`OpRecorder`)."""
    return Counter(name for name, _ in record(fn, *args, **kwargs).ops)


def op_dims(fn, *args, **kwargs) -> set:
    """Every axis length of every tensor in one recorded call of ``fn``:
    its arguments, and every operation's operands and results, hand-kernel
    launches included (the counterpart of the JAX package's ``jaxpr_dims``).

    The falsifiable form of a "cost is flat in S" claim: record the call and
    assert the sequence length S is NOT in this set -- a step that re-scored
    an S-token prefix, or carried the prompt in its state, would hold an
    S-sized axis somewhere."""
    dims = {d for x in _tensors((args, kwargs)) for d in x.shape}
    for _, shapes in record(fn, *args, **kwargs).ops:
        for shape in shapes:
            dims.update(shape)
    return dims


def bn_op_count(fn, *args, **kwargs) -> int:
    """Number of BatchNorm-signature operations (``aten.rsqrt``, any
    ``batch_norm`` op) in one recorded call of ``fn``: 0 for a folded vision
    plan.  Vision graphs only -- LM graphs use rsqrt in their normalisers;
    count those with :func:`rmsnorm_op_count`."""
    hist = op_histogram(fn, *args, **kwargs)
    return sum(n for name, n in hist.items()
               if name.startswith(_BN_OPS) or any(b in name for b in _BN_NAMES))


def rmsnorm_op_count(fn, *args, **kwargs) -> int:
    """Number of RMSNorm layer applications (``models.layers.rmsnorm_apply``,
    counted by its named region) in one recorded call of ``fn``: 0 for a
    folded LM plan, whose gains live in the GEMM weights and whose head
    normalises inline (``rmsnorm_raw``)."""
    return op_histogram(fn, *args, **kwargs)[f"region.{RMSNORM_REGION}"]


def collective_report(fn, *args, **kwargs) -> dict:
    """Every collective of one recorded call of ``fn`` on this rank (a
    sharded plan's executor: every rank of the world runs it alike), with
    operand dtype and ring wire bytes -- the measured face of the sharded
    traffic pricing, and the falsifiable form of the packed-boundary
    contract: under a packed backend every spike edge that crosses ranks
    moves int32 words (the uint32 bit pattern; no ``packing.unpack`` output
    ever crosses).

    ``collectives`` holds the walkers' spike edges (the collectives inside
    the JAX package's ``shard_map`` body, each with ``primitive``, ``axis``,
    ``dtype``, ``shape``, ``axis_size`` and ``wire_bytes``); ``outputs``
    the data shards' head inputs assembled over ``data`` (what the JAX
    package's ``out_specs`` assemble), apart.  Wire bytes are ring totals
    per group, as the JAX package counts them: all_gather moves (size-1) x
    out_bytes, reduce_scatter (size-1) x in_bytes, psum 2 (size-1) x
    in_bytes.  Summed over the d data shards of a (d, m) mesh, the spike
    edges' bytes are the pricers' ``cross_device_*_bytes``."""
    rec = record(fn, *args, **kwargs)
    edges = [c for c in rec.collectives if c["kind"] == "edge"]
    return {
        "num_collectives": len(edges),
        "collectives": edges,
        "wire_bytes": sum(c["wire_bytes"] for c in edges),
        "dtypes": sorted({c["dtype"] for c in edges}),
        "outputs": [c for c in rec.collectives if c["kind"] != "edge"],
    }
