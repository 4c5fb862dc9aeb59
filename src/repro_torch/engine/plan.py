"""Deploy-plan compiler: (params, state, cfg) -> the accelerator's view.

``compile_plan`` performs the paper's deploy-time transformations once, ahead
of serving.  It covers two config families:

* vision (anything with ``tokenizer_config``): every Conv+BN pair of the
  tokenizer is folded into a single (w, b) via ``fold_conv_bn``, every
  Linear+BN pair of every block via ``fold_linear_bn`` -- the BN disappears
  from the graph entirely;
* spiking LM (``ArchConfig`` with ``spiking=True``): every Linear+RMSNorm unit
  is folded via ``fold_linear_rmsnorm`` (gain into the GEMM weights, the
  gain-free normalizer left as the unit's epilogue), the embedding norm is
  folded into the embedding table (rows are normalized independently), and
  the plan-level ``ordering`` picks the causal SSA's quadratic (QK^T)V or
  chunked-linear Q(K^T V) dataflow.

The block layout records which LIFs fuse the AND-NOT residual into their
epilogue, and the backend (plain PyTorch vs the CUDA kernels) is a plan
property.  A plan lives on one device, the card unless the caller asks for
the CPU.

``compile_plan(mesh=)`` makes the plan mesh-aware (:class:`ShardingCfg`): run
SPMD on every rank of a ``torch.distributed`` world, batch data-parallel over
``data`` and the family's tensor-parallel schedule over ``model``, each rank
keeping only its parameter slices (vision: block units cut by output column;
LM: units replicated, the SSA heads sharded at run time).  Bit-exact against
the ``mesh=None`` plan by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch import bridge
from repro_torch.bridge import resolve_device  # noqa: F401  (re-exported)
from repro_torch.core import nn as cnn
from repro_torch.core.lif import LAM_DEFAULT, THETA_DEFAULT
from repro_torch.engine.backend import Backend, resolve
from repro_torch.engine.layout import (
    ProjUnit, TokStage, block_layout, lm_block_layout, tokenizer_layout,
)


@dataclass(frozen=True)
class ShardingCfg:
    """Mesh-awareness of a deploy plan: the requested mesh shape and axes,
    plus the logical-axis rules that resolve the layout annotations
    (``ProjUnit.w_axes``, ``SpikeEdge.axes``) into specs.

    Hashable (rules stored as a sorted item tuple).  The rules come from
    ``distributed.sharding.engine_rules(family, preset=...)``.  The host mesh
    itself is process state and is not stored here: :meth:`build_mesh` lays
    it over the world (the largest feasible shape, with a warning, on a
    world smaller than ``mesh_shape``), and the plan keeps it beside its
    parameter slices (``PlanMeta.mesh``)."""

    mesh_shape: tuple[int, int] = (1, 1)
    mesh_axes: tuple[str, str] = ("data", "model")
    preset: str = "base"
    rules: tuple[tuple[str, Any], ...] = field(default=(), repr=False)

    @property
    def data_axis(self) -> str:
        return self.mesh_axes[0]

    @property
    def model_axis(self) -> str:
        return self.mesh_axes[1]

    @property
    def data(self) -> int:
        return self.mesh_shape[0]

    @property
    def model(self) -> int:
        return self.mesh_shape[1]

    @property
    def rules_dict(self) -> dict[str, Any]:
        return dict(self.rules)

    def build_mesh(self):
        """The host mesh of this cfg over the world (``launch.mesh``)."""
        from repro_torch.launch.mesh import make_host_mesh

        return make_host_mesh(self.mesh_shape, self.mesh_axes)


def _resolve_sharding(mesh, family: str) -> ShardingCfg | None:
    """Coerce a user-facing mesh spec -- ShardingCfg | "dxm" | (d, m) | None
    -- into a ShardingCfg with the family's engine rules resolved."""
    from repro_torch.distributed import sharding as shd

    if mesh is None:
        return None
    if isinstance(mesh, ShardingCfg):
        cfg = mesh
    else:
        if isinstance(mesh, str):
            try:
                d, m = (int(p) for p in mesh.lower().split("x"))
            except ValueError:
                raise ValueError(f"mesh spec must be 'dxm' (e.g. '2x1'), got {mesh!r}")
            shape = (d, m)
        else:
            shape = tuple(int(s) for s in mesh)
            if len(shape) != 2:
                raise ValueError(f"mesh shape must be (data, model), got {shape}")
        cfg = ShardingCfg(mesh_shape=shape)
    if min(cfg.mesh_shape) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {cfg.mesh_shape}")
    if not cfg.rules:
        rules = shd.engine_rules(family, preset=cfg.preset)
        cfg = ShardingCfg(mesh_shape=cfg.mesh_shape, mesh_axes=cfg.mesh_axes,
                          preset=cfg.preset, rules=tuple(sorted(rules.items())))
    return cfg


def _validate_sharding(scfg: ShardingCfg, cfg, family: str) -> None:
    """Divisibility the exact sharded schedules require.  Batch divisibility
    by the data axis is checked at call time (the batch size is not a plan
    property)."""
    m = scfg.model
    if m == 1:
        return
    heads = cfg.num_heads
    if heads % m:
        raise ValueError(f"model axis {m} must divide num_heads={heads} (the SSA runs "
                         "per-head-local on its shard)")
    if family == "vision":
        d = cfg.embed_dim
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        if d % m or hidden % m:
            raise ValueError(f"model axis {m} must divide embed_dim={d} and the MLP hidden "
                             f"dim {hidden} (column-parallel unit shards)")


def _shard_blocks(blocks, units, scfg: ShardingCfg, mesh):
    """Each block unit's parameters cut to this rank's slices by its specs
    (``backend.unit_partition_specs``), made contiguous (the kernels take a
    dense layout) and copied, so the full tensors can be freed."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.engine.backend import unit_partition_specs

    rules = scfg.rules_dict

    def cut(x, sp):
        return x[NamedSharding(mesh, sp).local_slices(x.shape)].contiguous().clone()

    return tuple(
        {u.name: {k: cut(v, unit_partition_specs(u, bp[u.name], rules)[k])
                  for k, v in bp[u.name].items()}
         for u in units}
        for bp in blocks)


@dataclass(frozen=True)
class LMDeployCfg:
    """Deploy view of a spiking-LM ``ArchConfig``: the attribute names the
    executor shares with ``SpikformerConfig`` (``t``, ``chain_len``,
    ``theta``, ...), plus the plan-level attention ordering.  The wrapped
    ``ArchConfig`` stays reachable as ``arch``."""

    arch: Any                          # ArchConfig (frozen dataclass)
    attn_ordering: str = "quadratic"   # "quadratic" | "linear" (chunked scan)

    @property
    def t(self) -> int:
        return self.arch.spike_t

    @property
    def chain_len(self):
        return self.arch.spike_chain_len

    @property
    def theta(self) -> float:
        return THETA_DEFAULT

    @property
    def lam(self) -> float:
        return LAM_DEFAULT

    @property
    def lif_schedule(self) -> str:
        return "parallel"

    @property
    def attn_scale(self) -> float:
        from repro_torch.models.spiking_lm import ATTN_SCALE

        return ATTN_SCALE

    @property
    def norm_eps(self) -> float:
        return self.arch.norm_eps

    @property
    def num_heads(self) -> int:
        return self.arch.num_heads

    @property
    def d_model(self) -> int:
        return self.arch.d_model


@dataclass(frozen=True)
class DecodeEntry:
    """Geometry of an LM plan's incremental decode: one (T, B, H, Dh, Dh)
    K^T V accumulator per layer, whatever the context length (the spiking
    attention has no softmax, so the linear ordering's running state is all
    a decode carries)."""

    num_layers: int
    t: int                             # time steps (the bitplane axis)
    num_heads: int
    head_dim: int

    def state_shapes(self, batch: int) -> tuple[tuple[int, ...], ...]:
        """Per-layer SSA-state shapes of a ``DecodeState`` at this batch."""
        shp = (self.t, batch, self.num_heads, self.head_dim, self.head_dim)
        return tuple(shp for _ in range(self.num_layers))

    def state_bytes(self, batch: int, itemsize: int = 4) -> int:
        """Decode-state footprint, constant in context length."""
        return sum(itemsize * s[0] * s[1] * s[2] * s[3] * s[4]
                   for s in self.state_shapes(batch))

    def max_slots(self, budget_bytes: int, itemsize: int = 4) -> int:
        """Largest slot count whose batched ``DecodeState`` fits in
        ``budget_bytes`` (the state is linear in slots and has no
        context-length term, so this is exact)."""
        per_slot = self.state_bytes(1, itemsize)
        return budget_bytes // per_slot if per_slot else 0


@dataclass(frozen=True)
class PlanMeta:
    """Static half of a deploy plan."""

    cfg: Any                          # SpikformerConfig | LMDeployCfg (frozen)
    backend: Backend
    tok_stages: tuple[TokStage, ...]
    block_units: tuple[ProjUnit, ...]
    num_layers: int
    device: torch.device
    family: str = "vision"            # "vision" | "lm"
    bundle: Any = None                # core.bundling.BundleInfo of an applied row bundling
    sharding: ShardingCfg | None = None   # None = single-device plan
    mesh: Any = None                  # launch.mesh.HostMesh the parameter slices belong to

    @property
    def decode(self) -> DecodeEntry | None:
        """Incremental-decode entry point: on every LM plan (stepping the
        causal SSA's linear-ordering state is exact in either plan
        ordering), none on vision plans (non-causal attention has no running
        state)."""
        if self.family != "lm":
            return None
        cfg = self.cfg
        return DecodeEntry(num_layers=self.num_layers, t=cfg.t, num_heads=cfg.num_heads,
                           head_dim=cfg.d_model // cfg.num_heads)


@dataclass(frozen=True)
class DeployPlan:
    meta: PlanMeta
    params: dict                      # folded-weight tree of tensors on meta.device

    @property
    def cfg(self):
        return self.meta.cfg

    @property
    def backend(self) -> Backend:
        return self.meta.backend


def compile_plan(params, state, cfg, *, backend="cuda", ordering: str | None = None,
                 device=None, checkpoint=None, bundle: float | None = None,
                 mesh=None) -> DeployPlan:
    """Fold a trained (params, state, cfg) into a deploy plan on ``device``.

    ``params``/``state``: nested dicts of tensors or numpy arrays with the
    JAX package's structure (see :mod:`repro_torch.bridge`); ``state`` is
    None for the spiking LM, which has no BN.
    ``backend``: Backend | "torch" | "cuda" | "torch+packed" | "cuda+packed" |
    "torch+packed+sparse" | "cuda+packed+sparse" (see ``engine.backend.resolve``).
    ``ordering`` selects the LM plan's causal-SSA dataflow ("quadratic", the
    default, | "linear"); vision plans take it from ``cfg.attn_ordering``.
    ``checkpoint``: optional checkpoint directory (either package's layout,
    :mod:`repro_torch.checkpoint.checkpoint`) holding ``{"params", "state"}``
    (``params`` alone where ``state`` is None); its arrays are restored into
    the skeleton before folding, as the JAX package's
    ``compile_plan(checkpoint=)`` does.
    ``bundle``: optional max-abs logit-error budget for the embedding
    row-bundling transform (:mod:`repro_torch.core.bundling`; LM plans only;
    ``0.0`` = exact duplicate-train dedup).  Every sparse LM plan carries the
    per-row packed train table (``bundling.attach_train_table``), which its
    decode step reads in place of the encoding LIF.
    ``mesh``: optional :class:`ShardingCfg` | ``"dxm"`` | ``(data, model)``
    -- makes the plan mesh-aware: every rank of the ``torch.distributed``
    world calls ``compile_plan`` with the same arguments and keeps its own
    parameter slices; the executors then take the global batch on every
    rank, run the batch data-parallel over ``data`` and the family's
    tensor-parallel schedule over ``model`` (vision: column-parallel units
    and a feature-sharded residual stream; LM: head-sharded SSA and decode
    state), move every cross-rank spike edge as packed words under packed
    backends, and return the global result on every rank.  Bit-exact
    against the ``mesh=None`` plan.
    """
    dev = resolve_device(device)
    params = bridge.to_torch(params, dev)
    state = None if state is None else bridge.to_torch(state, dev)
    if checkpoint is not None:
        from repro_torch.checkpoint import checkpoint as ckpt

        if state is None:
            params, _ = ckpt.restore(checkpoint, params)
        else:
            restored, _ = ckpt.restore(checkpoint, {"params": params, "state": state})
            params, state = restored["params"], restored["state"]
    if not hasattr(cfg, "tokenizer_config"):
        from repro_torch.core import bundling

        plan = _compile_lm_plan(params, state, cfg, backend=backend,
                                ordering=ordering or "quadratic", device=dev, mesh=mesh)
        if bundle is not None:
            plan = bundling.bundle(plan, budget=bundle)
        if plan.meta.backend.sparse:
            plan = bundling.attach_train_table(plan)
        return plan
    if bundle is not None:
        raise ValueError(
            "row bundling applies to LM embedding tables only; vision plans "
            "have no token-row/spike-train factorisation to bundle")
    if ordering is not None:
        raise ValueError("ordering is a plan-compile choice only for LM configs; "
                         "vision plans read cfg.attn_ordering")
    be = resolve(backend)
    if be.packed and cfg.residual != "iand":
        raise ValueError(
            "packed backends require residual='iand': the ADD residual sums "
            "spike trains into non-binary tensors, which cannot be bit-packed")
    scfg = _resolve_sharding(mesh, "vision")
    host_mesh = None
    if scfg is not None:
        _validate_sharding(scfg, cfg, "vision")
        host_mesh = scfg.build_mesh()
    tok_stages = tokenizer_layout(cfg.tokenizer_config())
    units = block_layout(cfg)

    tp, ts = params["tokenizer"], state["tokenizer"]
    folded_tok = tuple(cnn.fold_conv_bn(tp[st.conv], tp[st.bn], ts[st.bn])
                       for st in tok_stages)
    folded_blocks = tuple(
        {u.name: cnn.fold_linear_bn(params[f"block{i}"][u.name]["lin"],
                                    params[f"block{i}"][u.name]["bn"],
                                    state[f"block{i}"][u.name]["bn"])
         for u in units}
        for i in range(cfg.num_layers))
    if scfg is not None:
        folded_blocks = _shard_blocks(folded_blocks, units, scfg, host_mesh)

    meta = PlanMeta(cfg=cfg, backend=be, tok_stages=tok_stages, block_units=units,
                    num_layers=cfg.num_layers, device=dev, sharding=scfg, mesh=host_mesh)
    return DeployPlan(meta=meta, params={"tokenizer": folded_tok,
                                         "blocks": folded_blocks,
                                         "head": params["head"]})


def _compile_lm_plan(params, state, cfg, *, backend, ordering, device, mesh=None) -> DeployPlan:
    """Fold a spiking-LM model (``models.spiking_lm`` parameters, on
    ``device``) into a deploy plan: RMSNorm gains into the GEMM weights
    (``fold_linear_rmsnorm``), the embedding norm into the embedding table,
    the per-layer parameters unstacked from the stacked ``layers`` tree.
    The head's weights and the final norm are the parameters' own tensors,
    not copies."""
    from repro_torch.models.layers import rmsnorm_apply
    from repro_torch.bridge import layer_params

    if not getattr(cfg, "spiking", False):
        raise ValueError(
            f"LM deploy plans cover the spiking LM family only; config "
            f"'{getattr(cfg, 'name', cfg)}' has spiking=False")
    if state is not None:
        raise ValueError("the spiking LM carries no BN state; pass state=None")
    if ordering not in ("quadratic", "linear"):
        raise ValueError(f"unknown attention ordering: {ordering!r}")
    be = resolve(backend)
    scfg = _resolve_sharding(mesh, "lm")
    host_mesh = None
    if scfg is not None:
        _validate_sharding(scfg, cfg, "lm")
        host_mesh = scfg.build_mesh()      # units stay replicated: nothing to cut
    units = lm_block_layout(cfg)
    # token rows are normalized independently, so the fold is the full
    # RMSNorm precomputed over the table
    embed = {"table": rmsnorm_apply(params["embed"]["norm"], params["embed"]["table"],
                                    eps=cfg.norm_eps)}
    folded_blocks = []
    for i in range(cfg.num_layers):
        bp = layer_params(params["layers"], i)
        folded_blocks.append({u.name: cnn.fold_linear_rmsnorm({"w": bp[u.name]["w"]},
                                                              bp[u.name]["norm"])
                              for u in units})
    meta = PlanMeta(cfg=LMDeployCfg(arch=cfg, attn_ordering=ordering), backend=be,
                    tok_stages=(), block_units=units, num_layers=cfg.num_layers,
                    device=device, family="lm", sharding=scfg, mesh=host_mesh)
    return DeployPlan(meta=meta, params={"embed": embed, "blocks": tuple(folded_blocks),
                                         "final_norm": params["final_norm"],
                                         "head": {"w": params["lm_head"]["w"]}})


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def plan_stats(plan: DeployPlan) -> dict:
    """Structural op accounting of the deploy plan (what the paper's Table II
    argues about): every BN (LM: every RMSNorm but the head's) is folded
    away, every IAND rides a LIF epilogue."""
    meta = plan.meta
    if meta.family == "lm":
        return _lm_plan_stats(plan)
    n_tok = len(meta.tok_stages)
    n_units = len(meta.block_units)
    fused = sum(u.fuse_residual for u in meta.block_units) * meta.num_layers
    return {
        "decode_entry": False,        # vision: non-causal SSA, no step mode
        "folded_conv_bn": n_tok,
        "folded_linear_bn": n_units * meta.num_layers,
        "bn_ops": 0,                  # folded at plan-compile time
        "fused_lif_iand_dispatches": fused,
        "standalone_iand_ops": 0,     # IAND only ever executes in the fused epilogue
        "standalone_add_ops": 0 if meta.cfg.residual == "iand" else 2 * meta.num_layers,
        # one LIF dispatch per tokenizer stage; per block: q,k,v, attn, proj, fc1, fc2
        "lif_dispatches": n_tok + (n_units + 1) * meta.num_layers,
        # tick-batched: each folded weight is read once per image batch for all T
        "weight_reads": n_tok + n_units * meta.num_layers + 1,
        "backend": meta.backend.kind,
        "packed": meta.backend.packed,
        "sparse": meta.backend.sparse,
        # bits per spike moved between layers: 32 (f32) dense, or the packed
        # word amortised over the T steps it carries
        "bits_per_spike": (32 * -(-meta.cfg.t // 32) / meta.cfg.t
                           if meta.backend.packed else 32),
        "param_count": _numel(plan.params),
    }


def _lm_plan_stats(plan: DeployPlan) -> dict:
    """:func:`plan_stats` of an LM plan, with the JAX package's keys (the
    bundle keys read ``PlanMeta.bundle``: the measured oracle deviation of the
    applied transform, None when bundling is off)."""
    meta = plan.meta
    cfg = meta.cfg
    info = meta.bundle
    n_units = len(meta.block_units)
    return {
        "decode_entry": True,          # per-sequence O(d^2) SSA state, flat in S
        "decode_state_bytes": meta.decode.state_bytes(1),
        "folded_linear_rmsnorm": n_units * meta.num_layers,
        "folded_embed_norm": 1,
        "rmsnorm_ops": 0,              # folded at plan-compile time
        "fused_lif_iand_dispatches": 2 * meta.num_layers,
        "standalone_iand_ops": 0,
        "standalone_add_ops": 0,
        # encoding LIF + per block: q, k, v, attn, proj, fc1, fc2
        "lif_dispatches": 1 + (n_units + 1) * meta.num_layers,
        "weight_reads": 1 + n_units * meta.num_layers + 1,
        "attn_ordering": cfg.attn_ordering,
        "backend": meta.backend.kind,
        "packed": meta.backend.packed,
        "sparse": meta.backend.sparse,
        "bits_per_spike": (32 * -(-cfg.t // 32) / cfg.t if meta.backend.packed else 32),
        "param_count": _numel(plan.params),
        "bundled": info is not None,
        "bundle_rows_merged": info.rows_merged if info else 0,
        "bundle_radius": info.radius if info else None,
        "bundle_budget": info.budget if info else None,
        "bundle_logit_err": info.logit_err if info else None,
    }
