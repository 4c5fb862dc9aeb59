"""Logical-axis sharding rules.

Mesh axes: ``(data, model)`` single-pod, ``(pod, data, model)`` multi-pod.
Parameters are 2-D sharded (FSDP over ``data`` x TP over ``model``) and
replicated over ``pod``; the batch is sharded over ``(pod, data)``.  Model
code names LOGICAL axes; the active rule set maps them to mesh axes, so a
sharding change is a swap of rules dicts, not an edit of model code.

The rules are the JAX package's, key for key.  :func:`spec` returns the
tuple of mesh-axis entries that JAX's ``PartitionSpec`` holds (one entry per
tensor dim: an axis name, a tuple of names, or None for a replicated dim);
:class:`NamedSharding` pairs such a spec with a host mesh
(``launch.mesh.HostMesh``) and cuts a rank's block of a global array.

:func:`sanitize_spec` replicates a dim that its mesh axes do not divide (as
the JAX package's dry run does before it hands a sharding to ``jit``);
:func:`sanitized_specs` does so for a whole tree, :func:`shard_tree` cuts a
global tree into this rank's shards from those specs and :func:`gather_tree`
assembles it back -- what the sharded executor of the generic LM
(``models.lm.make_*_step(mesh=)``) takes and gives.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any

# logical axis -> mesh axes (None = replicated)
BASE_RULES: dict[str, Any] = {
    "batch": ("data",),
    "seq": None,              # sequence parallelism off by default
    "embed": None,            # activation d_model dim
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "data",
    "expert_group": "data",   # MoE dispatch groups (aligned with the DP axis)
    "moe_dispatch": "model",  # E dim of the (G, E, C, D) dispatch buffer
    "moe_slots": None,        # slot dim of expert-major (E, G*C, D) tensors
    "cache_seq": "model",     # decode KV cache sharded along sequence
    "fsdp": "data",           # parameter FSDP axis
    "tp": "model",            # parameter tensor-parallel axis
}

MULTI_POD_OVERRIDES: dict[str, Any] = {
    "batch": ("pod", "data"),  # pod axis is pure DP
}

# Named rule presets:
#   base  : 2-D FSDP x TP -- batch over data, heads/ffn/vocab over model;
#   fsdp  : ZeRO-3 -- batch over (data x model), no tensor parallelism;
#   sp    : sequence-parallel residual stream (Megatron-SP);
#   zero2 : replicated params, sharded optimizer states.
PRESET_OVERRIDES: dict[str, dict[str, Any]] = {
    "base": {},
    "fsdp": {
        "batch": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "ffn": None,
        "vocab": None,
        "expert_group": ("data", "model"),
        "moe_dispatch": None,
        "expert": None,
        "moe_slots": ("data", "model"),
        "cache_seq": None,
    },
    "sp": {
        "seq": "model",
    },
    "zero2": {
        "batch": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "ffn": None,
        "vocab": None,
        "expert_group": ("data", "model"),
        "moe_dispatch": None,
        "expert": None,
        "moe_slots": ("data", "model"),
        "cache_seq": None,
        "params": "replicated",
    },
}


def make_rules(*, multi_pod: bool = False, preset: str = "base", **overrides) -> dict[str, Any]:
    rules = dict(BASE_RULES)
    rules.update(PRESET_OVERRIDES[preset])
    if multi_pod:
        rules.update(MULTI_POD_OVERRIDES)
        if preset == "fsdp":
            rules["batch"] = ("pod", "data", "model")
    rules.update(overrides)
    return rules


# Deploy-engine overrides per plan family (``engine.plan.ShardingCfg``
# resolves through these).  Bit-exactness against the single-device plan is
# the contract of the sharded engine, and the two families keep it
# differently:
#
#   vision: folded Linear+BN units have no cross-feature epilogue, so the
#     column-parallel schedule is exact -- the residual spike stream lives
#     feature-sharded between joins (embed -> model), heads and ffn columns
#     are sharded, and every cross-device edge is a feature all-gather.
#   lm: folded Linear+RMSNorm units keep a normalizer that reduces over the
#     full output-feature row (``nn.rms_epilogue``); splitting that f32 sum
#     across shards would reassociate it.  So LM units run model-replicated
#     and the model axis shards the SSA heads (and the per-head K^T V decode
#     state) only.
ENGINE_FAMILY_OVERRIDES: dict[str, dict[str, Any]] = {
    "vision": {"embed": "model"},
    "lm": {"embed": None, "ffn": None, "vocab": None},
}


def engine_rules(family: str, *, preset: str = "base", **overrides) -> dict[str, Any]:
    """Logical-axis rules of a deploy-engine plan family ("vision" | "lm"):
    :func:`make_rules` with the family's exactness-preserving overrides
    (explicit ``overrides`` still win)."""
    if family not in ENGINE_FAMILY_OVERRIDES:
        raise ValueError(f"unknown engine plan family: {family!r}")
    ov = dict(ENGINE_FAMILY_OVERRIDES[family])
    ov.update(overrides)
    return make_rules(preset=preset, **ov)


_ACTIVE_RULES: dict[str, Any] | None = None


@contextlib.contextmanager
def use_rules(rules: dict[str, Any] | None):
    """Install sharding rules for the duration of the block."""
    global _ACTIVE_RULES
    prev = _ACTIVE_RULES
    _ACTIVE_RULES = rules
    try:
        yield
    finally:
        _ACTIVE_RULES = prev


def active_rules() -> dict[str, Any] | None:
    return _ACTIVE_RULES


def _entry(axes):
    """One spec entry as ``PartitionSpec`` normalises it: a 1-tuple of axis
    names becomes the bare name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def spec(*logical_names: str | None, rules: dict[str, Any] | None = None) -> tuple:
    """The mesh-axis entry of each logical axis name (None = replicated dim):
    the entries of the JAX package's ``PartitionSpec``."""
    r = rules if rules is not None else (_ACTIVE_RULES or {})
    return tuple(None if name is None else _entry(r.get(name)) for name in logical_names)


def check_spec(*logical_names: str | None, rules: dict[str, Any] | None = None) -> tuple:
    """:func:`spec` of ``logical_names``, raising ``ValueError`` where it maps
    one mesh axis to two dims: the ``PartitionSpec`` that JAX's
    ``NamedSharding`` refuses with ``DuplicateSpecError``, whose message this
    one follows."""
    entries = spec(*logical_names, rules=rules)
    seen = [a for e in entries for a in entry_axes(e)]
    dups = sorted({a for a in seen if seen.count(a) > 1})
    if dups:
        raise ValueError(
            "a spec can map every mesh axis to at most one positional dimension, but "
            f"PartitionSpec({', '.join(map(repr, entries))}) of the logical axes "
            f"{logical_names} has duplicate entries for " + ", ".join(f"`{a}`" for a in dups))
    return entries


def constrain(x, *logical_names: str | None):
    """The identity, with or without a mesh.  In the JAX package this is a
    layout hint to the GSPMD partitioner (``with_sharding_constraint``).
    Eager PyTorch has no partitioner: the port's sharded executors place
    every shard themselves (the deploy engine's ``compile_plan(mesh=)``, the
    generic LM's ``make_*_step(mesh=)``, which cut the parameters, caches and
    batch by :func:`shard_tree` and run the collectives of
    ``launch.mesh.MeshAxis`` where the layout changes), so there is nothing
    to hint."""
    return x


def param_spec(*logical_names: str | None, rules: dict[str, Any] | None = None) -> tuple:
    return spec(*logical_names, rules=rules)


@dataclass(frozen=True)
class NamedSharding:
    """A spec (one mesh-axis entry per tensor dim, as :func:`spec` returns)
    on a host mesh (``launch.mesh.HostMesh``): which block of a global array
    this rank holds.  A dim mapped to axes of total size n is cut into n
    equal blocks, in the order of the axes given (major first), as JAX
    lays out a ``NamedSharding``."""

    mesh: Any
    spec: tuple = ()

    def local_slices(self, shape) -> tuple[slice, ...]:
        out = []
        for i, n in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            parts = math.prod(self.mesh.axis(a).size for a in names)
            if n % parts:
                raise ValueError(f"dim {i} of size {n} does not split into {parts} blocks "
                                 f"over mesh axes {names}")
            index = 0
            for a in names:
                ax = self.mesh.axis(a)
                index = index * ax.size + ax.rank
            block = n // parts
            out.append(slice(index * block, (index + 1) * block))
        return tuple(out)


# -- shards of whole trees ---------------------------------------------------------


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a host mesh (``launch.mesh.HostMesh``) or an
    abstract one (``launch.dryrun.AbstractMesh``)."""
    shape = mesh.shape
    return dict(shape) if isinstance(shape, dict) else dict(zip(mesh.axis_names, shape))


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh-axis names of one spec entry (None -> none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, axes) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(axes))


def sanitize_spec(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple:
    """Drop spec axes whose size does not divide the dimension (an argument
    sharding needs exact divisibility; dropping = replication along that
    axis, e.g. vocab 49155 or 40 experts on a 16-wide axis)."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    out = [ax if ax is not None and dim % axis_size(mesh, ax) == 0 else None
           for dim, ax in zip(shape, axes)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x)


def sanitized_specs(specs, like, mesh):
    """The spec tree of ``like`` (a tree of tensors, meta ones included) with
    every leaf's spec sanitized against its global shape on ``mesh``.  A
    spec tuple at a tensor's place is that tensor's (the form of
    ``transformer.param_pspecs``)."""
    if isinstance(like, dict):
        return {k: sanitized_specs(specs[k], like[k], mesh) for k in like}
    if isinstance(like, (list, tuple)) and not _is_spec(specs):
        return type(like)(sanitized_specs(s, x, mesh) for s, x in zip(specs, like))
    return sanitize_spec(mesh, specs, tuple(like.shape))


def map_leaves(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree, walked by the
    tree's keys (a tree that crossed from the JAX package holds its dicts'
    keys sorted, the spec tree in the port's order)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, x, s) for x, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """This rank's shard of every leaf of the global ``tree`` under its
    (sanitized) spec: a copy of its block, or the leaf itself when the spec
    keeps it whole on this mesh."""
    def cut(x, spec):
        sl = NamedSharding(mesh, spec).local_slices(tuple(x.shape))
        if all(s.stop - s.start == n for s, n in zip(sl, x.shape)):
            return x
        return x[sl].clone()

    return map_leaves(cut, tree, specs)


def gather_tree(tree, specs, mesh, *, kind: str = "output"):
    """The global tree from every rank's shards (each leaf all-gathered over
    the axes of its sanitized spec, the minor axis of a dim first); every
    rank calls it alike and gets the whole tree."""
    def gather(x, spec):
        for dim, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                x = mesh.axis(a).all_gather(x, dim, kind=kind)
        return x

    return map_leaves(gather, tree, specs)


def dim_axes(specs, mesh):
    """The tree of specs mapped, leaf by leaf, to a tuple over the spec's
    entries of the mesh axes (``MeshAxis``) of size above 1 each entry cuts
    its dim over (a trimmed spec's missing trailing dims are uncut)."""
    if isinstance(specs, dict):
        return {k: dim_axes(v, mesh) for k, v in specs.items()}
    if not _is_spec(specs):
        return type(specs)(dim_axes(v, mesh) for v in specs)
    return tuple(tuple(mesh.axis(a) for a in entry_axes(entry) if mesh.axis(a).size > 1)
                 for entry in specs)
