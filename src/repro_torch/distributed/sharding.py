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


def constrain(x, *logical_names: str | None):
    """The identity.  In the JAX package this is a layout hint to the GSPMD
    partitioner (``with_sharding_constraint``); eager PyTorch has no
    partitioner, and the port's sharded executors place every shard
    themselves, so there is nothing to hint."""
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
