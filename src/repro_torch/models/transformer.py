"""Generic decoder-only LM covering all assigned families, the port of the
JAX package's ``models/transformer.py``.

One block vocabulary:
    attn_mlp    -- dense transformer block (musicgen, qwen, llama, mistral,
                   paligemma backbone)
    attn_moe    -- attention + MoE FFN (granite, kimi-k2)
    ssm         -- mamba2/SSD mixer block
    rec         -- RG-LRU recurrent block + MLP (recurrentgemma)
    attn_local  -- sliding-window attention block + MLP (recurrentgemma)

The parameter trees are the JAX package's, so ``bridge`` carries weights
across with no renaming: uniform-kind models stack every block leaf along a
leading L axis (the JAX package vmaps the block init and scans over it; the
port loops over ``i`` on the stacked leaves), hybrid models hold a list of
per-layer dicts.  With ``cfg.remat`` and gradients on, each block runs under
``torch.utils.checkpoint`` (nothing saved inside a block, as the JAX
package's ``nothing_saveable`` policy).

Sharding: ``param_pspecs``, ``cache_pspecs`` and ``block_pspecs`` give the
JAX package's ``PartitionSpec`` entries as tuples (the form of
``distributed.sharding.spec``).  The JAX package hands them to GSPMD, which
partitions the jitted step around its activation constraints; eager PyTorch
has no partitioner (``distributed.sharding.constrain`` is the identity), so
``forward`` and ``decode`` take an :class:`Spmd` (``spmd_layout``: this
rank's axes of a host mesh and the specs sanitized on it) and run every
layer kind SPMD on this rank's shards, every collective explicit:
vocab-parallel embedding (a masked lookup, a psum over ``model``) and
vocab-sharded logits, tensor-parallel attention and MLP
(``layers.TensorParallel``, one per layer kind), the MoE's expert-parallel
dispatch (``moe``), Mamba-2 (``mamba2``) and the RG-LRU (``rglru``) cut over
``model``, FSDP gathers of each block's weights inside the block's remat
region (the backward gathers them again, as the JAX package's ``_remat``
body does), and a prefill cache resharded from heads to the
sequence-sharded cache spec (a sliding window's ring likewise).  A batch the
batch axes do not divide (``long_500k``'s one row) stays whole on every
rank, as ``sanitize_spec`` leaves it.  With ``spmd=None`` both run the
single-device code, op for op.

The layout follows the preset's rules (``distributed.sharding.make_rules``),
one decision to a rule.  Under ``base`` the above.  Under ``fsdp`` and
``zero2`` the batch is cut over ``(data, model)`` (``(pod, data, model)``
and, as the reference's multi-pod override leaves ``zero2``, ``(pod,
data)`` on the multi-pod mesh) and no tensor parallelism runs: every rank
computes every head, the whole MLP, the whole vocabulary and, as a
device-local MoE block, every expert on its own rows, and the cache keeps
its sequence whole.  ``fsdp`` stores the parameters cut as under ``base``
and gathers each weight whole over ``data`` and ``model`` where it is used
(the backward a reduce-scatter over both: the ranks hold different rows);
``zero2`` holds them whole on every rank and cuts only the optimizer state:
each gradient is reduce-scattered to its optimizer block, updated there and
all-gathered back (:meth:`Spmd.update`).  ``sp`` raises ``ValueError`` before
any step runs: its logits' spec ``("batch", "seq", "vocab")`` names
``model`` twice, which the reference's ``NamedSharding`` refuses.

``init_lm`` and ``cache_init`` run on the card unless ``device`` says
otherwise (``bridge.resolve_device``: without a card that raises); on
``device="meta"`` they build the trees' shapes and dtypes with no memory
(how the 123B and 1T configs are counted).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import layer_params, leaves, rebuild, resolve_device
from repro_torch.distributed.sharding import (check_spec, dim_axes, entry_axes, gather_tree,
                                              make_rules, map_leaves, sanitized_specs, shard_tree)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models.config import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def layer_kinds(cfg: ArchConfig) -> list[str]:
    if cfg.family in ("dense", "audio", "vlm"):
        return ["attn_mlp"] * cfg.num_layers
    if cfg.family == "moe":
        return ["attn_moe"] * cfg.num_layers
    if cfg.family == "ssm":
        return ["ssm"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn_local")
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    raise ValueError(cfg.family)


def _uniform(cfg: ArchConfig) -> bool:
    return len(set(layer_kinds(cfg))) == 1 and cfg.scan_layers


def _stack(trees):
    """Per-layer trees -> one tree with every leaf stacked along a new L axis."""
    return rebuild(trees[0], iter(torch.stack(xs) for xs in zip(*map(leaves, trees))))


# ---------------------------------------------------------------------------
# per-block init / pspecs
# ---------------------------------------------------------------------------

def _norm(d, dtype, device, lead):
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def block_init(generator, cfg: ArchConfig, kind: str, dtype, device=None, lead: tuple = ()):
    """One block's parameters; ``lead=(L,)`` stacks L blocks in one draw."""
    d = cfg.d_model
    dev = L._device(generator, device)
    kw = dict(dtype=dtype, device=device, lead=lead)
    if kind in ("attn_mlp", "attn_local", "attn_moe"):
        p = {"ln1": _norm(d, dtype, dev, lead), "attn": L.attention_init(generator, cfg, **kw),
             "ln2": _norm(d, dtype, dev, lead)}
        if kind == "attn_moe":
            p["moe"] = MOE.moe_init(generator, cfg, **kw)
        else:
            p["mlp"] = L.mlp_init(generator, d, cfg.d_ff, act=cfg.act, **kw)
        return p
    if kind == "ssm":
        return {"ln": _norm(d, dtype, dev, lead), "mixer": M2.mamba2_init(generator, cfg, **kw)}
    if kind == "rec":
        return {"ln1": _norm(d, dtype, dev, lead), "rec": RG.rglru_init(generator, cfg, **kw),
                "ln2": _norm(d, dtype, dev, lead),
                "mlp": L.mlp_init(generator, d, cfg.d_ff, act=cfg.act, **kw)}
    raise ValueError(kind)


def _attn_pspecs(cfg):
    p = {
        "wq": {"w": ("data", "model")},
        "wk": {"w": ("data", "model")},
        "wv": {"w": ("data", "model")},
        "wo": {"w": ("model", "data")},
    }
    if cfg.qkv_bias:
        for n in ("wq", "wk", "wv"):
            p[n]["b"] = ("model",)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": (None,)}
        p["k_norm"] = {"scale": (None,)}
    return p


def _mlp_pspecs(cfg):
    p = {"down": {"w": ("model", "data")}, "up": {"w": ("data", "model")}}
    if cfg.act in ("swiglu", "geglu"):
        p["gate"] = {"w": ("data", "model")}
    return p


def block_pspecs(cfg: ArchConfig, kind: str):
    if kind in ("attn_mlp", "attn_local"):
        return {"ln1": {"scale": (None,)}, "attn": _attn_pspecs(cfg),
                "ln2": {"scale": (None,)}, "mlp": _mlp_pspecs(cfg)}
    if kind == "attn_moe":
        return {
            "ln1": {"scale": (None,)},
            "attn": _attn_pspecs(cfg),
            "ln2": {"scale": (None,)},
            "moe": {
                "router": {"w": (None, None)},
                "w_gate": ("data", None, "model"),
                "w_up": ("data", None, "model"),
                "w_down": ("data", "model", None),
            },
        }
    if kind == "ssm":
        return {
            "ln": {"scale": (None,)},
            "mixer": {
                "in_proj": {"w": ("data", "model")},
                "conv_w": (None, "model"),
                "conv_b": ("model",),
                "A_log": (None,),
                "D": (None,),
                "dt_bias": (None,),
                "norm": {"scale": (None,)},
                "out_proj": {"w": ("model", "data")},
            },
        }
    if kind == "rec":
        return {
            "ln1": {"scale": (None,)},
            "rec": {
                "w_x": {"w": ("data", "model")},
                "w_y": {"w": ("data", "model")},
                "conv_w": (None, "model"),
                "conv_b": ("model",),
                "gate_a": {"w": ("model", None, None), "b": ("model",)},
                "gate_x": {"w": ("model", None, None), "b": ("model",)},
                "lam": ("model",),
                "w_out": {"w": ("model", "data")},
            },
            "ln2": {"scale": (None,)},
            "mlp": _mlp_pspecs(cfg),
        }
    raise ValueError(kind)


def _prepend_layer_dim(specs):
    """Every spec tuple of a tree with a replicated L axis in front."""
    if isinstance(specs, dict):
        return {k: _prepend_layer_dim(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_prepend_layer_dim(v) for v in specs]
    return (None,) + tuple(specs)


# ---------------------------------------------------------------------------
# per-block apply (train / prefill)
# ---------------------------------------------------------------------------

def block_apply(p, x, cfg: ArchConfig, kind: str, *, positions, prefix_len: int,
                collect_cache: bool, tp: L.TensorParallel | None = None):
    """x: (B, S, D). Returns (x', aux_loss, cache_kv_or_None); under ``tp``
    (the block on this rank's shards) the cache is this rank's block of
    ``cache_pspecs``."""
    cd = _dtype(cfg.compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if kind in ("attn_mlp", "attn_local", "attn_moe"):
        window = cfg.local_window if kind == "attn_local" else None
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, (k, v) = L.attention_apply(p["attn"], h, cfg, positions=positions, window=window,
                                      prefix_len=prefix_len, compute_dtype=cd, tp=tp)
        x = x + y
        h = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        if kind == "attn_moe":
            y, aux = MOE.moe_apply(p["moe"], h, cfg, compute_dtype=cd, tp=tp)
        else:
            y = L.mlp_apply(p["mlp"], h, act=cfg.act, compute_dtype=cd, tp=tp)
        x = x + y
        if collect_cache:
            if kind == "attn_local":
                # ring-buffer alignment: with S % window == 0 the last window
                # tokens land at slots t % window = 0..window-1 in order
                w = min(cfg.local_window, k.shape[1])
                k, v = k[:, -w:], v[:, -w:]
            cache = {"k": k.to(cd), "v": v.to(cd)}
            if tp is not None:
                cache = {n: _kv_to_seq(c, tp) for n, c in cache.items()}
    elif kind == "ssm":
        h = L.rmsnorm_apply(p["ln"], x, eps=cfg.norm_eps)
        if collect_cache:
            y, cache = M2.mamba2_apply(p["mixer"], h, cfg, compute_dtype=cd, return_cache=True,
                                       tp=tp)
        else:
            y = M2.mamba2_apply(p["mixer"], h, cfg, compute_dtype=cd, tp=tp)
        x = x + y
    elif kind == "rec":
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, rec_out = RG.rglru_block_apply(p["rec"], h, cfg, compute_dtype=cd,
                                          return_cache=collect_cache, tp=tp)
        x = x + y
        h2 = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h2, act=cfg.act, compute_dtype=cd, tp=tp)
        if collect_cache:
            cache = rec_out
    else:
        raise ValueError(kind)
    return x, aux, cache


def _kv_to_seq(c, tp: L.TensorParallel):
    """A prefill's k or v (B, S, KV_local, Dh) as the cache block (B, S/M,
    KV, Dh) of a sequence cut over ``tp.seq`` (``model``): an all-to-all over
    ``model`` from heads to sequence, or this rank's block where every rank
    computed every head; with the sequence whole (``tp.seq`` of size 1, and
    then ``tp.model`` too), the block as it is."""
    if tp.seq.size == 1:
        return c
    if tp.kv_split:
        return tp.seq.all_to_all(c, 1, 2, kind="state")
    return tp.seq.block(c, 1)


# ---------------------------------------------------------------------------
# per-block decode
# ---------------------------------------------------------------------------

def block_decode(p, x, cache, cfg: ArchConfig, kind: str, *, pos,
                 tp: L.TensorParallel | None = None):
    """x: (B, 1, D); cache: per-layer dict. Returns (x', cache')."""
    cd = _dtype(cfg.compute_dtype)
    if kind in ("attn_mlp", "attn_local", "attn_moe"):
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, ck, cv = L.attention_decode_apply(p["attn"], h, cfg, cache_k=cache["k"],
                                             cache_v=cache["v"], pos=pos, compute_dtype=cd,
                                             ring=kind == "attn_local", tp=tp)
        x = x + y
        h = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        if kind == "attn_moe":
            y, _ = MOE.moe_apply(p["moe"], h, cfg, compute_dtype=cd, tp=tp, aux_loss=False)
        else:
            y = L.mlp_apply(p["mlp"], h, act=cfg.act, compute_dtype=cd, tp=tp)
        return x + y, {"k": ck, "v": cv}
    if kind == "ssm":
        h = L.rmsnorm_apply(p["ln"], x, eps=cfg.norm_eps)
        y, new_cache = M2.mamba2_decode_step(p["mixer"], h, cache, cfg, compute_dtype=cd, tp=tp)
        return x + y, new_cache
    if kind == "rec":
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, new_cache = RG.rglru_decode_step(p["rec"], h, cache, cfg, compute_dtype=cd, tp=tp)
        x = x + y
        h2 = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h2, act=cfg.act, compute_dtype=cd, tp=tp)
        return x, new_cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# decode-cache construction
# ---------------------------------------------------------------------------

def block_cache_init(cfg: ArchConfig, kind: str, batch: int, seq_len: int, dtype,
                     device=None):
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    if kind in ("attn_mlp", "attn_moe", "attn_local"):
        s = min(seq_len, cfg.local_window) if kind == "attn_local" else seq_len
        shape = (batch, s, kv, dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "ssm":
        return M2.mamba2_cache_init(cfg, batch, dtype, device)
    if kind == "rec":
        return RG.rglru_cache_init(cfg, batch, dtype, device)
    raise ValueError(kind)


def block_cache_pspecs(cfg: ArchConfig, kind: str):
    if kind in ("attn_mlp", "attn_moe", "attn_local"):
        kv_spec = ("data", "model", None, None)  # sequence-sharded KV cache
        return {"k": kv_spec, "v": kv_spec}
    if kind == "ssm":
        return {"state": ("data", None, None, None), "conv": ("data", None, "model")}
    if kind == "rec":
        return {"h": ("data", "model"), "conv": ("data", None, "model")}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# whole-model init / pspecs
# ---------------------------------------------------------------------------

def init_lm(key: int, cfg: ArchConfig, *, device=None):
    """The JAX package's parameter tree for ``cfg``, drawn from the int seed
    ``key``.  ``device``: the card when None, ``"cpu"``, or ``"meta"``
    (shapes and dtypes only).  Values differ from the JAX package's
    (another generator); carry its weights across with ``bridge``."""
    dtype = _dtype(cfg.param_dtype)
    kinds = layer_kinds(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(key)
    params: dict = {}

    if cfg.modality != "audio_stub":
        table = L._empty_or(gen, (cfg.vocab_size, cfg.d_model), dtype, dev)
        params["embed"] = {"table": table.mul_(0.02) if gen is not None else table}

    if _uniform(cfg):
        params["layers"] = block_init(gen, cfg, kinds[0], dtype, dev, lead=(cfg.num_layers,))
    else:
        params["layers"] = [block_init(gen, cfg, kind, dtype, dev) for kind in kinds]

    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        w = L._empty_or(gen, (cfg.d_model, cfg.vocab_size), dtype, dev)
        params["lm_head"] = {"w": w.mul_(cfg.d_model ** -0.5) if gen is not None else w}
    return params


def param_pspecs(cfg: ArchConfig):
    kinds = layer_kinds(cfg)
    specs: dict = {}
    if cfg.modality != "audio_stub":
        specs["embed"] = {"table": ("model", "data")}
    if _uniform(cfg):
        specs["layers"] = _prepend_layer_dim(block_pspecs(cfg, kinds[0]))
    else:
        specs["layers"] = [block_pspecs(cfg, k) for k in kinds]
    specs["final_norm"] = {"scale": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ("data", "model")}
    return specs


def cache_init(cfg: ArchConfig, batch: int, seq_len: int, *, device=None):
    """The decode cache of ``batch`` sequences of up to ``seq_len`` tokens, in
    the compute dtype (zeros; on ``"meta"``, shapes only)."""
    dtype = _dtype(cfg.compute_dtype)
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    if _uniform(cfg):
        one = block_cache_init(cfg, kinds[0], batch, seq_len, dtype, dev)
        return rebuild(one, iter(torch.zeros((cfg.num_layers,) + tuple(a.shape), dtype=a.dtype,
                                             device=dev) for a in leaves(one)))
    return [block_cache_init(cfg, k, batch, seq_len, dtype, dev) for k in kinds]


def cache_pspecs(cfg: ArchConfig):
    kinds = layer_kinds(cfg)
    if _uniform(cfg):
        return _prepend_layer_dim(block_cache_pspecs(cfg, kinds[0]))
    return [block_cache_pspecs(cfg, k) for k in kinds]


# ---------------------------------------------------------------------------
# the SPMD layout
# ---------------------------------------------------------------------------

_ATTN_KINDS = ("attn_mlp", "attn_moe", "attn_local")
# the JAX package's activation constraints (``constrain``), by logical axes:
# the residual stream and the logits, and the MoE's dispatch
_CONSTRAINTS = (("batch", "seq", "embed"), ("batch", "seq", "vocab"))
_MOE_CONSTRAINTS = (("expert_group", None, None), ("expert_group", "moe_dispatch", None, None),
                    ("expert", "moe_slots", None))


@dataclass(frozen=True)
class Spmd:
    """A model's SPMD on a host mesh as one rank runs it: ``mesh``
    (``launch.mesh.HostMesh``, a real world's or a record-only one),
    ``rules`` (``distributed.sharding.make_rules`` of the preset on that
    mesh), ``specs`` (``param_pspecs`` sanitized on the mesh against the
    global shapes, a hybrid model's layers a list, by position; all
    replicated where the rules replicate the parameters), ``opt_specs``
    (those the optimizer state is cut by: ``param_pspecs`` sanitized, under
    every preset), ``tps`` (each layer kind's ``layers.TensorParallel``),
    ``vocab_split`` (the vocabulary cut over ``model``: the embedding, the
    head and the loss run vocab-parallel) and ``batch`` (the axes the batch
    is cut over, ``rules["batch"]``)."""

    cfg: ArchConfig
    mesh: Any
    rules: dict
    specs: dict
    opt_specs: dict
    tps: dict
    vocab_split: bool
    batch: tuple

    @property
    def model(self):
        return self.mesh.axis("model")

    @property
    def replicated(self) -> bool:
        """Whether every rank holds the whole parameters (``zero2``)."""
        return self.rules.get("params") == "replicated"

    @property
    def batch_entry(self):
        """The spec entry of a batch dim: an axis name, or a tuple of them."""
        names = tuple(a.name for a in self.batch)
        return names[0] if len(names) == 1 else names

    def weight(self, w, spec):
        """A weight outside the blocks (the embedding, the head) gathered
        where its spec cuts it (``layers.TensorParallel.weight``)."""
        return next(iter(self.tps.values())).weight(w, spec)

    def cache_specs(self, cache):
        """The specs of the cache the sharded steps take and give, sanitized
        against a global cache tree: ``cache_pspecs`` with the batch dim cut
        like the batch, a KV cache's sequence over ``model`` only where
        ``rules["cache_seq"]`` says so, and the Mamba-2 and RG-LRU caches'
        channels over ``model`` only where the blocks run tensor-parallel
        over it.  Two divergences from the reference's spec, whose jitted
        serve step leaves the cache's layout inside the step to GSPMD: on
        the multi-pod mesh it cuts the cache's batch over ``data`` only, and
        so holds it whole on both pods while the tokens it serves are cut
        over ``pod``; under ``fsdp`` and ``zero2`` it cuts the cache as under
        ``base`` (the batch over ``data``, the sequence over ``model``),
        where these steps keep the sequence whole and cut the batch over the
        batch axes."""
        seq = self.rules["cache_seq"] == "model"
        tp = next(iter(self.tps.values())).model is self.model

        def block(kind):
            cut = seq if kind in _ATTN_KINDS else tp
            return {n: tuple(self.batch_entry if e == "data" else None if e == "model" and not cut
                             else e for e in sp)
                    for n, sp in block_cache_pspecs(self.cfg, kind).items()}

        kinds = layer_kinds(self.cfg)
        specs = (_prepend_layer_dim(block(kinds[0])) if _uniform(self.cfg)
                 else [block(k) for k in kinds])
        return sanitized_specs(specs, cache, self.mesh)

    def shard_axes(self):
        """For each parameter leaf, per dim, the axes of size above 1 the
        optimizer state cuts that dim over (the optimizers' ``shard_axes``:
        the global norm sums each leaf's squares over them, Adafactor's
        factored means its row and column sums)."""
        return dim_axes(self.opt_specs, self.mesh)

    def reduce_grads(self, grads):
        """Each parameter gradient summed over the batch axes its leaf is
        not sharded over (a leaf sharded over a batch axis was
        reduce-scattered there by the backward of its gather already, or,
        an expert's, took the gradient of every token sent to it): the
        gradient of the global batch's loss.  Under replicated parameters
        each gradient is summed to its optimizer block instead: a
        reduce-scatter over each batch axis its optimizer spec cuts, an
        all-reduce over the other batch axes, and this rank's block of a
        dim cut over an axis that is no batch axis (its ranks computed the
        same rows)."""
        batch = {a.name for a in self.batch}

        def reduce(g, spec):     # the optimizer's spec: the leaf's own unless replicated
            if self.replicated:
                for dim, entry in enumerate(spec):
                    for name in entry_axes(entry):
                        ax = self.mesh.axis(name)
                        g = (ax.reduce_scatter(g, dim, kind="grad") if name in batch
                             else ax.block(g, dim))
            names = {a for entry in spec for a in entry_axes(entry)}
            for ax in self.batch:
                if ax.name not in names:
                    g = ax.all_reduce(g, kind="grad")
            return g

        return map_leaves(reduce, grads, self.opt_specs)

    def opt_init(self, optimizer, params):
        """``optimizer.init`` of this rank's parameter shards: of the blocks
        the optimizer state is cut to (under replicated parameters, this
        rank's blocks of the whole parameters it holds)."""
        if self.replicated:
            params = shard_tree(params, self.opt_specs, self.mesh)
        return optimizer.init(params)

    def update(self, optimizer, grads, opt_state, params, step):
        """``optimizer.update`` on this rank's shards, ``grads`` from
        :meth:`reduce_grads`: on the parameters' own shards, or, under
        replicated parameters, on the blocks the optimizer state is cut to,
        the new blocks all-gathered back to the whole parameters (the
        reference's "updated-param all-gather")."""
        kw = {"step": step, "shard_axes": self.shard_axes()}
        if not self.replicated:
            return optimizer.update(grads, opt_state, params, **kw)
        new, opt_state = optimizer.update(grads, opt_state,
                                          shard_tree(params, self.opt_specs, self.mesh), **kw)
        return gather_tree(new, self.opt_specs, self.mesh, kind="weight"), opt_state


def _check_constraints(cfg: ArchConfig, rules: dict) -> None:
    """The JAX package's activation constraints resolved under ``rules``:
    ``ValueError`` where one names a mesh axis twice, as JAX's
    ``DuplicateSpecError`` refuses that ``PartitionSpec`` (the ``sp``
    preset's logits, ``("batch", "seq", "vocab")``, map ``seq`` and
    ``vocab`` both to ``model``)."""
    moe = "attn_moe" in layer_kinds(cfg)
    for names in _CONSTRAINTS + (_MOE_CONSTRAINTS if moe else ()):
        check_spec(*names, rules=rules)


def spmd_layout(cfg: ArchConfig, mesh, *, preset: str = "base") -> Spmd:
    """The :class:`Spmd` of ``cfg`` on ``mesh`` (axes ``data`` and ``model``,
    and ``pod`` in front on the multi-pod mesh) under the ``preset`` rules
    (``distributed.sharding.make_rules``), every layer kind; each decision
    reads one rule: the batch axes ``batch``; the heads, the MLP and the
    vocabulary cut over ``model`` where ``heads`` / ``kv_heads``, ``ffn`` and
    ``vocab`` say ``model`` (and ``model`` divides them); the experts over
    ``data`` where ``expert`` says ``data``; the KV cache's sequence over
    ``model`` where ``cache_seq`` does; the parameters whole on every rank
    where ``params`` says ``"replicated"``.  A preset whose activation
    constraints name one mesh axis twice (``sp``) raises ``ValueError``, as
    the reference's steps raise."""
    names = tuple(mesh.axis_names)
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"the sharded executor needs a (data, model) or (pod, data, model) "
                         f"mesh, not {names}")
    rules = make_rules(multi_pod="pod" in names, preset=preset)
    _check_constraints(cfg, rules)
    dtype = _dtype(cfg.param_dtype)
    like = init_lm(0, cfg, device="meta")
    opt_specs = sanitized_specs(param_pspecs(cfg), like, mesh)
    replicated = rules.get("params") == "replicated"
    specs = map_leaves(lambda _, sp: (), like, opt_specs) if replicated else opt_specs
    batch = tuple(mesh.axis(a) for a in entry_axes(rules["batch"]))
    model = mesh.axis("model")
    one = mesh.unit("model")
    tp = model if "model" in (rules["heads"], rules["ffn"]) else one
    m = tp.size
    q_split = rules["heads"] == "model" and cfg.num_heads % m == 0
    kv_split = q_split and rules["kv_heads"] == "model" and cfg.num_kv_heads % m == 0
    mlp_split = rules["ffn"] == "model" and cfg.d_ff % m == 0
    seq = model if rules["cache_seq"] == "model" else one
    stored = model if tp is one and not replicated and model.size > 1 else None

    def block_specs(kind):
        block = block_init(None, cfg, kind, dtype, "meta")
        sp = sanitized_specs(block_pspecs(cfg, kind), block, mesh)
        return map_leaves(lambda _, s: (), block, sp) if replicated else sp

    tps = {kind: L.TensorParallel(mesh.axis("data"), tp, block_specs(kind), q_split, kv_split,
                                  mlp_split, batch, seq, rules["expert"] == "data", stored)
           for kind in sorted(set(layer_kinds(cfg)))}
    vocab_split = rules["vocab"] == "model" and cfg.vocab_size % model.size == 0
    return Spmd(cfg, mesh, rules, specs, opt_specs, tps, vocab_split, batch)


def _embed_table(params, spmd: Spmd):
    """The embedding table as this rank uses it: (V/M, D) vocab-parallel,
    its ``data`` dim gathered."""
    return spmd.weight(params["embed"]["table"], spmd.specs["embed"]["table"])


def _tied_table(params, cfg: ArchConfig, spmd: Spmd | None):
    """Under ``spmd``, a tied embedding table gathered once for a step's
    lookup and logits (one gather, and one reduce-scatter of their summed
    gradients); None otherwise."""
    if spmd is None or not cfg.tie_embeddings or cfg.modality == "audio_stub":
        return None
    return _embed_table(params, spmd)


def _lookup(params, ids, spmd: Spmd | None, table=None):
    """Embedding rows of ``ids``: a vocab-parallel table looks up the ids in
    its block (zero rows elsewhere) and sums over ``model``.  ``table``: this
    rank's table already gathered (``_tied_table``)."""
    if spmd is None:
        return params["embed"]["table"][ids.long()]
    if table is None:
        table = _embed_table(params, spmd)
    model = spmd.model
    if not spmd.vocab_split or model.size == 1:
        return table[ids.long()]
    n = table.shape[0]
    local = ids.long() - model.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return model.all_reduce(torch.where(inside[..., None], rows, torch.zeros_like(rows)))


# ---------------------------------------------------------------------------
# whole-model forward (train / prefill)
# ---------------------------------------------------------------------------

def _scaled(x, cfg: ArchConfig, cd):
    """``x * sqrt(d_model)`` with the factor rounded to the compute dtype
    first, as the JAX package's ``jnp.asarray(sqrt(d), cd)`` rounds it (in
    bf16, sqrt(2048) is 45.25)."""
    if not cfg.embed_scale:
        return x
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd).item()


def embed_inputs(params, batch, cfg: ArchConfig, *, spmd: Spmd | None = None, table=None):
    """Returns (x (B,S,D) in compute dtype, prefix_len)."""
    cd = _dtype(cfg.compute_dtype)
    if cfg.modality == "text":
        x = _lookup(params, batch["tokens"], spmd, table)
        prefix_len = 0
    elif cfg.modality == "audio_stub":
        x = batch["embeds"]  # precomputed EnCodec frame embeddings (stub)
        prefix_len = 0
    elif cfg.modality == "vision_stub":
        text = _lookup(params, batch["tokens"], spmd, table)
        x = torch.cat([batch["image_embeds"].to(text.dtype), text], dim=1)
        prefix_len = batch["image_embeds"].shape[1]
    else:
        raise ValueError(cfg.modality)
    return _scaled(x.to(cd), cfg, cd), prefix_len


def _logits(params, x, cfg: ArchConfig, spmd: Spmd | None = None, table=None):
    """Logits of the final hidden states; under ``spmd`` this rank's block
    of the vocabulary where it is cut over ``model`` (``table``: a tied
    table already gathered)."""
    x = L.rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    if spmd is None:
        w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
        return x @ w.to(x.dtype)
    if cfg.tie_embeddings:
        w = (_embed_table(params, spmd) if table is None else table).T
    else:
        w = spmd.weight(params["lm_head"]["w"], spmd.specs["lm_head"]["w"])
    if spmd.vocab_split:
        x = spmd.model.copy(x)
    return x @ w.to(x.dtype)


def _remat_on(cfg: ArchConfig, p) -> bool:
    return cfg.remat and torch.is_grad_enabled() and any(t.requires_grad for t in leaves(p))


def forward(params, batch, cfg: ArchConfig, *, collect_cache: bool = False,
            spmd: Spmd | None = None):
    """Full-sequence forward. Returns (logits, aux_loss, cache_or_None).
    Under ``spmd``: on this rank's shards of the parameters and the batch,
    logits cut over the vocabulary as ``Spmd.vocab_split`` says, the cache
    sequence-sharded."""
    kinds = layer_kinds(cfg)
    table = _tied_table(params, cfg, spmd)
    x, prefix_len = embed_inputs(params, batch, cfg, spmd=spmd, table=table)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    uniform = _uniform(cfg)
    caches = []
    for i, kind in enumerate(kinds):
        p_l = layer_params(params["layers"], i) if uniform else params["layers"][i]
        fn = functools.partial(block_apply, cfg=cfg, kind=kind, positions=positions,
                               prefix_len=prefix_len, collect_cache=collect_cache,
                               tp=None if spmd is None else spmd.tps[kind])
        if _remat_on(cfg, p_l):
            x, a, c = checkpoint(fn, p_l, x, use_reentrant=False)
        else:
            x, a, c = fn(p_l, x)
        aux = aux + a
        caches.append(c)
    cache = None
    if collect_cache:
        cache = _stack(caches) if uniform else caches
    return _logits(params, x, cfg, spmd, table), aux, cache


# ---------------------------------------------------------------------------
# whole-model decode
# ---------------------------------------------------------------------------

def decode(params, cache, batch, pos, cfg: ArchConfig, *, spmd: Spmd | None = None):
    """One-token decode. batch: {'token': (B,1)} (text) or {'embeds': (B,1,D)};
    ``pos`` an int.  Returns (logits (B,1,V), cache'), the
    given cache untouched.  Under ``spmd``: this rank's shards, the cache
    this rank's block of the sequence, logits as :func:`forward` gives
    them."""
    cd = _dtype(cfg.compute_dtype)
    kinds = layer_kinds(cfg)
    table = _tied_table(params, cfg, spmd)
    if cfg.modality == "audio_stub":
        x = batch["embeds"].to(cd)
    else:
        x = _lookup(params, batch["token"], spmd, table).to(cd)
    x = _scaled(x, cfg, cd)
    tp = (lambda kind: None) if spmd is None else spmd.tps.get

    if _uniform(cfg):
        new = []
        for i in range(cfg.num_layers):
            x, c_new = block_decode(layer_params(params["layers"], i), x,
                                    layer_params(cache, i), cfg, kinds[0], pos=pos,
                                    tp=tp(kinds[0]))
            new.append(c_new)
        new_cache = _stack(new)
    else:
        new_cache = []
        for i, kind in enumerate(kinds):
            x, c_new = block_decode(params["layers"][i], x, cache[i], cfg, kind, pos=pos,
                                    tp=tp(kind))
            new_cache.append(c_new)
    return _logits(params, x, cfg, spmd, table), new_cache


def num_params(params) -> int:
    return sum(x.numel() for x in leaves(params))
