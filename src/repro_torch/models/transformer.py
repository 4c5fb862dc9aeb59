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
``distributed.sharding.spec``); the logical-axis constraints on activations
are identities in eager PyTorch (``distributed.sharding.constrain``).

``init_lm`` and ``cache_init`` run on the card unless ``device`` says
otherwise (``bridge.resolve_device``: without a card that raises); on
``device="meta"`` they build the trees' shapes and dtypes with no memory
(how the 123B and 1T configs are counted).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import layer_params, leaves, rebuild, resolve_device
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
                collect_cache: bool):
    """x: (B, S, D). Returns (x', aux_loss, cache_kv_or_None)."""
    cd = _dtype(cfg.compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if kind in ("attn_mlp", "attn_local", "attn_moe"):
        window = cfg.local_window if kind == "attn_local" else None
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, (k, v) = L.attention_apply(p["attn"], h, cfg, positions=positions, window=window,
                                      prefix_len=prefix_len, compute_dtype=cd)
        x = x + y
        h = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        if kind == "attn_moe":
            y, aux = MOE.moe_apply(p["moe"], h, cfg, compute_dtype=cd)
        else:
            y = L.mlp_apply(p["mlp"], h, act=cfg.act, compute_dtype=cd)
        x = x + y
        if collect_cache:
            if kind == "attn_local":
                # ring-buffer alignment: with S % window == 0 the last window
                # tokens land at slots t % window = 0..window-1 in order
                w = min(cfg.local_window, k.shape[1])
                k, v = k[:, -w:], v[:, -w:]
            cache = {"k": k.to(cd), "v": v.to(cd)}
    elif kind == "ssm":
        h = L.rmsnorm_apply(p["ln"], x, eps=cfg.norm_eps)
        if collect_cache:
            y, cache = M2.mamba2_apply(p["mixer"], h, cfg, compute_dtype=cd, return_cache=True)
        else:
            y = M2.mamba2_apply(p["mixer"], h, cfg, compute_dtype=cd)
        x = x + y
    elif kind == "rec":
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, rec_out = RG.rglru_block_apply(p["rec"], h, cfg, compute_dtype=cd,
                                          return_cache=collect_cache)
        x = x + y
        h2 = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h2, act=cfg.act, compute_dtype=cd)
        if collect_cache:
            cache = rec_out
    else:
        raise ValueError(kind)
    return x, aux, cache


# ---------------------------------------------------------------------------
# per-block decode
# ---------------------------------------------------------------------------

def block_decode(p, x, cache, cfg: ArchConfig, kind: str, *, pos):
    """x: (B, 1, D); cache: per-layer dict. Returns (x', cache')."""
    cd = _dtype(cfg.compute_dtype)
    if kind in ("attn_mlp", "attn_local", "attn_moe"):
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, ck, cv = L.attention_decode_apply(p["attn"], h, cfg, cache_k=cache["k"],
                                             cache_v=cache["v"], pos=pos, compute_dtype=cd,
                                             ring=kind == "attn_local")
        x = x + y
        h = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        if kind == "attn_moe":
            y, _ = MOE.moe_apply(p["moe"], h, cfg, compute_dtype=cd)
        else:
            y = L.mlp_apply(p["mlp"], h, act=cfg.act, compute_dtype=cd)
        return x + y, {"k": ck, "v": cv}
    if kind == "ssm":
        h = L.rmsnorm_apply(p["ln"], x, eps=cfg.norm_eps)
        y, new_cache = M2.mamba2_decode_step(p["mixer"], h, cache, cfg, compute_dtype=cd)
        return x + y, new_cache
    if kind == "rec":
        h = L.rmsnorm_apply(p["ln1"], x, eps=cfg.norm_eps)
        y, new_cache = RG.rglru_decode_step(p["rec"], h, cache, cfg, compute_dtype=cd)
        x = x + y
        h2 = L.rmsnorm_apply(p["ln2"], x, eps=cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h2, act=cfg.act, compute_dtype=cd)
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
# whole-model forward (train / prefill)
# ---------------------------------------------------------------------------

def _scaled(x, cfg: ArchConfig, cd):
    """``x * sqrt(d_model)`` with the factor rounded to the compute dtype
    first, as the JAX package's ``jnp.asarray(sqrt(d), cd)`` rounds it (in
    bf16, sqrt(2048) is 45.25)."""
    if not cfg.embed_scale:
        return x
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd).item()


def embed_inputs(params, batch, cfg: ArchConfig):
    """Returns (x (B,S,D) in compute dtype, prefix_len)."""
    cd = _dtype(cfg.compute_dtype)
    if cfg.modality == "text":
        x = params["embed"]["table"][batch["tokens"].long()]
        prefix_len = 0
    elif cfg.modality == "audio_stub":
        x = batch["embeds"]  # precomputed EnCodec frame embeddings (stub)
        prefix_len = 0
    elif cfg.modality == "vision_stub":
        text = params["embed"]["table"][batch["tokens"].long()]
        x = torch.cat([batch["image_embeds"].to(text.dtype), text], dim=1)
        prefix_len = batch["image_embeds"].shape[1]
    else:
        raise ValueError(cfg.modality)
    return _scaled(x.to(cd), cfg, cd), prefix_len


def _logits(params, x, cfg: ArchConfig):
    x = L.rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return x @ w.to(x.dtype)


def _remat_on(cfg: ArchConfig, p) -> bool:
    return cfg.remat and torch.is_grad_enabled() and any(t.requires_grad for t in leaves(p))


def forward(params, batch, cfg: ArchConfig, *, collect_cache: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss, cache_or_None)."""
    kinds = layer_kinds(cfg)
    x, prefix_len = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    uniform = _uniform(cfg)
    caches = []
    for i, kind in enumerate(kinds):
        p_l = layer_params(params["layers"], i) if uniform else params["layers"][i]
        fn = functools.partial(block_apply, cfg=cfg, kind=kind, positions=positions,
                               prefix_len=prefix_len, collect_cache=collect_cache)
        if _remat_on(cfg, p_l):
            x, a, c = checkpoint(fn, p_l, x, use_reentrant=False)
        else:
            x, a, c = fn(p_l, x)
        aux = aux + a
        caches.append(c)
    cache = None
    if collect_cache:
        cache = _stack(caches) if uniform else caches
    return _logits(params, x, cfg), aux, cache


# ---------------------------------------------------------------------------
# whole-model decode
# ---------------------------------------------------------------------------

def decode(params, cache, batch, pos, cfg: ArchConfig):
    """One-token decode. batch: {'token': (B,1)} (text) or {'embeds': (B,1,D)};
    ``pos`` an int.  Returns (logits (B,1,V), cache'), the
    given cache untouched."""
    cd = _dtype(cfg.compute_dtype)
    kinds = layer_kinds(cfg)
    if cfg.modality == "audio_stub":
        x = batch["embeds"].to(cd)
    else:
        x = params["embed"]["table"][batch["token"].long()].to(cd)
    x = _scaled(x, cfg, cd)

    if _uniform(cfg):
        new = []
        for i in range(cfg.num_layers):
            x, c_new = block_decode(layer_params(params["layers"], i), x,
                                    layer_params(cache, i), cfg, kinds[0], pos=pos)
            new.append(c_new)
        new_cache = _stack(new)
    else:
        new_cache = []
        for i, kind in enumerate(kinds):
            x, c_new = block_decode(params["layers"][i], x, cache[i], cfg, kind, pos=pos)
            new_cache.append(c_new)
    return _logits(params, x, cfg), new_cache


def num_params(params) -> int:
    return sum(x.numel() for x in leaves(params))
