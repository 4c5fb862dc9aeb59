"""The generic LM's sharded steps (``models.lm.make_*_step(mesh=)``) of every
layer kind on one gloo world of 4 CPU ranks, held against the port's own
single-device steps and, on the 2x2 and the multi-pod mesh, against the JAX
package's single-device ``make_train_step``, ``make_prefill_step`` and
``make_serve_step``.  Every case starts from the JAX package's weights of its
config (``init_lm(PRNGKey(0))``, through ``bridge``).

Configs: the smoke configs of the six dense archs -- GQA (llama3.2-1b),
qkv bias (qwen1.5-4b, here with ``num_heads = num_kv_heads = 3``, ``head_dim
16``: q and kv heads the model axis does not divide, so the weights are
gathered over ``model`` and those heads run on every rank), qk-norm
(qwen3-8b), one kv head with the image prefix and a tied table
(paligemma-3b), the audio stub (musicgen-large), mistral-large-123b -- and
qwen3-8b with 6 q heads on 3 kv heads (``qwen3-gqa3``): on ``model`` = 2 a
rank's 3 q heads span two kv groups, so each reads its own kv head.  Then
the other kinds: granite-moe-3b-a800m and kimi-k2-1t-a32b (8 experts, top-2:
expert parallel over ``data`` = 2, an all-to-all each way; kimi trains with
its momentum-free Adafactor), granite with 3 experts (``moe-3experts``: the
experts whole on every rank, no all-to-all), mamba2-130m (4 SSD heads, split
over ``model``) and with ``d_model`` 48 (``mamba2-3heads``: 3 heads the
model axis does not divide, scanned on every rank), recurrentgemma-9b (rec,
rec, attn_local; window 16, so the 32-token prompt fills the ring and the
serve steps at positions 32 and 33 wrap it) and with 3 heads over an
lru width of 48 (``rglru-3heads``: the RG-LRU block whole on every rank, its
caches cut).  Meshes: 1x1, 2x1, 1x2, 2x2 (``data`` x ``model``) and the
multi-pod 2x1x2 (``pod`` x ``data`` x ``model``); a world of 4 holds
replicas of the smaller ones.  Presets: every case runs under ``base``,
``fsdp`` and ``zero2`` (``PRESETS``; a ``base`` case keeps its old id),
from the same single-device references.  Steps: one train step under the config's own
optimizer (the loss, ``grad_norm``, the gathered new parameters and
moments), the prefill (the last logits and the gathered cache) and two serve
steps against a cache of 40 slots; for the SSM and hybrid configs also a
serve step at batch 1, which the data axes do not divide (every data rank
decodes the same row, as the dry run's ``long_500k`` records do).

Held: ``torch.equal`` to the single-device port on 1x1.  Elsewhere, within
(measured gaps in parentheses, largest over the cases; ``fsdp`` and
``zero2`` alike, after the semicolon):
* the loss within ``LOSS_RTOL`` 1e-6 relative (1.0e-7; 1.0e-7);
* ``grad_norm`` within ``GNORM_RTOL`` 1e-6 relative (2.3e-7; 3.4e-7);
* logits within ``ATOL`` 1e-5 (2.6e-6; 3.0e-6), caches too (2.3e-6; 2.6e-6),
  the batch-1 serve step's too (1.2e-6; 1.4e-6);
* the moments within ``LEAF_REL`` 1e-5 of each leaf's largest magnitude
  (6.4e-6, rglru-3heads' AdamW ``v``; 1.8e-6);
* the parameters within ``LEAF_REL`` of each leaf's largest magnitude
  (4.4e-6; 9.3e-7) wherever the clipped gradient exceeds ``ADAM_WELL_POSED`` 1e-6 (AdamW's
  first step is lr * g / (|g| + eps), set by the gradient's sign: where the
  gradient is zero but for rounding, such as the k-projection bias's, it
  turns on rounding noise), and elsewhere within lr * (bound + weight decay *
  |p|), the most one step moves them apart (bound 1 for AdamW,
  1 / sqrt(1 - b2) for Adafactor's 1-D leaves).
The MoE steps are held so because no routing is near a tie: the smallest gap
between a token's k-th and (k+1)-th router probability over the
single-device steps exceeds ``ROUTER_MARGIN`` 1e-5 (granite 1.9e-5, kimi
1.6e-4, moe-3experts 8.8e-4; none under it), and a mesh moves the router's
input by ulps.
Against JAX, on 2x2 and 2x1x2, every config, with the bounds of
``tests/test_torch_lm_models.py``: the loss within ``JAX_LOSS_RTOL`` 1e-5
relative (2.1e-7; 2.1e-7), ``grad_norm`` within ``JAX_GNORM_RTOL`` 1e-4
(4.6e-7; 5.7e-7), the parameters within ``JAX_STEP_ATOL`` 1e-5 (4.8e-7;
4.2e-7) where the clipped gradient exceeds ``ADAM_WELL_POSED`` and elsewhere
within one step's reach + 1e-5, the prefill's and both serve steps' logits
and caches within ``JAX_ATOL`` 1e-4 (4.4e-6, caches 3.9e-6; 4.5e-6, 3.9e-6).
Under ``zero2`` on the multi-pod mesh (the batch cut over ``(pod, data)``
only, as the reference's multi-pod override leaves it) the two ``model``
ranks of a pod compute the same rows: their own results are ``torch.equal``.

The sharded Adafactor alone: two factored updates (kimi's settings, the
clip active) of leaves cut over ``data``, ``model``, both, a stacked leaf
and a vector on the 2x2 mesh: ``row``/``col`` and the parameters within
``ADAFACTOR_RTOL`` 1e-6 of the single-device update relative to each leaf's
largest magnitude (1.7e-7), the clip's norm within it of ``global_norm``'s
(equal).

The recorded collectives: each rank's operand bytes of every collective kind
in the real world equal, kind by kind, what a record-only mesh of the same
shape records on meta (``launch.mesh.record_only_mesh``), for a dense, an
expert-parallel MoE, kimi's Adafactor, Mamba-2 and recurrentgemma step,
under each preset.  Under ``fsdp`` and ``zero2`` no step moves an
all-to-all, every all-reduce carries a scalar, the MoE's per-expert
statistics, a gradient the optimizer state leaves whole over a batch axis or
Adafactor's factored sums, and ``zero2``'s prefill and decode steps gather
nothing.  The ``sp`` preset fails as the JAX package's steps do: JAX's
``NamedSharding`` refuses the logits' spec with ``DuplicateSpecError`` and
the port's step builders raise ``ValueError`` naming ``model``.
"""

import hashlib
import traceback

import numpy as np
import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import bridge
from repro_torch.distributed.sharding import (dim_axes, entry_axes, gather_tree, map_leaves,
                                              sanitized_specs, shard_tree)
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeCell
from repro_torch.optim.optimizer import OptimizerConfig, global_norm, make_optimizer

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

B, S, CACHE = 4, 32, 40
LOSS_RTOL, GNORM_RTOL, ATOL, LEAF_REL = 1e-6, 1e-6, 1e-5, 1e-5
ADAM_WELL_POSED = 1e-6
ROUTER_MARGIN = 1e-5
ADAFACTOR_RTOL = 1e-6
JAX_LOSS_RTOL, JAX_GNORM_RTOL, JAX_STEP_ATOL, JAX_ATOL = 1e-5, 1e-4, 1e-5, 1e-4
JAX_MESHES = ("2x2", "pod2x1x2")
PRESETS = ("base", "fsdp", "zero2")
WORLD_TIMEOUT = 400.0
OPT = dict(warmup_steps=0, total_steps=10)
# name -> (arch, overrides of its smoke config)
CONFIGS = {
    "llama3.2-1b": ("llama3.2-1b", {}),
    "qwen1.5-4b": ("qwen1.5-4b", dict(num_heads=3, num_kv_heads=3, head_dim=16)),
    "qwen3-8b": ("qwen3-8b", {}),
    "mistral-large-123b": ("mistral-large-123b", {}),
    "musicgen-large": ("musicgen-large", {}),
    "paligemma-3b": ("paligemma-3b", {}),
    "qwen3-gqa3": ("qwen3-8b", dict(num_heads=6, num_kv_heads=3, head_dim=16)),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}),
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", {}),
    "moe-3experts": ("granite-moe-3b-a800m", dict(num_experts=3)),
    "mamba2-130m": ("mamba2-130m", {}),
    "mamba2-3heads": ("mamba2-130m", dict(d_model=48)),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "rglru-3heads": ("recurrentgemma-9b", dict(num_heads=3, head_dim=16, lru_width=48)),
}
MOE_NAMES = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b", "moe-3experts")
ONE_ROW = ("mamba2-130m", "recurrentgemma-9b", "rglru-3heads")   # a decode step at batch 1 too
MESHES = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "pod2x1x2": (2, 1, 2)}
RECORD_CELLS = (ShapeCell("t", 32, 4, "train"), ShapeCell("p", 32, 4, "prefill"),
                ShapeCell("d", 32, 4, "decode"))
RECORD_ARCHS = {"llama3.2-1b": RECORD_CELLS, "granite-moe-3b-a800m": RECORD_CELLS,
                "kimi-k2-1t-a32b": RECORD_CELLS[:1],
                "mamba2-130m": RECORD_CELLS + (ShapeCell("d1", 32, 1, "decode"),),
                "recurrentgemma-9b": RECORD_CELLS + (ShapeCell("d1", 32, 1, "decode"),)}


def _cfg(name):
    arch, overrides = CONFIGS[name]
    return tlm.get_config(arch + "_smoke").replace(**overrides)


def _opt_cfg(cfg):
    """The config's own optimizer (kimi's momentum-free Adafactor) from lr
    5e-4 at step 0."""
    return OptimizerConfig(kind=cfg.opt_kind, b1=cfg.opt_b1, **OPT)


def _step_bound(ocfg):
    """The most one step moves a parameter element per unit lr, weight decay
    aside: AdamW's |m / sqrt(v)| is at most 1 at its first step, Adafactor's
    1-D |g| / sqrt((1 - b2) g^2) at most 1 / sqrt(1 - b2)."""
    return 1.0 if ocfg.kind == "adamw" else (1 - ocfg.b2) ** -0.5


def _lay(c, f, cat):
    """A prefill cache's leaf laid into the decode cache's: along the first
    dim where the two differ (the sequence), the decode cache's later slots
    kept; a leaf with no such dim (a state, a ring as long) as it is."""
    diff = [i for i, (a, b) in enumerate(zip(c.shape, f.shape)) if a != b]
    if not diff:
        return c
    d = diff[0]
    return cat([c, f[(slice(None),) * d + (slice(c.shape[d], None),)]], d)


def _batch(cfg, rng, n=B, s=S):
    if cfg.modality == "text":
        return {"tokens": rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)}
    if cfg.modality == "audio_stub":
        return {"embeds": rng.standard_normal((n, s, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)}
    p = cfg.num_prefix_tokens
    return {"image_embeds": rng.standard_normal((n, p, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (n, s - p)).astype(np.int32)}


def _token(cfg, rng):
    if cfg.modality == "audio_stub":
        return {"embeds": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)}
    return {"token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return tmesh.make_host_mesh(shape, axes)


def _bspecs(spmd, tree, mesh):
    return sanitized_specs({k: (spmd.batch_entry,) + (None,) * (v.ndim - 1)
                            for k, v in tree.items()}, tree, mesh)


def _rel(a, b) -> float:
    """max |a - b| over b's largest magnitude."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# -- one config's single-device references --------------------------------------------

def _reference(cfg, params, data):
    """The single-device train step, prefill and two serve steps, and the
    smallest router top-k margin over them with the count of routings under
    ``ROUTER_MARGIN`` (None for a model without a router)."""
    opt = make_optimizer(_opt_cfg(cfg))
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = _t(data["batch"])
    with MOE.routings() as routes:
        (_, _), grads = tlm.value_and_grad(params, batch, cfg)
        new, metrics = tlm.make_train_step(cfg, opt)(state, batch)
        logits, cache = tlm.make_prefill_step(cfg)(params, batch)
        full = T.cache_init(cfg, B, CACHE, device="cpu")
        full = bridge.rebuild(full, iter(_lay(c, f, lambda xs, d: torch.cat(xs, dim=d))
                                         for c, f in zip(bridge.leaves(cache),
                                                         bridge.leaves(full))))
        serve, steps = tlm.make_serve_step(cfg), []
        c = full
        for i, tok in enumerate(data["tokens"]):
            lg, c = serve(params, c, _t(tok), S + i)
            steps.append((lg, c))
    margin = None
    if routes:
        every = torch.cat([m for m, _ in routes])
        margin = (float(every.min()), int((every <= ROUTER_MARGIN).sum()))
    return {"grads": grads, "state": new, "metrics": metrics, "prefill": (logits, cache),
            "decode_cache": full, "steps": steps, "margin": margin}


def _moments(opt_state):
    return sorted(k for k in opt_state if k != "grad_norm")


def _leaf_gaps(got, want, grads, before, lr, wd, bound):
    """(largest moment gap over the leaf's max, largest well-posed parameter
    gap over the leaf's max, whether every other element moved within
    lr * (bound + wd * |p|) of the reference)."""
    moments = max(_rel(a, b) for key in _moments(want["opt_state"]) for a, b in
                  zip(bridge.leaves(got["opt_state"][key]), bridge.leaves(want["opt_state"][key])))
    posed_gap, noisy_ok = 0.0, True
    for a, b, g, p in zip(*(bridge.leaves(t) for t in (got["params"], want["params"], grads,
                                                       before))):
        err = (a - b).abs()
        posed = g.abs() * float(_clip_of(want)) > ADAM_WELL_POSED
        if posed.any():
            posed_gap = max(posed_gap, float(err[posed].max() / b.abs().max().clamp(min=1e-30)))
        noisy_ok &= bool((err[~posed] <= lr * (bound + wd * p[~posed].abs()) + 1e-7).all())
    return moments, posed_gap, noisy_ok


def _clip_of(state):
    return min(1.0, OptimizerConfig().clip_norm / float(state["opt_state"]["grad_norm"]))


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(bridge.leaves(a), bridge.leaves(b)))


def _spmd_case(name, cfg, params, data, ref, shape, jref=None, preset="base"):
    """Every sharded step of one config on one mesh under ``preset``, held
    against ``ref`` (and against ``jref``, the JAX package's steps, where
    given); ``local``: a digest of this rank's own results."""
    mesh = _mesh(shape)
    spmd = T.spmd_layout(cfg, mesh, preset=preset)
    ocfg = _opt_cfg(cfg)
    opt = make_optimizer(ocfg)
    batch = _t(data["batch"])
    lp = shard_tree(params, spmd.specs, mesh)
    lb = shard_tree(batch, _bspecs(spmd, batch, mesh), mesh)
    state = {"params": lp, "opt_state": spmd.opt_init(opt, lp),
             "step": torch.zeros((), dtype=torch.int32)}
    new, metrics = tlm.make_train_step(cfg, opt, mesh=mesh, preset=preset)(state, lb)
    local = [metrics["loss"], metrics["grad_norm"], *bridge.leaves(new["params"])]
    ospecs = D._opt_specs(cfg, new["opt_state"], spmd.opt_specs, params)
    moments = _moments(new["opt_state"])
    got = {"params": gather_tree(new["params"], spmd.specs, mesh),
           "opt_state": {k: gather_tree(new["opt_state"][k], ospecs[k], mesh) for k in moments}}
    got["opt_state"]["grad_norm"] = new["opt_state"]["grad_norm"]
    want = ref["state"]
    out = {"loss": (float(metrics["loss"]), float(ref["metrics"]["loss"])),
           "grad_norm": (float(metrics["grad_norm"]), float(ref["metrics"]["grad_norm"])),
           "train_equal": (_equal_trees(got["params"], want["params"])
                           and all(_equal_trees(got["opt_state"][k], want["opt_state"][k])
                                   for k in moments)
                           and torch.equal(metrics["loss"], ref["metrics"]["loss"])
                           and torch.equal(metrics["grad_norm"], ref["metrics"]["grad_norm"]))}
    out["leaves"] = _leaf_gaps(got, want, ref["grads"], params, ocfg.lr, ocfg.weight_decay,
                               _step_bound(ocfg))

    logits, cache = tlm.make_prefill_step(cfg, mesh=mesh, preset=preset)(lp, lb)
    local += [logits, *bridge.leaves(cache)]
    want_logits, want_cache = ref["prefill"]
    lspec = sanitized_specs((spmd.batch_entry, None, "model" if spmd.vocab_split else None),
                            want_logits, mesh)
    logits = gather_tree(logits, lspec, mesh)
    cache = gather_tree(cache, spmd.cache_specs(want_cache), mesh)
    gathered = [(logits, cache)]
    out["prefill"] = (float((logits - want_logits).abs().max()),
                      max(float((a - b).abs().max()) for a, b in
                          zip(bridge.leaves(cache), bridge.leaves(want_cache))),
                      torch.equal(logits, want_logits) and _equal_trees(cache, want_cache))

    full = ref["decode_cache"]
    cspecs = spmd.cache_specs(full)
    c = shard_tree(full, cspecs, mesh)
    serve, steps = tlm.make_serve_step(cfg, mesh=mesh, preset=preset), []
    for i, (tok, (want_lg, want_c)) in enumerate(zip(data["tokens"], ref["steps"])):
        tok = _t(tok)
        lg, c = serve(lp, c, shard_tree(tok, _bspecs(spmd, tok, mesh), mesh), S + i)
        local += [lg, *bridge.leaves(c)]
        lg, gc = gather_tree(lg, lspec, mesh), gather_tree(c, cspecs, mesh)
        gathered.append((lg, gc))
        steps.append((float((lg - want_lg).abs().max()),
                      max(float((a - b).abs().max()) for a, b in
                          zip(bridge.leaves(gc), bridge.leaves(want_c))),
                      torch.equal(lg, want_lg) and _equal_trees(gc, want_c)))
    out["serve"] = steps
    if name in ONE_ROW:
        out["one_row"] = _one_row(cfg, spmd, mesh, lp, ref, data, preset)
    if jref is not None:
        out["jax"] = _against_jax(jref, metrics, got["params"], gathered, ocfg)
    out["local"] = _digest(local)
    out["coords"] = {a: mesh.axis(a).rank for a in mesh.axis_names}
    return out


def _digest(tensors) -> str:
    """sha256 of the tensors' shapes, dtypes and bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(repr((tuple(t.shape), t.dtype)).encode())
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _one_row(cfg, spmd, mesh, lp, ref, data, preset):
    """The first serve step at batch 1 (a batch the data axis does not
    divide: every data rank decodes the same row, as ``long_500k`` does):
    its gathered logits' and cache's largest gaps to row 0 of the batch-4
    single-device step."""
    row = lambda tree: bridge.rebuild(tree, iter(x[:1] if x.ndim > 1 else x
                                                 for x in bridge.leaves(tree)))
    full, (want_lg, want_c) = ref["decode_cache"], ref["steps"][0]
    if T._uniform(cfg):     # a stacked cache: its batch is dim 1
        row = lambda tree: bridge.rebuild(tree, iter(x[:, :1] for x in bridge.leaves(tree)))
    one, tok = row(full), _t({k: v[:1] for k, v in data["tokens"][0].items()})
    cspecs = spmd.cache_specs(one)
    lg, c = tlm.make_serve_step(cfg, mesh=mesh, preset=preset)(lp, shard_tree(one, cspecs, mesh),
                                                shard_tree(tok, _bspecs(spmd, tok, mesh), mesh), S)
    lspec = sanitized_specs((spmd.batch_entry, None, "model" if spmd.vocab_split else None),
                            want_lg[:1], mesh)
    lg, c = gather_tree(lg, lspec, mesh), gather_tree(c, cspecs, mesh)
    return (float((lg - want_lg[:1]).abs().max()),
            max(float((a - b).abs().max()) for a, b in zip(bridge.leaves(c),
                                                           bridge.leaves(row(want_c)))))


def _against_jax(jref, metrics, params, gathered, ocfg):
    """One mesh's gathered results against the JAX package's single-device
    steps: the loss's and ``grad_norm``'s relative gaps, the largest
    well-posed parameter gap, whether every other parameter element moved
    within lr * (bound + wd * |p|) + JAX_STEP_ATOL of JAX's (``_step_bound``),
    and the largest logits and cache gaps over the prefill and the serve
    steps."""
    named = lambda tree: _named(bridge.to_torch(tree, "cpu", None))
    want, grads, before = named(jref["new"]), named(jref["grads"]), named(jref["params"])
    got = _named(params)
    assert got.keys() == want.keys()
    clip = min(1.0, ocfg.clip_norm / jref["grad_norm"])
    lr, wd, bound = ocfg.lr, ocfg.weight_decay, _step_bound(ocfg)
    posed_gap, noisy_ok = 0.0, True
    for k, w in want.items():
        err = (got[k] - w).abs()
        posed = grads[k].abs() * clip > ADAM_WELL_POSED
        if posed.any():
            posed_gap = max(posed_gap, float(err[posed].max()))
        noisy_ok &= bool((err[~posed] <= lr * (bound + wd * before[k][~posed].abs())
                          + JAX_STEP_ATOL).all())
    logits_gap = cache_gap = 0.0
    for (lg, c), (want_lg, want_c) in zip(gathered, [jref["prefill"], *jref["steps"]]):
        logits_gap = max(logits_gap, float((lg - torch.from_numpy(want_lg)).abs().max()))
        wc = named(want_c)
        cache_gap = max(cache_gap, max(float((v - wc[k]).abs().max())
                                       for k, v in _named(c).items()))
    return {"loss": abs(float(metrics["loss"]) - jref["loss"]) / abs(jref["loss"]),
            "grad_norm": abs(float(metrics["grad_norm"]) - jref["grad_norm"]) / jref["grad_norm"],
            "posed": posed_gap, "noisy_ok": noisy_ok, "logits": logits_gap, "cache": cache_gap}


def _record_case():
    """This rank's collective operand bytes of each ``RECORD_ARCHS`` smoke
    config's steps at 2x2 in this world under each preset (every rank
    returns its own)."""
    mesh = _mesh((2, 2))
    out = {}
    for preset in PRESETS:
        for arch, cells in RECORD_ARCHS.items():
            for cell in cells:
                c = D.build_cell(arch + "_smoke", cell, mesh=mesh, device="cpu", preset=preset)
                rec = D.StepRecorder()
                with rec:
                    c.call()
                out[_key(arch, cell.name, preset)] = rec.collectives
    return out


def _adafactor_case():
    """Two factored Adafactor updates (kimi's settings, the clip active) of
    leaves cut over ``data``, ``model`` and both on this rank's blocks, on
    the 2x2 mesh, and on one device: the largest gaps of the gathered
    ``row``/``col`` state and parameters over each leaf's largest magnitude,
    and the clip's norms on both."""
    mesh = _mesh((2, 2))
    gen = torch.Generator().manual_seed(3)
    shapes = {"data": ((8, 6), ("data",)), "model": ((8, 6), (None, "model")),
              "both": ((8, 6), ("data", "model")), "stacked": ((3, 8, 6), (None, "model", "data")),
              "vector": ((6,), ("model",))}
    params = {k: torch.randn(sh, generator=gen) for k, (sh, _) in shapes.items()}
    grads = [{k: 3.0 * torch.randn(sh, generator=gen) for k, (sh, _) in shapes.items()}
             for _ in range(2)]
    specs = sanitized_specs({k: sp for k, (_, sp) in shapes.items()}, params, mesh)
    opt = make_optimizer(OptimizerConfig(kind="adafactor", b1=0.0, **OPT))
    axes = dim_axes(specs, mesh)
    one, shard = (params, opt.init(params)), None
    lp = shard_tree(params, specs, mesh)
    shard = (lp, opt.init(lp))
    norms = []
    for step, g in enumerate(grads):
        one = opt.update(g, one[1], one[0], step=step)
        shard = opt.update(shard_tree(g, specs, mesh), shard[1], shard[0], step=step,
                           shard_axes=axes)
        norms.append((float(one[1]["grad_norm"]), float(shard[1]["grad_norm"]),
                      float(global_norm(g))))
    full = {k: sp + (None,) * (len(shapes[k][0]) - len(sp)) for k, sp in specs.items()}
    vspecs = {k: {"row": sp[:-1], "col": sp[:-2] + sp[-1:]} if len(sp) > 1 else {"full": sp}
              for k, sp in full.items()}
    got_p, got_v = gather_tree(shard[0], specs, mesh), gather_tree(shard[1]["v"], vspecs, mesh)
    gaps = {k: max(_rel(got_p[k], one[0][k]),
                   *(_rel(got_v[k][n], one[1]["v"][k][n]) for n in one[1]["v"][k]))
            for k in shapes}
    return {"gaps": gaps, "norms": norms}


def _named(tree):
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    return dict(flatten_with_names(tree))


def _run(out, key, fn):
    try:
        out[key] = fn()
    except Exception:
        out[key] = ("error", traceback.format_exc())


def _key(name, mesh_id, preset):
    """A case's key in a rank's results (a ``base`` case's without its
    preset)."""
    return (name, mesh_id) if preset == "base" else (name, mesh_id, preset)


def _world(rank, datas, jax_refs):
    out = {}
    for name in CONFIGS:
        cfg, jref = _cfg(name), jax_refs[name]
        params = bridge.to_torch(jref["params"], "cpu", None)
        ref = _reference(cfg, params, datas[name])
        out[name, "margin"] = ref["margin"]
        for mesh_id, shape in MESHES.items():
            for preset in PRESETS:
                _run(out, _key(name, mesh_id, preset),
                     lambda: _spmd_case(name, cfg, params, datas[name], ref, shape,
                                        jref if mesh_id in JAX_MESHES else None, preset))
    _run(out, ("record",), _record_case)
    _run(out, ("adafactor",), _adafactor_case)
    return out


# -- the world and the JAX reference ---------------------------------------------------

def _datas():
    out = {}
    for i, name in enumerate(CONFIGS):
        cfg, rng = _cfg(name), np.random.default_rng(10 + i)
        out[name] = {"batch": _batch(cfg, rng), "tokens": [_token(cfg, rng) for _ in range(2)]}
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """Each config's JAX weights and the JAX package's single-device steps on
    its data: one AdamW step (loss, ``grad_norm``, the gradients, the new
    parameters), the prefill (last logits, cache) and two serve steps from
    the prefill's cache laid into CACHE slots, all as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.models import transformer as JT
    from repro.optim.optimizer import OptimizerConfig as JOptConfig
    from repro.optim.optimizer import make_optimizer as j_make_optimizer

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    on_jax = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    out = {}
    for name, data in _datas().items():
        arch, overrides = CONFIGS[name]
        cfg = jlm.get_config(arch + "_smoke").replace(**overrides)
        params = JT.init_lm(jax.random.PRNGKey(0), cfg)
        opt = j_make_optimizer(JOptConfig(kind=cfg.opt_kind, b1=cfg.opt_b1, **OPT))
        state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
        grad_fn = jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, cfg), has_aux=True)
        train = jax.jit(lambda st, b: (jlm.make_train_step(cfg, opt)(st, b),
                                       grad_fn(st["params"], b)[1]))
        batch = on_jax(data["batch"])
        (new, metrics), grads = train(state, batch)
        logits, cache = jax.jit(jlm.make_prefill_step(cfg))(params, batch)
        prefill = to_np((logits, cache))
        cache = jax.tree_util.tree_map(
            lambda c, f: _lay(c, f, lambda xs, d: jnp.concatenate(xs, axis=d)), cache,
            JT.cache_init(cfg, B, CACHE))
        serve, steps = jax.jit(jlm.make_serve_step(cfg)), []
        for i, tok in enumerate(data["tokens"]):
            lg, cache = serve(params, cache, on_jax(tok), jnp.asarray(S + i, jnp.int32))
            steps.append(to_np((lg, cache)))
        out[name] = {"params": to_np(params), "new": to_np(new["params"]), "grads": to_np(grads),
                     "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "prefill": prefill, "steps": steps}
    return out


_CACHE: dict = {}


@pytest.fixture(scope="module")
def world(jax_ref):
    if "world" not in _CACHE:
        _CACHE["world"] = tmesh.spawn_world(_world, 4, (_datas(), jax_ref),
                                            timeout=WORLD_TIMEOUT)
    return _CACHE["world"]


def _case(world, key):
    values = [r.get(key, ("error", f"case {key} did not run")) for r in world]
    for v in values:
        if isinstance(v, tuple) and v and v[0] == "error":
            pytest.fail(f"case {key} raised on a rank:\n{v[1]}")
    return values


def _params(names, meshes):
    """(name, mesh_id, preset) cases; a ``base`` case keeps the id it had
    before the presets ran (``name-mesh``)."""
    return [pytest.param(n, m, p, id=f"{n}-{m}" + ("" if p == "base" else f"-{p}"))
            for n in names for m in meshes for p in PRESETS]


CASES = _params(CONFIGS, MESHES)


@pytest.mark.parametrize("name,mesh_id,preset", CASES)
def test_train_step(world, name, mesh_id, preset):
    for r in _case(world, _key(name, mesh_id, preset)):
        if mesh_id == "1x1":
            assert r["train_equal"], (name, preset, r)
            continue
        (loss, want), (gn, want_gn) = r["loss"], r["grad_norm"]
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (name, mesh_id, preset, loss, want)
        assert abs(gn - want_gn) <= GNORM_RTOL * abs(want_gn), (name, mesh_id, preset, gn,
                                                                 want_gn)
        moments, posed, noisy_ok = r["leaves"]
        assert moments <= LEAF_REL and posed <= LEAF_REL and noisy_ok, (name, mesh_id, preset,
                                                                         r["leaves"])


@pytest.mark.parametrize("name,mesh_id,preset", CASES)
def test_prefill_and_serve_steps(world, name, mesh_id, preset):
    for r in _case(world, _key(name, mesh_id, preset)):
        for logits_gap, cache_gap, equal in [r["prefill"], *r["serve"]]:
            if mesh_id == "1x1":
                assert equal, (name, preset, r)
            else:
                assert logits_gap <= ATOL and cache_gap <= ATOL, (name, mesh_id, preset, r)


def test_ranks_agree(world):
    """Every rank of a mesh gets the same loss, grad_norm and gathered gaps."""
    for case in CASES:
        values = _case(world, _key(*case.values))
        assert all(v["loss"] == values[0]["loss"] and v["grad_norm"] == values[0]["grad_norm"]
                   for v in values), case.values


@pytest.mark.parametrize("name", CONFIGS)
def test_zero2_model_ranks_equal_on_multi_pod(world, name):
    """Under ``zero2`` on the multi-pod mesh the batch is cut over ``(pod,
    data)`` only (the reference's multi-pod override), so the two ``model``
    ranks of a pod compute the same rows: their own results (loss,
    grad_norm, the new parameters, the prefill's and the serve steps'
    logits and caches) are ``torch.equal`` (equal digests of their bytes)."""
    by_pod: dict = {}
    for r in _case(world, _key(name, "pod2x1x2", "zero2")):
        by_pod.setdefault((r["coords"]["pod"], r["coords"]["data"]), {})[
            r["coords"]["model"]] = r["local"]
    assert len(by_pod) == 2
    for pod, digests in by_pod.items():
        assert sorted(digests) == [0, 1] and len(set(digests.values())) == 1, (name, pod)


JAX_CASES = _params(CONFIGS, JAX_MESHES)


@pytest.mark.parametrize("name,mesh_id,preset", JAX_CASES)
def test_train_step_against_jax(world, name, mesh_id, preset):
    """The sharded train step from the JAX package's weights against the JAX
    package's own single-device step."""
    for r in _case(world, _key(name, mesh_id, preset)):
        j = r["jax"]
        assert j["loss"] <= JAX_LOSS_RTOL and j["grad_norm"] <= JAX_GNORM_RTOL, (
            name, mesh_id, preset, j)
        assert j["posed"] <= JAX_STEP_ATOL and j["noisy_ok"], (name, mesh_id, preset, j)


@pytest.mark.parametrize("name,mesh_id,preset", JAX_CASES)
def test_prefill_and_serve_steps_against_jax(world, name, mesh_id, preset):
    """The sharded prefill and two serve steps, gathered, against the JAX
    package's single-device ones on the same weights and inputs."""
    for r in _case(world, _key(name, mesh_id, preset)):
        j = r["jax"]
        assert j["logits"] <= JAX_ATOL and j["cache"] <= JAX_ATOL, (name, mesh_id, preset, j)


def _record_only(preset):
    """Rank 0's collective operand bytes of each ``RECORD_ARCHS`` cell on a
    record-only 2x2 mesh on meta under ``preset``."""
    want = {}
    for arch, cells in RECORD_ARCHS.items():
        for cell in cells:
            c = D.build_cell(arch + "_smoke", cell, mesh=tmesh.record_only_mesh((2, 2)),
                             preset=preset)
            rec = D.StepRecorder()
            with rec:
                c.call()
            want[_key(arch, cell.name, preset)] = rec.collectives
    return want


def test_recorded_bytes_equal_record_only_mesh(world):
    """Each rank's collective operand bytes, kind by kind, equal rank 0's of
    a record-only 2x2 mesh on meta, for the train, prefill and decode steps
    of a dense, an expert-parallel MoE (its all-to-all), kimi's Adafactor
    train step, Mamba-2 and recurrentgemma (and their decode at batch 1),
    under each preset."""
    want = {k: v for preset in PRESETS for k, v in _record_only(preset).items()}
    assert set(want["llama3.2-1b", "t"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert "all-to-all" in want["llama3.2-1b", "p"]
    for arch in ("granite-moe-3b-a800m", "kimi-k2-1t-a32b"):   # 8 experts on data = 2
        assert want[arch, "t"]["all-to-all"] > 0, want[arch, "t"]
    for got in _case(world, ("record",)):
        assert got == want


class _Collectives(TorchDispatchMode):
    """Every collective entry a step reports (``launch.mesh``'s report),
    each operation passed straight through."""

    def __init__(self):
        super().__init__()
        self.entries: list = []

    def record_collective(self, entry: dict) -> None:
        self.entries.append(entry)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _summed_shapes(cfg, mesh, preset):
    """The shapes an all-reduce may carry under a preset without tensor
    parallelism: a scalar (the loss's sums, the clip's norm), the MoE's
    per-expert statistics (E,), the gradient block of a leaf the optimizer
    state leaves whole over a batch axis (summed over it) and, under
    Adafactor, the factored sums of a cut leaf's block (its row and column
    sums and their normaliser's)."""
    spmd = T.spmd_layout(cfg, mesh, preset=preset)
    batch = {a.name for a in spmd.batch if a.size > 1}
    blocks = shard_tree(T.init_lm(0, cfg, device="meta"), spmd.opt_specs, mesh)
    shapes = {(), (cfg.num_experts,)}
    map_leaves(lambda b, sp: batch <= {a for e in sp for a in entry_axes(e)}
               or shapes.add(tuple(b.shape)), blocks, spmd.opt_specs)
    if cfg.opt_kind == "adafactor":
        for blk in bridge.leaves(blocks):
            if blk.ndim >= 2:
                b = tuple(blk.shape)
                shapes |= {b[:-1], b[:-2] + b[-1:], b[:-2]}
    return shapes


@pytest.mark.parametrize("preset", ["fsdp", "zero2"])
@pytest.mark.parametrize("arch", RECORD_ARCHS)
def test_preset_collective_structure(arch, preset):
    """Rank 0 of a record-only 2x2 mesh under ``fsdp`` and ``zero2``: no
    step moves an all-to-all (no expert parallelism, the cache's sequence
    whole); every all-reduce carries a scalar, the MoE's per-expert
    statistics, the gradient of a leaf the optimizer state does not cut or,
    under Adafactor, a cut leaf's factored sums (no tensor-parallel psum
    remains); ``zero2``'s prefill and decode steps move no all-gather or
    reduce-scatter either (no weight is gathered)."""
    mesh = tmesh.record_only_mesh((2, 2))
    cfg = tlm.get_config(arch + "_smoke")
    allowed = _summed_shapes(cfg, mesh, preset)
    for cell in RECORD_ARCHS[arch]:
        rec = _Collectives()
        c = D.build_cell(arch + "_smoke", cell, mesh=mesh, preset=preset)
        with rec:
            c.call()
        hlos = {e["hlo"] for e in rec.entries}
        assert "all-to-all" not in hlos, (arch, cell.name, preset, hlos)
        if preset == "zero2" and cell.kind != "train":
            assert hlos <= {"all-reduce"}, (arch, cell.name, hlos)
        summed = {e["shape"] for e in rec.entries if e["hlo"] == "all-reduce"}
        assert summed <= allowed, (arch, cell.name, preset, summed - allowed)


@pytest.mark.parametrize("mesh_id", JAX_MESHES)
def test_sp_preset_fails_as_reference(mesh_id):
    """The ``sp`` preset maps ``seq`` and ``vocab`` both to ``model``: JAX
    refuses the logits' spec ``("batch", "seq", "vocab")`` with
    ``DuplicateSpecError`` (on an ``AbstractMesh``, no devices needed), so
    the JAX package's steps fail under it in every layer kind; the port's
    three step builders raise ``ValueError`` naming the ``model`` axis."""
    from jax.sharding import AbstractMesh
    from jax.sharding import NamedSharding as JNamedSharding

    from repro.distributed.sharding import make_rules as j_make_rules
    from repro.distributed.sharding import spec as j_spec

    shape = MESHES[mesh_id]
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    rules = j_make_rules(multi_pod=len(shape) == 3, preset="sp")
    with pytest.raises(Exception, match="duplicate entries for `model`") as err:
        JNamedSharding(AbstractMesh(shape, axes), j_spec("batch", "seq", "vocab", rules=rules))
    assert type(err.value).__name__ == "DuplicateSpecError"
    cfg = _cfg("llama3.2-1b")
    mesh = tmesh.record_only_mesh(shape, axes)
    for make in (lambda: tlm.make_prefill_step(cfg, mesh=mesh, preset="sp"),
                 lambda: tlm.make_serve_step(cfg, mesh=mesh, preset="sp"),
                 lambda: tlm.make_train_step(cfg, make_optimizer(OptimizerConfig()), mesh=mesh,
                                             preset="sp")):
        with pytest.raises(ValueError, match="duplicate entries for `model`"):
            make()


@pytest.mark.parametrize("name", MOE_NAMES)
def test_router_margin(world, name):
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over the single-device steps exceeds ``ROUTER_MARGIN``, so
    the mesh's rounding moves no routing decision and the MoE steps above
    are held in full (the margin and the count under it, 0, are reported)."""
    for margin, under in _case(world, (name, "margin")):
        assert margin > ROUTER_MARGIN and under == 0, (name, margin, under)


@pytest.mark.parametrize("name,mesh_id,preset", _params(ONE_ROW, JAX_MESHES))
def test_serve_step_at_one_row(world, name, mesh_id, preset):
    """A decode step at batch 1, which the batch axes do not divide (every
    rank decodes the same row, as ``long_500k``'s records do), gives row 0
    of the batch-4 single-device step."""
    for r in _case(world, _key(name, mesh_id, preset)):
        logits_gap, cache_gap = r["one_row"]
        assert logits_gap <= ATOL and cache_gap <= ATOL, (name, mesh_id, preset, r["one_row"])


@pytest.mark.parametrize("leaf", ["data", "model", "both", "stacked", "vector"])
def test_sharded_adafactor(world, leaf):
    """Two factored Adafactor updates (kimi's settings) of leaves cut over
    ``data``, ``model``, both, a stacked leaf and a vector: the gathered
    ``row``/``col`` state and parameters within ``ADAFACTOR_RTOL`` of the
    single-device update, relative to each leaf's largest magnitude, and the
    clip's norm that of ``global_norm``."""
    for r in _case(world, ("adafactor",)):
        assert r["gaps"][leaf] <= ADAFACTOR_RTOL, (leaf, r["gaps"])
        for one, shard, whole in r["norms"]:
            assert abs(shard - whole) <= ADAFACTOR_RTOL * whole and one == pytest.approx(whole)


def test_shard_and_gather_round_trip():
    """``shard_tree`` on a record-only mesh cuts rank 0's block; a dim the
    axis does not divide stays whole (sanitized), as in the reference."""
    mesh = tmesh.record_only_mesh((2, 2))
    tree = {"a": torch.arange(24.0).reshape(4, 6), "b": torch.arange(5.0)}
    specs = sanitized_specs({"a": ("data", "model"), "b": ("model",)}, tree, mesh)
    assert specs == {"a": ("data", "model"), "b": ()}
    local = shard_tree(tree, specs, mesh)
    assert torch.equal(local["a"], tree["a"][:2, :3]) and local["b"] is tree["b"]
    one = tmesh.make_host_mesh((1, 1))
    assert gather_tree(tree, specs, one)["a"] is tree["a"]
