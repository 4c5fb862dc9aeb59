"""LM entry points, the port of the JAX package's ``models/lm.py``: the config
registry, the loss, the train/prefill/serve steps and the input specs.

Each step is a function of (params/state, batch) as in the JAX package,
which jits them; here they run eagerly.  With ``mesh=`` (a
``launch.mesh.HostMesh``) a step builder returns the SPMD step
(``transformer.spmd_layout``, under the ``preset`` rules: ``base``,
``fsdp`` or ``zero2``; ``sp`` raises as the reference's steps do): every rank
calls it alike on its shards (``distributed.sharding.shard_tree`` of the
global trees under ``Spmd.specs`` / ``Spmd.cache_specs`` and the batch cut
over ``Spmd.batch_entry``) and gets its shards back -- what the JAX package's
step computes when ``jit`` partitions it over a mesh.  ``make_train_step`` takes the
port's ``optim.make_optimizer`` pair and returns a new state (nothing is
updated in place); the prefill and serve steps run without autograd.  The
input specs (``batch_struct``, ``cache_struct``) are tensors on the ``meta``
device where the JAX package has ``jax.ShapeDtypeStruct``; ``batch_pspecs``
gives ``PartitionSpec`` entries as tuples (``distributed.sharding.spec``'s
form).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.bridge import leaves, rebuild
from repro_torch.distributed.sharding import _entry
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig, ShapeCell

_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _shift_labels(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token labels and an f32 mask (the last position masked out; its
    label wraps to the first token, as the JAX package's does)."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]), torch.zeros_like(tokens[:, :1])], dim=1)
    return labels, mask.to(torch.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, *,
                  vocab=None, batch_axes=()) -> torch.Tensor:
    """Stable masked cross-entropy: ``logsumexp`` over f32 logits, the
    masked sum divided by ``max(mask.sum(), 1)``.

    Sharded: ``vocab`` (a ``MeshAxis``) holds the logits cut over the
    vocabulary, rank i the i-th block: the row max meets over it in a max,
    the sum of exponentials and the gold logit in psums.  ``batch_axes``:
    the axes the rows are cut over; the masked sum and the mask's count are
    summed over them, so the mean is the global batch's."""
    logits = logits.float()
    if vocab is None or vocab.size == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        top = vocab.all_reduce(logits.detach().amax(dim=-1), op="max")
        logz = top + torch.log(vocab.all_reduce(torch.exp(logits - top[..., None]).sum(dim=-1)))
        n = logits.shape[-1]
        local = labels.long() - vocab.rank * n
        inside = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = vocab.all_reduce(torch.where(inside, gold, torch.zeros_like(gold)))
    nll = (logz - gold) * mask
    total, count = nll.sum(), mask.sum()
    for ax in batch_axes:
        total, count = ax.all_reduce(total), ax.all_reduce(count)
    return total / torch.clamp(count, min=1.0)


def loss_fn(params, batch, cfg: ArchConfig, *, spmd=None):
    """Returns (loss, metrics dict). Handles all modalities.  Under ``spmd``
    (``transformer.Spmd``): on this rank's shards, the loss of the global
    batch on every rank."""
    logits, aux, _ = T.forward(params, batch, cfg, spmd=spmd)
    if cfg.modality == "text":
        labels, mask = _shift_labels(batch["tokens"])
    elif cfg.modality == "audio_stub":
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    elif cfg.modality == "vision_stub":
        # loss on the text region only (the image prefix has no labels)
        prefix = batch["image_embeds"].shape[1]
        labels_txt, mask_txt = _shift_labels(batch["tokens"])
        pad = torch.zeros((labels_txt.shape[0], prefix), dtype=labels_txt.dtype,
                          device=labels_txt.device)
        labels = torch.cat([pad, labels_txt], dim=1)
        mask = torch.cat([pad.to(torch.float32), mask_txt], dim=1)
    else:
        raise ValueError(cfg.modality)
    if spmd is None:
        ce = cross_entropy(logits, labels, mask)
    else:
        ce = cross_entropy(logits, labels, mask, batch_axes=spmd.batch,
                           vocab=spmd.model if spmd.vocab_split else None)
    loss = ce + cfg.router_aux_loss * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def value_and_grad(params, batch, cfg: ArchConfig, *, spmd=None):
    """((loss, metrics), grads): :func:`loss_fn` and its gradient tree, of
    ``params``' structure (the JAX package's ``jax.value_and_grad(...,
    has_aux=True)``).  ``params`` are not modified.  Under ``spmd`` the
    gradient of each shard of the global batch's loss (``Spmd.reduce_grads``:
    under replicated parameters, of each block the optimizer state is cut
    to)."""
    live = rebuild(params, iter(p.detach().requires_grad_(True) for p in leaves(params)))
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch, cfg, spmd=spmd)
        grads = torch.autograd.grad(loss, leaves(live))
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = rebuild(params, iter(grads))
    if spmd is not None:
        with torch.no_grad():
            grads = spmd.reduce_grads(grads)
    return (loss.detach(), metrics), grads


def _spmd(cfg, mesh, preset):
    return None if mesh is None else T.spmd_layout(cfg, mesh, preset=preset)


def make_train_step(cfg: ArchConfig, optimizer, *, mesh=None, preset: str = "base"):
    """train_step(state, batch) -> (state', metrics). ``optimizer`` from
    ``repro_torch.optim.optimizer.make_optimizer`` (an init/update pair).

    With ``mesh``: the SPMD step on this rank's shards of the state (the
    optimizer state sharded as ``param_pspecs`` cut the parameters,
    Adafactor's factored ``row`` and ``col`` moments as their parameter's
    rows and columns) and of the batch; the update runs on the shard, its
    global-norm clip summing each leaf's squares over the axes that leaf is
    sharded over (``Spmd.shard_axes``).  Under ``zero2`` the parameters are
    whole on every rank and the update runs on the optimizer state's blocks
    of them (``Spmd.update``)."""
    spmd = _spmd(cfg, mesh, preset)

    def train_step(state, batch):
        (_, metrics), grads = value_and_grad(state["params"], batch, cfg, spmd=spmd)
        with torch.no_grad():
            if spmd is None:
                new_params, new_opt = optimizer.update(
                    grads, state["opt_state"], state["params"], step=state["step"])
            else:
                new_params, new_opt = spmd.update(optimizer, grads, state["opt_state"],
                                                  state["params"], state["step"])
        metrics["grad_norm"] = optimizer.last_grad_norm(new_opt)
        return ({"params": new_params, "opt_state": new_opt, "step": state["step"] + 1},
                metrics)

    return train_step


def make_prefill_step(cfg: ArchConfig, *, mesh=None, preset: str = "base"):
    """prefill_step(params, batch) -> (last logits, cache).  With ``mesh``:
    on this rank's shards under the ``preset`` rules; the logits cut over
    the vocabulary where ``Spmd.vocab_split`` says so, the cache this rank's
    block of ``Spmd.cache_specs``.  ``preset="sp"`` raises ``ValueError``
    (``transformer.spmd_layout``)."""
    spmd = _spmd(cfg, mesh, preset)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _, cache = T.forward(params, batch, cfg, collect_cache=True, spmd=spmd)
        return logits[:, -1:, :], cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, mesh=None, preset: str = "base"):
    """serve_step(params, cache, batch, pos) -> (logits, cache').  With
    ``mesh``: as :func:`make_prefill_step`, against this rank's block of the
    cache (``Spmd.cache_specs``)."""
    spmd = _spmd(cfg, mesh, preset)

    @torch.no_grad()
    def serve_step(params, cache, batch, pos):
        return T.decode(params, cache, batch, pos, cfg, spmd=spmd)

    return serve_step


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no memory)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, cell: ShapeCell) -> dict[str, torch.Tensor]:
    """Model inputs for one shape cell (training/prefill batch or decode
    token), as ``meta`` tensors."""
    b, s = cell.global_batch, cell.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cell.kind == "decode":
        if cfg.modality == "audio_stub":
            return {"embeds": _meta((b, 1, cfg.d_model), bf16)}
        return {"token": _meta((b, 1), i32)}
    if cfg.modality == "text":
        return {"tokens": _meta((b, s), i32)}
    if cfg.modality == "audio_stub":
        out = {"embeds": _meta((b, s, cfg.d_model), bf16)}
        if cell.kind == "train":
            out["labels"] = _meta((b, s), i32)
        return out
    if cfg.modality == "vision_stub":
        p = cfg.num_prefix_tokens
        return {"image_embeds": _meta((b, p, cfg.d_model), bf16),
                "tokens": _meta((b, s - p), i32)}
    raise ValueError(cfg.modality)


def batch_pspecs(cfg: ArchConfig, cell: ShapeCell, *, batch_axes) -> dict[str, tuple]:
    """Spec entries matching :func:`batch_struct`: the batch dim over the DP
    axes (a 1-tuple of axis names as its bare name, as ``PartitionSpec``
    holds it)."""
    struct = batch_struct(cfg, cell)
    return {k: (_entry(batch_axes),) + (None,) * (v.ndim - 1) for k, v in struct.items()}


def cache_struct(cfg: ArchConfig, cell: ShapeCell):
    """The decode cache at this cell, as ``meta`` tensors."""
    return T.cache_init(cfg, cell.global_batch, cell.seq_len, device="meta")
