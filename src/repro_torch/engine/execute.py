"""Deploy-plan executor: folded weights in, logits out.

Walks the same layer list (``engine.layout``) as the eval graph, in the
accelerator's deploy view:

* each stage/unit is ONE folded weight read (Conv/Linear with the BN baked
  in) -- no separate BN pass over the activations;
* every AND-NOT residual executes inside the LIF dispatch's epilogue
  (``iand_skip``), so spikes are written once -- no standalone IAND pass;
* all Conv/Linear compute is tick-batched (T folded into the batch: one
  weight read serves all time steps).

All compute -- linears, convs and attention -- goes through
``repro_torch.engine.backend``; the executor never calls a kernel or a plain
version directly, so the plan's backend decides the compute route.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import nn as cnn
from repro_torch.core.iand import connective
from repro_torch.core.spiking_attention import merge_heads, split_heads
from repro_torch.engine import backend as B
from repro_torch.engine.plan import DeployPlan, PlanMeta


def _lif(meta: PlanMeta, drive, iand_skip=None):
    cfg = meta.cfg
    return B.lif_apply(meta.backend, drive, theta=cfg.theta, lam=cfg.lam,
                       schedule=cfg.lif_schedule, chain_len=cfg.chain_len,
                       iand_skip=iand_skip)


def _tokenizer_exec(meta: PlanMeta, tok_params, image):
    """image: (B, H, W, C) analog in [0, 1] -> spikes (T, B, N, D)."""
    cfg = meta.cfg
    x = None
    for stage, p in zip(meta.tok_stages, tok_params):
        if stage.encode:
            # encoding layer: analog conv once, broadcast across T (the input
            # is not binary, so it stays on the plain conv on every backend)
            y = cnn.conv_apply(p, image)
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


def _block_exec(meta: PlanMeta, bparams, x):
    """One block in deploy form. x: (T, B, N, D) spikes."""
    cfg = meta.cfg
    res = connective(cfg.residual)   # only reached for residual="add"
    acts: dict = {}
    h = None
    for u in meta.block_units:
        if u.role == "qkv":
            acts[u.name] = _lif(meta, _unit_linear(meta, bparams[u.name], x))
            continue
        if u.role == "attn_out":
            attn = B.ssa_apply(
                meta.backend, *(split_heads(acts[n], cfg.num_heads) for n in "qkv"),
                scale=cfg.attn_scale, ordering=cfg.attn_ordering)
            attn = _lif(meta, merge_heads(attn))          # attn spikes
            drive = _unit_linear(meta, bparams[u.name], attn)
        elif u.role == "mlp_hidden":
            h = _lif(meta, _unit_linear(meta, bparams[u.name], x))
            continue
        elif u.role == "mlp_out":
            drive = _unit_linear(meta, bparams[u.name], h)
        else:
            raise ValueError(f"unknown unit role: {u.role}")
        if u.fuse_residual:      # AND-NOT inside the LIF epilogue
            x = _lif(meta, drive, iand_skip=x)
        else:
            x = res(x, _lif(meta, drive))
    return x


def _execute(meta: PlanMeta, params, batch):
    x = _tokenizer_exec(meta, params["tokenizer"], batch)
    for bparams in params["blocks"]:
        x = _block_exec(meta, bparams, x)
    feats = x.mean(dim=(0, 2))              # rate decoding over (T, tokens)
    return cnn.linear_apply(params["head"], feats)


def make_apply_fn(plan: DeployPlan):
    """``fn(params, images) -> logits`` with the plan's static metadata closed
    over.  ``images``: (B, H, W, C) float32 on the plan's device."""
    return functools.partial(_execute, plan.meta)


def apply(plan: DeployPlan, batch) -> torch.Tensor:
    """One-shot convenience: run the plan on an image batch (a tensor or a
    numpy array; moved to the plan's device)."""
    images = torch.as_tensor(batch, dtype=torch.float32, device=plan.meta.device)
    with torch.inference_mode():
        return make_apply_fn(plan)(plan.params, images)
