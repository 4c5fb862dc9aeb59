"""Spikformer and Spike-IAND-Former (the paper's model, Fig. 2).

Spiking Tokenizer -> L x {SSA block, MLP block} -> classification head.  The
paper's variant replaces both residual additions per block with element-wise
IAND, so every inter-layer tensor is binary.  Both ``init`` and
``block_apply`` iterate :func:`repro_torch.engine.layout.block_layout`, the
layer list the deploy engine folds and fuses.  This module is the
training/eval view: live BatchNorm (batch statistics under ``train=True``,
running statistics otherwise) and surrogate gradients, differentiable by
autograd on both the plain and the kernel route; it is also the oracle the
deploy engine is held against.  Linear+BN compute is tick-batched: T folds
into the batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import nn as cnn
from repro_torch.core import tokenizer as tok
from repro_torch.core.iand import connective
from repro_torch.core.lif import lif
from repro_torch.core.spiking_attention import merge_heads, split_heads, ssa
from repro_torch.engine.layout import block_layout


@dataclass(frozen=True)
class SpikformerConfig:
    """Paper notation A-B = num_layers-embed_dim (e.g. 8-384)."""

    img_size: int = 32
    in_channels: int = 3
    num_classes: int = 10
    embed_dim: int = 384
    num_layers: int = 8
    num_heads: int = 12
    mlp_ratio: float = 4.0
    t: int = 4                      # time steps (paper supports up to 4)
    chain_len: int | None = None    # reconfigurable unrolled-LIF chains
    residual: str = "iand"          # "iand" (paper) | "add" (Spikformer baseline)
    attn_scale: float = 0.125
    attn_ordering: str = "quadratic"
    theta: float = 0.5
    lam: float = 0.25
    lif_schedule: str = "parallel"  # "parallel" (paper) | "serial" (SpinalFlow-style)
    use_kernel: bool = False        # route LIF/SSA through the kernel wrappers
    tick_fold: bool = True          # False: Linear/BN once per time step
    tokenizer_channels: tuple[int, ...] | None = None
    tokenizer_pools: tuple[bool, ...] = (False, False, True, True)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def tokenizer_config(self) -> tok.TokenizerConfig:
        d = self.embed_dim
        return tok.TokenizerConfig(
            in_channels=self.in_channels, embed_dim=d,
            stage_channels=self.tokenizer_channels or (d // 8, d // 4, d // 2, d),
            pool_stages=self.tokenizer_pools, t=self.t, chain_len=self.chain_len,
            theta=self.theta, lam=self.lam, lif_schedule=self.lif_schedule,
            use_kernel=self.use_kernel, tick_fold=self.tick_fold)


# -- init -----------------------------------------------------------------------

def init(generator: torch.Generator, cfg: SpikformerConfig, device=None):
    """Random parameters and fresh BN state, drawn from ``generator`` (a CPU
    ``torch.Generator``) and placed on ``device``.  The tree has the JAX
    package's structure, so :mod:`repro_torch.bridge` maps one onto the other."""
    params, state = {}, {}
    params["tokenizer"], state["tokenizer"] = tok.init(
        generator, cfg.tokenizer_config(), device)
    for i in range(cfg.num_layers):
        bp, bs = {}, {}
        for u in block_layout(cfg):
            bn_p, bn_s = cnn.bn_init(u.d_out, device=device)
            bp[u.name] = {"lin": cnn.linear_init(generator, u.d_in, u.d_out,
                                                 device=device), "bn": bn_p}
            bs[u.name] = {"bn": bn_s}
        params[f"block{i}"], state[f"block{i}"] = bp, bs
    params["head"] = cnn.linear_init(generator, cfg.embed_dim, cfg.num_classes,
                                     device=device)
    return params, state


# -- apply ----------------------------------------------------------------------

def _lif(cfg, drive, iand_skip=None):
    return lif(drive, theta=cfg.theta, lam=cfg.lam, schedule=cfg.lif_schedule,
               chain_len=cfg.chain_len, use_kernel=cfg.use_kernel,
               iand_skip=iand_skip)


def _ssa(cfg, q, k, v):
    """The ``use_kernel`` flag that selects the LIF kernel also selects the SSA
    kernel (quadratic ordering only: the kernel is the N^2 dataflow)."""
    if cfg.use_kernel and cfg.attn_ordering == "quadratic":
        from repro_torch.kernels.spiking_attention.ops import ssa_op

        return ssa_op(q, k, v, scale=cfg.attn_scale)
    return ssa(q, k, v, scale=cfg.attn_scale, ordering=cfg.attn_ordering)


def _linear_bn_lif(cfg, p, s, x, *, train, iand_skip=None):
    """Tick-batched Linear -> BN -> (unfolded) LIF. x: (T, B, N, Din) spikes.
    With ``tick_fold=False`` the linear runs once per time step.  Returns
    (spikes, new BN state)."""
    t = x.shape[0]
    if cfg.tick_fold:
        y = cnn.unfold_time(cnn.linear_apply(p["lin"], cnn.fold_time(x)), t)
    else:
        y = torch.stack([cnn.linear_apply(p["lin"], x[i]) for i in range(t)])
    drive, s_new = cnn.bn_apply(p["bn"], s["bn"], y, train=train)
    return _lif(cfg, drive, iand_skip=iand_skip), {"bn": s_new}


def block_apply(bp, bs, x, cfg: SpikformerConfig, *, train: bool = False):
    """One Spike-(IAND-)Former block walking the shared layer layout.
    x: (T, B, N, D) spikes.  Returns (x, new block state).  Residual joins of
    units marked ``fuse_residual`` go through the LIF dispatch's
    ``iand_skip`` epilogue on the plain route; the kernel route keeps the
    standalone connective, as the reference's does (the fused kernel
    epilogue is forward-only)."""
    res = connective(cfg.residual)
    fuse_in_dispatch = not cfg.use_kernel
    ns: dict = {}
    acts: dict = {}
    h = None
    for u in block_layout(cfg):
        if u.role == "qkv":
            acts[u.name], ns[u.name] = _linear_bn_lif(cfg, bp[u.name], bs[u.name], x,
                                                      train=train)
            continue
        if u.role == "attn_out":
            attn = _ssa(cfg, *(split_heads(acts[n], cfg.num_heads) for n in "qkv"))
            inp = _lif(cfg, merge_heads(attn))   # attn spikes
        elif u.role == "mlp_hidden":
            h, ns[u.name] = _linear_bn_lif(cfg, bp[u.name], bs[u.name], x, train=train)
            continue
        elif u.role == "mlp_out":
            inp = h
        else:
            raise ValueError(f"unknown unit role: {u.role}")
        if u.fuse_residual and fuse_in_dispatch:
            x, ns[u.name] = _linear_bn_lif(cfg, bp[u.name], bs[u.name], inp, train=train,
                                           iand_skip=x)
        else:
            branch, ns[u.name] = _linear_bn_lif(cfg, bp[u.name], bs[u.name], inp,
                                                train=train)
            x = res(x, branch)
    return x, ns


def apply(params, state, image, cfg: SpikformerConfig, *, train: bool = False,
          return_spikes: bool = False):
    """image: (B, H, W, C) in [0,1]. Returns (logits (B, classes), new_state
    [, spikes per block]).  ``train=True``: BatchNorm on batch statistics,
    and ``new_state`` holds the moved running statistics."""
    new_state = {}
    x, new_state["tokenizer"] = tok.apply(params["tokenizer"], state["tokenizer"], image,
                                          cfg.tokenizer_config(), train=train)
    spikes_per_block = [x]
    for i in range(cfg.num_layers):
        x, new_state[f"block{i}"] = block_apply(params[f"block{i}"], state[f"block{i}"], x,
                                                cfg, train=train)
        spikes_per_block.append(x)
    # classification head (full precision, as in the paper): rate decoding
    logits = cnn.linear_apply(params["head"], x.mean(dim=(0, 2)))
    if return_spikes:
        return logits, new_state, spikes_per_block
    return logits, new_state


def spike_sparsity(spikes_per_block) -> float:
    """Fraction of zeros across all spike maps."""
    total = sum(s.numel() for s in spikes_per_block)
    zeros = sum(int((s == 0).sum()) for s in spikes_per_block)
    return zeros / total


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(num_params(v) for v in params)
    return params.numel()
