"""Spiking Tokenizer: convolutional spiking patch embedding + downsampling.

The first convolution is the *encoding layer*: the analog frame is convolved
once and drives the first LIF at every tick (direct encoding).  Later stages
are ConvBN + LIF (+ MaxPool) on spikes, tick-batched.  The stage list is
shared with the deploy engine through
:func:`repro_torch.engine.layout.tokenizer_layout`.  ``train=True`` runs
BatchNorm on batch statistics and returns the moved running statistics;
``train=False`` is the eval view (running statistics).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import nn as cnn
from repro_torch.core.lif import lif
from repro_torch.engine.layout import tokenizer_layout


@dataclass(frozen=True)
class TokenizerConfig:
    in_channels: int = 3
    embed_dim: int = 384
    stage_channels: tuple[int, ...] = (48, 96, 192, 384)
    pool_stages: tuple[bool, ...] = (False, False, True, True)  # CIFAR: 32 -> 8
    t: int = 4
    chain_len: int | None = None
    theta: float = 0.5
    lam: float = 0.25
    lif_schedule: str = "parallel"
    use_kernel: bool = False
    tick_fold: bool = True   # False: conv applied once per tick (serial dataflow)


def init(generator: torch.Generator, cfg: TokenizerConfig, device=None):
    params, state = {}, {}
    for stage in tokenizer_layout(cfg):
        params[stage.conv] = cnn.conv_init(generator, stage.c_in, stage.c_out, 3,
                                           device=device)
        params[stage.bn], state[stage.bn] = cnn.bn_init(stage.c_out, device=device)
    if cfg.stage_channels[-1] != cfg.embed_dim:
        raise ValueError("the last tokenizer stage must output embed_dim channels")
    return params, state


def _lif(cfg: TokenizerConfig, drive):
    return lif(drive, theta=cfg.theta, lam=cfg.lam, schedule=cfg.lif_schedule,
               chain_len=cfg.chain_len, use_kernel=cfg.use_kernel)


def apply(params, state, image, cfg: TokenizerConfig, *, train: bool = False):
    """image: (B, H, W, C) in [0, 1]. Returns (spikes (T, B, N, D), new_state)."""
    new_state = {}
    x = None
    for stage in tokenizer_layout(cfg):
        conv, bn, bn_state = params[stage.conv], params[stage.bn], state[stage.bn]
        if stage.encode:
            # encoding layer: conv once (drive identical across ticks), then
            # broadcast over T and let the LIF dynamics make the spike train
            y, new_state[stage.bn] = cnn.bn_apply(bn, bn_state, cnn.conv_apply(conv, image),
                                                  train=train)
            if stage.pool:
                y = cnn.maxpool(y)
            drive = y[None].expand((cfg.t,) + tuple(y.shape))
        else:
            if cfg.tick_fold:   # tick-batched ConvBN on spikes: one weight read
                y = cnn.conv_apply(conv, cnn.fold_time(x))
            else:               # serial dataflow baseline: T weight reads
                y = cnn.fold_time(torch.stack(
                    [cnn.conv_apply(conv, x[j]) for j in range(cfg.t)]))
            y, new_state[stage.bn] = cnn.bn_apply(bn, bn_state, y, train=train)
            if stage.pool:
                y = cnn.maxpool(y)
            drive = cnn.unfold_time(y, cfg.t)
        x = _lif(cfg, drive)
    t, b, h, w, d = x.shape
    return x.reshape(t, b, h * w, d), new_state
