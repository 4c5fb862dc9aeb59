"""Plain PyTorch versions of the spike_matmul kernels."""

from __future__ import annotations

import torch

from repro_torch.core import nn as cnn
from repro_torch.core.packing import OCC_TILE
from repro_torch.core.spiking_attention import _bitplanes

OCC_ROWS = 64        # M rows per tile of the occupancy-gated GEMM


def spike_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, C) -> (M, C) in f32."""
    return x.float() @ w.float()


def packed_spike_matmul_ref(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """(M, K) int32 words (T <= 32 steps each) x (K, C) -> (T, M, C) f32:
    each bitplane shifted out of the words, then ``plane @ w``."""
    return _bitplanes(xw[None], t) @ w.float()


def sparse_packed_spike_matmul_ref(xw: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor,
                                   *, t: int) -> torch.Tensor:
    """The occupancy-gated packed GEMM: a (64-row, 128-feature) word tile
    whose count in ``tiles`` is 0 contributes nothing (its words are read as
    zero), then :func:`packed_spike_matmul_ref`.  Where the counts are those
    of the words, a dead tile's words are zero already and the result equals
    the packed GEMM's."""
    m, k = xw.shape
    alive = (tiles != 0).repeat_interleave(OCC_ROWS, 0)[:m]
    alive = alive.repeat_interleave(OCC_TILE, 1)[:, :k]
    return packed_spike_matmul_ref(torch.where(alive, xw, 0), w, t=t)


def conv1x1_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv oracle: x (N, H, W, Cin), w (Cin, Cout) -> (N, H, W, Cout) in
    f32."""
    return torch.einsum("nhwc,cd->nhwd", x.float(), w.float())


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv oracle: x (N, H, W, Cin), w (3, 3, Cin, Cout) HWIO, SAME
    padding, stride 1 -> (N, H, W, Cout), a direct f32 convolution (cuDNN
    with TF32 off on the card: ``core.nn.conv_apply``)."""
    return cnn.conv_apply({"w": w.float()}, x.float())
