"""Input encoding: 8-bit images -> spike trains.

The paper's encoding layer (Sec. II): the first convolution turns the analog
image into spikes across time steps ("direct" encoding: the image is the
drive at every time step, and the LIF after the first ConvBN makes the spike
train).

The accelerator also splits the 8-bit input into bitplanes, so that the
binary-input PE blocks run the first layer too (Sec. III-A): the image is
x = sum_k 2^k b_k with b_k binary, so Conv(x) = sum_k 2^k Conv(b_k) -- eight
binary passes through the spike conv, recombined by powers of two.  With the
kernel route's 3x3 spike conv as ``conv_apply_fn`` (``kernels.spike_matmul.
ops.conv3x3_op``) the eight planes are one spike GEMM (K2) over 8 B images.
The deploy plans keep the direct conv, as the JAX package's do.
"""

from __future__ import annotations

import torch

BITS = 8


def direct_encode(image: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H, W, C) in [0, 1] -> (T, B, H, W, C): the same drive at every
    time step (a broadcast view)."""
    return image[None].expand((t,) + tuple(image.shape))


def to_bitplanes(image_u8: torch.Tensor) -> torch.Tensor:
    """(..., C) uint8 -> (8, ..., C) float32 binary planes, LSB first."""
    if image_u8.dtype != torch.uint8:
        raise TypeError(f"to_bitplanes takes a uint8 image, got {image_u8.dtype}")
    return torch.stack([(image_u8 >> k) & 1 for k in range(BITS)]).float()


def from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitplanes`: sum over the leading axis with 2^k
    weights, in f32."""
    weights = (2.0 ** torch.arange(planes.shape[0], dtype=torch.float32,
                                   device=planes.device))
    return torch.sum(planes * weights.reshape((-1,) + (1,) * (planes.ndim - 1)), dim=0)


def bitplane_conv(conv_apply_fn, conv_params, image_u8: torch.Tensor) -> torch.Tensor:
    """A convolution of an 8-bit (B, H, W, C) image as 8 binary-plane passes:
    equal to ``conv_apply_fn(conv_params, image_u8.float())`` by linearity
    (the conv must be linear: no bias).  The planes are folded into the
    batch, (8 B, H, W, C), so one call of ``conv_apply_fn`` serves all eight,
    as the JAX package's ``vmap`` over the planes does."""
    planes = to_bitplanes(image_u8)                              # (8, B, H, W, C)
    out = conv_apply_fn(conv_params, planes.reshape((-1,) + tuple(planes.shape[2:])))
    return from_bitplanes(out.reshape((BITS, -1) + tuple(out.shape[1:])))
