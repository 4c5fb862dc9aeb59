"""Weight-only int8 quantization for serving, the port of the JAX package's
``models/quantization.py``.

Per-output-channel symmetric int8 halves the bf16 weight stream that bounds
a decode step.  Only 2-D leaves of at least 64 x 64 are quantized, as in the
JAX package: a stacked (L, d_in, d_out) layer leaf passes through, so on a
uniform model only the embedding and the head are quantized.

    qparams, before, after = quantize_params_int8(params)  # matrices -> {q, scale}
    w = dequant(qparams[...])                              # on the fly

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch


def quantize_int8(w: torch.Tensor) -> dict:
    """Per-output-channel (last dim) symmetric int8."""
    w32 = w.to(torch.float32)
    scale = torch.amax(torch.abs(w32), dim=0, keepdim=True) / 127.0
    q = torch.clamp(torch.round(w32 / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequant(qw: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (qw["q"].to(torch.float32) * qw["scale"]).to(dtype)


def _is_weight_matrix(leaf: torch.Tensor) -> bool:
    return leaf.ndim == 2 and leaf.shape[0] >= 64 and leaf.shape[1] >= 64


def _is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def quantize_params_int8(params):
    """Quantize every >=64x64 2-D matrix leaf; other leaves pass through.
    Returns (qparams, bytes_before, bytes_after)."""
    sizes = [0, 0]

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v) for v in tree)
        nbytes = tree.numel() * tree.element_size()
        sizes[0] += nbytes
        if _is_weight_matrix(tree):
            qw = quantize_int8(tree)
            sizes[1] += qw["q"].numel() + qw["scale"].numel() * 4
            return qw
        sizes[1] += nbytes
        return tree

    out = walk(params)
    return out, sizes[0], sizes[1]


def dequantize_params(qparams, dtype=torch.bfloat16):
    """Inverse transform (a server would materialise per layer, on the fly)."""
    if _is_quantized(qparams):
        return dequant(qparams, dtype)
    if isinstance(qparams, dict):
        return {k: dequantize_params(v, dtype) for k, v in qparams.items()}
    if isinstance(qparams, (tuple, list)):
        return type(qparams)(dequantize_params(v, dtype) for v in qparams)
    return qparams
