"""Error-feedback int8 gradient compression for the cross-pod all-reduce.

At large scale the slowest link is the pod-to-pod gradient all-reduce.  The
standard mitigation: quantize gradients to int8 with a per-block scale before
the wire, and keep the quantization residual in an error-feedback buffer
added to the next step's gradient (Seide et al.; the 1-bit Adam family).
Convergence-neutral in expectation, because the error is re-injected.

Tensor building blocks (applied to gradients, no autograd needed):

    compressed, scales = compress(g)
    g_hat              = decompress(compressed, scales, g.shape)
    g_out, new_residual = error_feedback_step(g, residual)

The arithmetic is the JAX package's, op for op (float32 scales, round half
to even, clip to +-127), so both packages give the same bits on the same
inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    n = flat.numel()
    return F.pad(flat, (0, (-n) % BLOCK)), n


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float gradient -> (int8 blocks (n_blocks, BLOCK), f32 per-block scales)."""
    flat, _ = _pad_to_block(g.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / scale.clamp_min(1e-12)), -127, 127)
    return q.to(torch.int8), scale[:, 0]


def decompress(q: torch.Tensor, scale: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape)).to(dtype)


def roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Quantize then dequantize: what the wire delivers."""
    q, s = compress(g)
    return decompress(q, s, g.shape, g.dtype)


def error_feedback_step(g: torch.Tensor, residual: torch.Tensor):
    """(wire-ready gradient estimate, new residual):
    g_corrected = g + residual; g_hat = Q(g_corrected);
    residual' = g_corrected - g_hat."""
    corrected = g.to(torch.float32) + residual
    g_hat = roundtrip(corrected)
    return g_hat.to(g.dtype), corrected - g_hat


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def tree_error_feedback(grads, residuals):
    """:func:`error_feedback_step` leaf by leaf over a gradient tree (nested
    dicts, tuples and lists): (estimates, new residuals), two trees."""
    pairs = [error_feedback_step(g, r) for g, r in zip(_leaves(grads), _leaves(residuals))]
    return (_rebuild(grads, iter(p[0] for p in pairs)),
            _rebuild(grads, iter(p[1] for p in pairs)))


def init_residuals(params):
    """Zero float32 residuals in the shape of every leaf of ``params``."""
    return _rebuild(params, iter(torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                 for p in _leaves(params)))
