"""Wrapper of the spiking_attention CUDA kernel (``csrc/ssa.cu``).

:func:`ssa_fwd` is the one launch site: a CUDA tensor goes to the kernel (or
the call raises), a CPU tensor to the plain version.  Its ``launches``
attribute counts kernel launches.  :func:`ssa_op` folds (T, B, H, N, Dh) into
(G, N, Dh) and makes the operands contiguous: the head split hands over a
transposed view, and the kernel assumes a dense layout.  Ragged token counts
are masked in the kernel, so nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spiking_attention.ref import ssa_ref

MAX_HEAD_DIM = 128   # the kernel's register tile (kMaxD in ssa.cu)

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def ssa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
            causal: bool = False) -> torch.Tensor:
    """q (G, N, D), k/v (G, M, D) -> (G, N, D); no zero-sized dims."""
    g, n, d = q.shape
    m = k.shape[1]
    if k.shape != (g, m, d) or v.shape != (g, m, d):
        raise ValueError(f"ssa operand shapes differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return ssa_ref(q, k, v, scale=scale, causal=causal)
    _build.check_operands("ssa_fwd", q, k, v)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"ssa_fwd: head dim {d} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    fn = _build.kernel("ssa", "ssa_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g, n, m,
                 d, scale, int(causal), _build.stream(q.device))
    _build.check(err, "ssa", "ssa_fwd")
    ssa_fwd.launches += 1
    return out


ssa_fwd.launches = 0


def ssa_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float = 0.125, causal: bool = False) -> torch.Tensor:
    """Tick-batched spiking attention. q,k,v: (T, B, H, N, Dh) -> same shape.
    ``causal`` masks the spike score matrix to the lower triangle in-kernel."""
    t, b, h, n, dh = q.shape
    if 0 in (q.numel(), k.numel()):
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    fold = lambda x: x.reshape(t * b * h, x.shape[3], dh).contiguous()
    out = ssa_fwd(fold(q), fold(k), fold(v), scale=float(scale), causal=causal)
    return out.reshape(t, b, h, n, dh)
