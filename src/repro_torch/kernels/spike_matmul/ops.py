"""Wrappers mapping the model's layer types onto ONE GEMM kernel
(``csrc/spike_matmul.cu``).

Mirrors the accelerator's reconfigurable PE dataflow (Fig. 4): the same GEMM
serves 3x3 conv (im2col -> GEMM), 1x1 conv and matmul.  Inputs are spike
tensors with T already folded into the leading dim, so each weight tile is
fetched once for all time steps.

:func:`spike_matmul_fwd` (dense spikes) and :func:`packed_spike_matmul_fwd`
(spikes bit-packed along time into int32 words, ``repro_torch.core.packing``
layout) are the launch sites: a CUDA tensor goes to the kernel (or the call
raises), a CPU tensor to the plain version.  Each has a ``launches``
attribute counting kernel launches.  The kernels mask ragged M, K and C, so
nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.spike_matmul.ref import packed_spike_matmul_ref, spike_matmul_ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_PACKED_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
MAX_PACKED_T = 32    # time steps one word carries


def spike_matmul_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) spikes, w: (K, C) weights -> (M, C) f32; no zero-sized dims."""
    (m, k), (k2, c) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return spike_matmul_ref(x, w)
    _build.check_operands("spike_matmul_fwd", (x, torch.float32), (w, torch.float32))
    out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel("spike_matmul", "spike_matmul_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, c,
                 _build.stream(x.device))
    _build.check(err, "spike_matmul", "spike_matmul_fwd")
    spike_matmul_fwd.launches += 1
    return out


spike_matmul_fwd.launches = 0


def packed_spike_matmul_fwd(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """xw: (M, K) int32 spike words carrying ``t`` <= 32 time steps, w: (K, C)
    weights -> (T, M, C) f32; no zero-sized dims."""
    (m, k), (k2, c) = xw.shape, w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: xw {tuple(xw.shape)}, w {tuple(w.shape)}")
    if not 1 <= t <= MAX_PACKED_T:
        raise ValueError(f"packed GEMM holds T<=32 steps per word, got {t}")
    if xw.device.type == "cpu":
        return packed_spike_matmul_ref(xw, w, t=t)
    _build.check_operands("packed_spike_matmul_fwd", (xw, torch.int32), (w, torch.float32))
    out = torch.empty((t, m, c), dtype=torch.float32, device=xw.device)
    fn = _build.kernel("spike_matmul", "packed_spike_matmul_fwd", _PACKED_ARGTYPES)
    with torch.cuda.device(xw.device):
        err = fn(xw.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, c, t,
                 _build.stream(xw.device))
    _build.check(err, "spike_matmul", "packed_spike_matmul_fwd")
    packed_spike_matmul_fwd.launches += 1
    return out


packed_spike_matmul_fwd.launches = 0


def spike_matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) spikes x (K, C) -> (M, C) f32.

    Zero-sized dims never reach the kernel: an empty M/C yields an empty
    result, an empty K (summing over nothing) yields zeros.
    """
    (m, k), (_, c) = x.shape, w.shape
    if 0 in (m, k, c):
        return torch.zeros((m, c), dtype=torch.float32, device=x.device)
    return spike_matmul_fwd(x.contiguous(), w.contiguous())


def packed_spike_matmul_op(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """Packed-operand GEMM: (M, K) int32 spike words x (K, C) -> (T, M, C) f32.

    ``xw`` carries all ``t`` (<= 32) time steps of each spike in one word,
    so the activation read is 1/t of the dense GEMM's.  Zero-sized dims never
    reach the kernel, as in :func:`spike_matmul_op`.
    """
    (m, k), (_, c) = xw.shape, w.shape
    if 0 in (m, k, c):
        return torch.zeros((t, m, c), dtype=torch.float32, device=xw.device)
    return packed_spike_matmul_fwd(xw.contiguous(), w.contiguous(), t=t)


def conv1x1_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv as direct GEMM. x: (N, H, W, Cin), w: (Cin, Cout)."""
    n, h, wd, c = x.shape
    return spike_matmul_op(x.reshape(n * h * wd, c), w).reshape(n, h, wd, w.shape[1])


def _im2col(x: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """(N, H, W, C) -> (N*H*W, ksize*ksize*C) patches, SAME padding.

    Column order is HWIO: column ``(i*ksize + j)*C + c`` holds pixel
    (h+i-p, w+j-p) channel c, so an HWIO weight reshaped to
    (ksize*ksize*C, Cout) lines up row for row.  (``F.unfold`` orders the
    columns channel-major instead, ``c*ksize*ksize + i*ksize + j``.)
    """
    n, h, w, c = x.shape
    p = ksize // 2
    xp = F.pad(x, (0, 0, p, p, p, p))        # pads W then H of NHWC
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(ksize) for j in range(ksize)]
    return torch.cat(cols, dim=-1).reshape(n * h * w, ksize * ksize * c)


def conv3x3_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv as im2col GEMM. x: (N, H, W, Cin), w: (3, 3, Cin, Cout)."""
    n, h, wd, c = x.shape
    cout = w.shape[-1]
    out = spike_matmul_op(_im2col(x, 3), w.reshape(9 * c, cout))
    return out.reshape(n, h, wd, cout)


def packed_conv3x3_op(xw: torch.Tensor, w: torch.Tensor, *, t: int) -> torch.Tensor:
    """3x3 conv on packed spike words. xw: (N, H, W, Cin) int32 words (t <= 32
    time steps each), w: (3, 3, Cin, Cout) -> (T, N, H, W, Cout).

    Packing is elementwise over (N, H, W, C), so im2col commutes with it: the
    patches are gathered as words (SAME padding is the all-zero word) in the
    HWIO column order of :func:`_im2col`, and the packed GEMM unpacks them.
    """
    n, h, wd, c = xw.shape
    cout = w.shape[-1]
    out = packed_spike_matmul_op(_im2col(xw, 3), w.reshape(9 * c, cout), t=t)
    return out.reshape(t, n, h, wd, cout)
