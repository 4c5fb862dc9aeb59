"""Wrappers of the lif_parallel CUDA kernels (``csrc/lif_parallel.cu``).

:func:`lif_parallel_fwd` (dense spikes), :func:`lif_parallel_pack_fwd`
(spikes bit-packed along time into int32 words) and :func:`lif_parallel_bwd`
(the drive cotangent under the boxcar surrogate) are the launch sites: a
CUDA tensor goes to the kernel (or the call raises), a CPU tensor to the
plain version (:mod:`repro_torch.kernels.lif_parallel.ref`).  Each has a
``launches`` attribute counting kernel launches.  :func:`lif_parallel_op`,
:func:`lif_iand_op`, :func:`lif_pack_op` and :func:`lif_iand_pack_op` accept
any (T, ...) shape and flatten it to (T, N); the kernels mask the ragged
tail themselves, so nothing is padded.  The packed forms can also return the
occupancy map of their words (``occupancy=True``), counted in the pack
kernel's epilogue.

The drive is float32 or bfloat16 (:data:`DRIVE_DTYPES`), as the JAX
package's kernels take either: a bf16 chain rounds every product and sum to
bf16, the dense forms return spikes (and take a skip) in the drive's dtype,
and the backward returns the cotangent in it.

:func:`lif_parallel_op` is differentiable on both devices: :class:`_LifOp`
runs :func:`lif_parallel_fwd` forward and :func:`lif_parallel_bwd` backward
(the JAX package's ``_lif_op`` custom VJP).  The fused-IAND and packed forms
are forward-only, as in the JAX package, and raise where autograd would
need their gradient.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import OCC_TILE, num_words, occupancy_map
from repro_torch.kernels import _build
from repro_torch.kernels.lif_parallel.ref import (
    lif_pack_ref, lif_parallel_ref, lif_parallel_ref_grad)

SURROGATE_WIDTH = 1.0   # the backward kernel's boxcar, as the JAX package's _SURR_WIDTH
DRIVE_DTYPES = (torch.float32, torch.bfloat16)

VEC_BYTES = 16       # one vector access of the forward kernels (K1, K4)

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_PACK_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                 ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def _check_args(what, drive, skip, skip_rows, chain_len, reset):
    if drive.dtype not in DRIVE_DTYPES:
        raise TypeError(f"{what}: the drive must be float32 or bfloat16, got {drive.dtype}")
    t_total, n = drive.shape
    if reset not in ("hard", "soft"):
        raise ValueError(f"unknown reset mode: {reset}")
    if chain_len < 1 or t_total % chain_len:
        raise ValueError(f"T={t_total} not divisible by chain_len={chain_len}")
    if skip is not None and tuple(skip.shape) != (skip_rows, n):
        raise ValueError(f"{what}: skip shape {tuple(skip.shape)} != "
                         f"{(skip_rows, n)} for drive {tuple(drive.shape)}")


def forward_body(dtype: torch.dtype, n: int, addresses, occ_cols: int = 0) -> tuple[int, bool]:
    """``(vec, occ_warp)``: the body a K1/K4 launch of ``n`` columns takes.
    ``vec`` is the columns a thread moves with one 16-byte access a step
    (``VEC_BYTES`` of the drive: 4 float32, 8 bfloat16) where ``n`` and the
    map's row width ``occ_cols`` are multiples of it and every operand's
    address in ``addresses`` (drive, skip, output) is 16-byte aligned; else
    1, the same kernel's scalar body.  ``occ_warp``: K4's map is summed in
    the warp and stored, with no memset and no atomics, which needs a map
    whose rows are whole 128-feature tiles (``occ_cols`` a multiple of
    ``OCC_TILE``) and a warp spanning whole tiles (``vec`` >= 4)."""
    full = VEC_BYTES // (torch.finfo(dtype).bits // 8)
    wide = (n % full == 0 and occ_cols % full == 0
            and all(a % VEC_BYTES == 0 for a in addresses))
    vec = full if wide else 1
    return vec, bool(occ_cols) and vec >= 4 and occ_cols % OCC_TILE == 0


def _launch(name, argtypes, drive, skip, skip_dtype, out, chain_len, lam, theta, reset,
            occ=None):
    """Launch the C entry point ``name`` of lif_parallel.cu into ``out``.
    ``occ`` is the packed form's (map, row width) pair (map None: no map)."""
    operands = [(drive, drive.dtype)] + ([] if skip is None else [(skip, skip_dtype)])
    _build.check_operands(name, *operands)
    if out.numel() == 0:
        return
    fn = _build.kernel("lif_parallel", name, argtypes)
    t_total, n = drive.shape
    ptr = lambda x: None if x is None else x.data_ptr()
    pointers = [ptr(drive), ptr(skip), out.data_ptr()]
    sizes = [t_total, n, chain_len, lam, theta, int(reset == "soft")]
    occ_cols = 0
    if occ is not None:
        pointers.append(ptr(occ[0]))
        sizes.append(occ[1])
        occ_cols = occ[1]
    vec, occ_warp = forward_body(drive.dtype, n, [p for p in pointers[:3] if p is not None],
                                 occ_cols)
    sizes += [int(drive.dtype == torch.bfloat16), vec] + ([int(occ_warp)] if occ is not None else [])
    with torch.cuda.device(drive.device):
        err = fn(*pointers, *sizes, _build.stream(drive.device))
    _build.check(err, "lif_parallel", name)


def lif_parallel_fwd(drive: torch.Tensor, *, chain_len: int, lam: float,
                     theta: float, reset: str,
                     skip: torch.Tensor | None = None) -> torch.Tensor:
    """drive: (T, N) f32 or bf16 -> spikes (T, N) in the drive's dtype, or
    IAND(skip, spikes) if skip (the drive's dtype) is given."""
    _check_args("lif_parallel_fwd", drive, skip, drive.shape[0], chain_len, reset)
    if drive.device.type == "cpu":
        return lif_parallel_ref(drive, chain_len=chain_len, lam=lam, theta=theta,
                                reset=reset, skip=skip)
    out = torch.empty_like(drive)
    _launch("lif_parallel_fwd", _ARGTYPES, drive, skip, drive.dtype, out, chain_len,
            lam, theta, reset)
    if out.numel():
        lif_parallel_fwd.launches += 1
        _build.report_launch("lif_parallel_fwd", drive, skip, out)
    return out


lif_parallel_fwd.launches = 0


def lif_parallel_pack_fwd(drive: torch.Tensor, *, chain_len: int, lam: float,
                          theta: float, reset: str,
                          skip_words: torch.Tensor | None = None,
                          occ_cols: int = 0):
    """drive: (T, N) f32 or bf16 -> spike words (ceil(T/32), N) int32, bit t % 32 of
    word t // 32; with ``skip_words`` (same shape as the result) the bitwise
    IAND ``skip_words & ~words``.  With ``occ_cols`` = D > 0 (N a multiple of
    D) it returns ``(words, occ)``: the occupancy map of the final words read
    as N / D rows of D features, (ceil(T/32), N // D, ceil(D / 128)) int32."""
    t_total, n = drive.shape
    w_total = num_words(t_total)
    _check_args("lif_parallel_pack_fwd", drive, skip_words, w_total, chain_len, reset)
    if occ_cols and (occ_cols < 0 or n % occ_cols):
        raise ValueError(f"occupancy rows of {occ_cols} features do not tile N={n}")
    if drive.device.type == "cpu":
        words = lif_pack_ref(drive, chain_len=chain_len, lam=lam, theta=theta,
                             reset=reset, skip_words=skip_words)
        if not occ_cols:
            return words
        return words, occupancy_map(words.reshape(w_total, -1, occ_cols))
    out = torch.empty((w_total, n), dtype=torch.int32, device=drive.device)
    occ = None
    if occ_cols:
        occ = torch.empty((w_total, n // occ_cols, -(-occ_cols // OCC_TILE)),
                          dtype=torch.int32, device=drive.device)
    _launch("lif_parallel_pack_fwd", _PACK_ARGTYPES, drive, skip_words, torch.int32,
            out, chain_len, lam, theta, reset, occ=(occ, occ_cols))
    if out.numel():
        lif_parallel_pack_fwd.launches += 1
        _build.report_launch("lif_parallel_pack_fwd", drive, skip_words, out, occ)
    return out if occ is None else (out, occ)


lif_parallel_pack_fwd.launches = 0


def lif_parallel_bwd(drive: torch.Tensor, g: torch.Tensor, *, chain_len: int,
                     lam: float, theta: float, reset: str,
                     width: float = SURROGATE_WIDTH) -> torch.Tensor:
    """drive, g: (T, N), f32 or bf16 alike -> dx (T, N) in their dtype, the
    VJP of :func:`lif_parallel_fwd` with respect to the drive under the
    boxcar surrogate of ``width``."""
    _check_args("lif_parallel_bwd", drive, None, 0, chain_len, reset)
    if g.shape != drive.shape:
        raise ValueError(f"lif_parallel_bwd: cotangent shape {tuple(g.shape)} != "
                         f"drive shape {tuple(drive.shape)}")
    if drive.device.type == "cpu":
        if width != SURROGATE_WIDTH:
            raise ValueError(f"the plain LIF backward has width {SURROGATE_WIDTH}, "
                             f"not {width}")
        return lif_parallel_ref_grad(drive, g, chain_len=chain_len, lam=lam,
                                     theta=theta, reset=reset)
    _build.check_operands("lif_parallel_bwd", (drive, drive.dtype), (g, drive.dtype))
    dx = torch.empty_like(drive)
    if dx.numel() == 0:
        return dx
    fn = _build.kernel("lif_parallel", "lif_parallel_bwd", _BWD_ARGTYPES)
    t_total, n = drive.shape
    with torch.cuda.device(drive.device):
        err = fn(drive.data_ptr(), g.data_ptr(), dx.data_ptr(), t_total, n, chain_len,
                 lam, theta, int(reset == "soft"), width,
                 int(drive.dtype == torch.bfloat16), _build.stream(drive.device))
    _build.check(err, "lif_parallel", "lif_parallel_bwd")
    lif_parallel_bwd.launches += 1
    _build.report_launch("lif_parallel_bwd", drive, g, dx)
    return dx


lif_parallel_bwd.launches = 0


class _LifOp(torch.autograd.Function):
    """(T, N) drive -> spikes by :func:`lif_parallel_fwd`; the backward is
    :func:`lif_parallel_bwd`, which recomputes the membranes from the saved
    drive (nothing else is kept for it)."""

    @staticmethod
    def forward(ctx, drive2d, chain_len, lam, theta, reset):
        ctx.save_for_backward(drive2d)
        ctx.kw = dict(chain_len=chain_len, lam=lam, theta=theta, reset=reset)
        return lif_parallel_fwd(drive2d, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        (drive2d,) = ctx.saved_tensors
        return lif_parallel_bwd(drive2d, g.contiguous(), **ctx.kw), None, None, None, None


def _forward_only(what: str, *tensors) -> None:
    """Raise if autograd would need the gradient of a forward-only op: the op
    returns a tensor with no ``grad_fn``, which would cut the graph."""
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in tensors):
        raise RuntimeError(f"{what} is forward-only (inference); its inputs require "
                           "grad. Train through lif_parallel_op and the standalone "
                           "residual connective")


def lif_parallel_op(drive: torch.Tensor, *, chain_len: int | None = None,
                    lam: float = 0.25, theta: float = 0.5,
                    reset: str = "hard") -> torch.Tensor:
    """Unrolled parallel tick-batching LIF. drive: (T, ...) -> spikes (T, ...),
    differentiable (:class:`_LifOp`)."""
    t = drive.shape[0]
    out = _LifOp.apply(drive.reshape(t, -1).contiguous(), chain_len or t, float(lam),
                       float(theta), reset)
    return out.reshape(drive.shape)


def lif_iand_op(drive: torch.Tensor, skip: torch.Tensor, *,
                chain_len: int | None = None, lam: float = 0.25,
                theta: float = 0.5, reset: str = "hard") -> torch.Tensor:
    """LIF with the fused IAND epilogue: ``skip * (1 - LIF(drive))``
    (forward-only)."""
    _forward_only("lif_iand_op", drive, skip)
    t = drive.shape[0]
    out = lif_parallel_fwd(drive.reshape(t, -1).contiguous(),
                           chain_len=chain_len or t, lam=float(lam),
                           theta=float(theta), reset=reset,
                           skip=skip.reshape(t, -1).contiguous())
    return out.reshape(drive.shape)


def _pack_result(res, drive: torch.Tensor, occupancy: bool):
    """Words (W, N) -> (W, *S), and the map (W, N // D, nt) -> (W, *S[:-1], nt)."""
    elems = tuple(drive.shape[1:])
    if not occupancy:
        return res.reshape((res.shape[0],) + elems)
    words, occ = res
    return (words.reshape((words.shape[0],) + elems),
            occ.reshape((occ.shape[0],) + elems[:-1] + (occ.shape[-1],)))


def _occ_cols(drive: torch.Tensor, occupancy: bool) -> int:
    return (drive.shape[-1] if drive.ndim > 1 else 1) if occupancy else 0


def lif_pack_op(drive: torch.Tensor, *, chain_len: int | None = None,
                lam: float = 0.25, theta: float = 0.5, reset: str = "hard",
                occupancy: bool = False):
    """LIF whose kernel epilogue packs the T-step train into words.
    drive: (T, ...) f32 or bf16 -> words (ceil(T/32), ...) int32
    (``repro_torch.core.packing`` layout).  ``occupancy=True`` also returns
    the occupancy map of the words (``(words, occ)``).  Forward-only."""
    _forward_only("lif_pack_op", drive)
    t = drive.shape[0]
    res = lif_parallel_pack_fwd(drive.reshape(t, -1).contiguous(),
                                chain_len=chain_len or t, lam=float(lam),
                                theta=float(theta), reset=reset,
                                occ_cols=_occ_cols(drive, occupancy))
    return _pack_result(res, drive, occupancy)


def lif_iand_pack_op(drive: torch.Tensor, skip_words: torch.Tensor, *,
                     chain_len: int | None = None, lam: float = 0.25,
                     theta: float = 0.5, reset: str = "hard", occupancy: bool = False):
    """Fused LIF+IAND, packed in and packed out: the residual is the bitwise
    ``skip_words & ~words`` inside the kernel epilogue.  drive: (T, ...) f32 or bf16,
    skip_words: (ceil(T/32), ...) int32 -> words of the same shape.
    ``occupancy=True`` also returns the map of the post-IAND words.
    Forward-only."""
    _forward_only("lif_iand_pack_op", drive)
    t = drive.shape[0]
    res = lif_parallel_pack_fwd(
        drive.reshape(t, -1).contiguous(), chain_len=chain_len or t, lam=float(lam),
        theta=float(theta), reset=reset,
        skip_words=skip_words.reshape(skip_words.shape[0], -1).contiguous(),
        occ_cols=_occ_cols(drive, occupancy))
    return _pack_result(res, drive, occupancy)
