"""Minimal NN primitives for the spiking models (plain PyTorch functions).

Convention, as in the JAX package: every layer is a pair of functions
    ``*_init(generator, ...) -> params``     (and optionally a state dict)
    ``*_apply(params, x, ...) -> y``
Parameters are plain dicts of tensors; BatchNorm carries running statistics in
a separate ``state`` dict (the ASIC folds ConvBN at deploy time --
``fold_conv_bn`` reproduces that deploy-time view).

Layouts follow the JAX package at every public function: NHWC images, HWIO
conv weights, (d_in, d_out) linear weights.  Layers operate on tick-batched
tensors: the leading time axis T is folded into the batch before any
conv/linear (one weight read serves all T time steps).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _uniform(generator, shape, scale, device, dtype=torch.float32):
    """U(-scale, scale) drawn in f32 on the host from ``generator``, then cast
    to ``dtype`` on ``device`` (the same draw for every dtype)."""
    return torch.empty(shape).uniform_(-scale, scale, generator=generator).to(device, dtype)


# -- Linear -----------------------------------------------------------------

def linear_init(generator, d_in: int, d_out: int, *, bias: bool = True,
                dtype=torch.float32, device=None):
    p = {"w": _uniform(generator, (d_in, d_out), 1.0 / math.sqrt(d_in), device, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# -- Conv2d (NHWC) ------------------------------------------------------------

def conv_init(generator, c_in: int, c_out: int, ksize: int, *, bias: bool = False,
              dtype=torch.float32, device=None):
    scale = 1.0 / math.sqrt(c_in * ksize * ksize)
    p = {"w": _uniform(generator, (ksize, ksize, c_in, c_out), scale, device, dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def _full_f32():
    """cuDNN with TF32 off: the convolutions run in full f32, as the
    reference's do."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (NCHW, OIHW) at ``stride`` with the symmetric zero
    padding ``pad`` (rows, columns) in full f32, forward and backward.
    Autograd would run the backward's two convolutions later, outside any
    flag set around the forward, under the global
    ``torch.backends.cudnn.allow_tf32`` (True by default); here both run
    under the same flags as the forward, with the forward's stride and
    padding."""

    @staticmethod
    def forward(ctx, x, w, stride, pad):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pad = stride, pad
        with _full_f32():
            return F.conv2d(x, w, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _full_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, list(ctx.pad), [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: ``ceil(size / stride)``
    outputs, ``total = max((out - 1) * stride + k - size, 0)`` zeros, the
    low side ``total // 2`` (an even kernel pads one more on the high
    side)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_apply(p, x, *, stride: int = 1, padding: str = "SAME"):
    """x: (N, H, W, C), HWIO kernel of any size, ``padding`` "SAME" or
    "VALID" with XLA's meaning (:func:`_same_pads`).  Permuted around
    ``F.conv2d``, with cuDNN's TF32 off in the forward and in the backward
    (:class:`_Conv2d`).  Where SAME pads one side more than the other, the
    input is zero-padded explicitly first; symmetric padding (every odd
    kernel) goes to the convolution itself."""
    kh, kw = p["w"].shape[:2]
    if padding == "VALID":
        pads = ((0, 0), (0, 0))
    elif padding == "SAME":
        pads = (_same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride))
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    xc = x.permute(0, 3, 1, 2)
    if any(lo != hi for lo, hi in pads):
        (top, bottom), (left, right) = pads
        xc = F.pad(xc, (left, right, top, bottom))
        pads = ((0, 0), (0, 0))
    w = p["w"].permute(3, 2, 0, 1)                       # HWIO -> OIHW
    y = _Conv2d.apply(xc, w, stride, (pads[0][0], pads[1][0])).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"]
    return y


def maxpool(x, *, window: int = 2, stride: int | None = None):
    """``window`` x ``window`` max pool on NHWC at ``stride`` (default
    ``window``), VALID padding.  Its gradient goes to the first maximum of a
    tied window (row-major), as the reference's ``reduce_window`` max VJP
    sends it; overlapping windows add their gradients."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1)


# -- BatchNorm ----------------------------------------------------------------

def bn_init(c: int, dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    params = {"scale": torch.ones((c,), **kw), "bias": torch.zeros((c,), **kw)}
    state = {"mean": torch.zeros((c,), **kw), "var": torch.ones((c,), **kw)}
    return params, state


def bn_apply(p, state, x, *, train: bool = False, momentum: float = 0.9,
             eps: float = 1e-5):
    """BatchNorm over all leading axes (time folded into batch, the paper's
    shared BN across time steps).  Returns (y, new_state).

    ``train=False`` normalises with the running statistics and returns
    ``state`` itself.  ``train=True`` normalises with the batch mean and the
    batch (population, ``correction=0``) variance, which autograd
    differentiates, and returns running statistics moved towards them,
    ``momentum * old + (1 - momentum) * batch``, with no gradient."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean, var = x.mean(dim=axes), x.var(dim=axes, correction=0)
        new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mean.detach(),
                     "var": momentum * state["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var, new_state = state["mean"], state["var"], state
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_state


def _fold_bn(w, b, bn_p, bn_state, eps):
    g = bn_p["scale"] * torch.rsqrt(bn_state["var"] + eps)
    folded_b = bn_p["bias"] - bn_state["mean"] * g
    if b is not None:
        folded_b = folded_b + b * g
    return {"w": w * g, "b": folded_b}   # g broadcasts over the output (last) axis


def fold_conv_bn(conv_p, bn_p, bn_state, eps: float = 1e-5):
    """Deploy-time ConvBN folding (the accelerator's view of the weights)."""
    return _fold_bn(conv_p["w"], conv_p.get("b"), bn_p, bn_state, eps)


def fold_linear_bn(lin_p, bn_p, bn_state, eps: float = 1e-5):
    """Deploy-time Linear+BN folding: one (w, b) pair, BN disappears."""
    return _fold_bn(lin_p["w"], lin_p.get("b"), bn_p, bn_state, eps)


def fold_linear_rmsnorm(lin_p, norm_p):
    """Deploy-time Linear+RMSNorm folding (the LM counterpart of
    :func:`fold_linear_bn`).

    ``rmsnorm(y; g) = y * rsqrt(mean(y^2) + eps) * g``: the gain folds into
    the preceding linear exactly, ``y' = x @ (w * g)``, and ``mean(y^2) =
    sum_j y'_j^2 / (d * g_j^2)``, so the folded unit carries ``w' = w * g``
    and the coefficients ``nrm = 1 / (d * g^2)``; the deploy graph applies
    one GEMM and the gain-free epilogue :func:`rms_epilogue`.  Exact in real
    arithmetic for any nonzero gain; elementwise IEEE products, so the folded
    arrays equal the JAX package's bit for bit."""
    g = norm_p["scale"]
    d = lin_p["w"].shape[-1]
    folded = {"w": lin_p["w"] * g, "nrm": 1.0 / (d * torch.square(g))}
    if "b" in lin_p:
        folded["b"] = lin_p["b"] * g
    return folded


def normed_linear_apply(p, x, *, eps: float = 1e-6):
    """Folded Linear+RMSNorm unit: GEMM on the pre-scaled weights, then the
    gain-free normalizer epilogue (see :func:`fold_linear_rmsnorm`)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return rms_epilogue(p["nrm"], y, eps=eps)


def rms_epilogue(nrm, y, *, eps: float = 1e-6):
    """Gain-free dynamic normalizer of a folded Linear+RMSNorm unit:
    ``y * rsqrt(sum(y^2 * nrm) + eps)`` with ``nrm = 1/(d * g^2)`` from the
    fold, in f32 and cast back to ``y``'s dtype, as the reference writes it
    (its sum order and ``rsqrt`` are XLA's, these PyTorch's: the two may
    differ in the last bit)."""
    dtype = y.dtype
    y32 = y.float()
    var = torch.sum(torch.square(y32) * nrm.float(), dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps)).to(dtype)


# -- tick-batch reshaping helpers ---------------------------------------------

def fold_time(x):
    """(T, B, ...) -> (T*B, ...): the parallel tick-batching fold."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unfold_time(x, t: int):
    """(T*B, ...) -> (T, B, ...)."""
    return x.reshape((t, x.shape[0] // t) + tuple(x.shape[1:]))
