"""Mamba-2 (SSD, state-space duality) layer -- mamba2-130m [arXiv:2405.21060],
the port of the JAX package's ``models/mamba2.py``.

Chunked dual-form computation for train/prefill (quadratic within chunks,
a linear recurrence across them: a loop over the S / chunk chunks where the
JAX package scans) and an O(1)-state decode step.

Recurrence (per head h, state size N):
    state_t = a_t * state_{t-1} + B_t (x_t * dt_t)^T ;  y_t = C_t . state_t + D x_t
with a_t = exp(dt_t * A_h), A_h = -exp(A_log_h) < 0.

Under a mesh (``tp``, a ``layers.TensorParallel``; the JAX package's specs:
``in_proj`` over (data, model), the conv over its channels on ``model``,
``out_proj`` over (model, data)) on a ``model`` axis above 1:
* ``in_proj`` is gathered whole: its output concatenates z, xBC and dt,
  whose parts do not align with ``model``'s equal blocks;
* the depthwise conv, per channel, runs on this rank's block of the conv
  channels where ``model`` cuts them, and its output is all-gathered; the
  decode cache's ``conv`` is that block, as its spec ("data", None, "model")
  says;
* the SSD scan runs on this rank's block of heads where ``model`` divides
  them, the gated RMSNorm's sum of squares summed over ``model``, and
  ``out_proj`` row-parallel (a psum over ``model``); where it does not, every
  rank scans every head and ``out_proj`` takes this rank's block of d_inner;
* a decode step updates every head on every rank: the cache's ``state``
  ("data", None, None, None) is model-replicated.
With a ``model`` axis of 1 it is the single-device code on the weights
gathered over ``data``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _device, _empty_or, dense_init, rmsnorm_apply


def mamba2_init(generator, cfg, dtype=torch.float32, device=None, lead: tuple = ()):
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    conv_dim = di + 2 * n
    dev = _device(generator, device)
    kw = dict(dtype=dtype, device=dev)
    conv_w = _empty_or(generator, lead + (cfg.ssm_conv, conv_dim), dtype, dev)
    if generator is not None:
        conv_w.mul_(0.1)
    return {
        "in_proj": dense_init(generator, d, 2 * di + 2 * n + h, dtype=dtype, device=device,
                              lead=lead),
        "conv_w": conv_w,
        "conv_b": torch.zeros(lead + (conv_dim,), **kw),
        "A_log": torch.zeros(lead + (h,), **kw),          # A = -exp(0) = -1 init
        "D": torch.ones(lead + (h,), **kw),
        "dt_bias": torch.zeros(lead + (h,), **kw),
        "norm": {"scale": torch.ones(lead + (di,), **kw)},
        "out_proj": dense_init(generator, di, d, dtype=dtype, device=device, lead=lead),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    parts = [xp[:, i:i + x.shape[1], :] * w[i] for i in range(width)]
    return sum(parts) + b


def _split_proj(p, x, cfg, compute_dtype, tp=None):
    """(z, xBC, dt) of ``in_proj``; under ``tp`` the weight gathered whole."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cd = compute_dtype or x.dtype
    w = p["in_proj"]["w"]
    if tp is not None:
        w = tp.weight(w, tp.specs["mixer"]["in_proj"]["w"], full=True)
    z, xbc, dt = torch.split(x.to(cd) @ w.to(cd), [di, di + 2 * n, h], dim=-1)
    return z, xbc, dt


def ssd_chunked(xh, dt, a_neg, bm, cm, *, chunk: int):
    """Chunked SSD. xh: (B,S,H,hd); dt: (B,S,H); a_neg: (H,) = A < 0;
    bm, cm: (B,S,N). Returns (y (B,S,H,hd), final state (B,H,N,hd))."""
    b, s, h, hd = xh.shape
    n = bm.shape[-1]
    nc = s // chunk
    assert s % chunk == 0, (s, chunk)

    log_a = (dt * a_neg).reshape(b, nc, chunk, h)                  # (B,nc,Q,H), <= 0
    xs = (xh * dt[..., None]).reshape(b, nc, chunk, h, hd)
    bmc = bm.reshape(b, nc, chunk, n)
    cmc = cm.reshape(b, nc, chunk, n)
    cum = torch.cumsum(log_a, dim=2)                               # inclusive

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xs_j; the
    # exponent is masked before the exp (the JAX package masks after it, where
    # cum_i - cum_j > 0 of a long chunk overflows to inf and the backward's
    # 0 * inf is NaN; the forward values are the same)
    cb = torch.einsum("bcqn,bckn->bcqk", cmc, bmc)                 # (B,nc,Q,Q)
    idx = torch.arange(chunk, device=xh.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                  float("-inf")))                  # (B,nc,Q,K,H)
    scores = cb[..., None] * decay
    y_intra = torch.einsum("bcqkh,bckhd->bcqhd", scores, xs)

    # chunk summary: S_c = sum_j exp(cum_last - cum_j) B_j (x)_j
    decay_last = torch.exp(cum[:, :, -1:, :] - cum)                # (B,nc,Q,H)
    s_c = torch.einsum("bcqn,bcqh,bcqhd->bchnd", bmc, decay_last, xs)

    # inter-chunk linear recurrence over chunk states (the state BEFORE each chunk)
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (B,nc,H)
    state = xh.new_zeros((b, h, n, hd))
    states_prev = []
    for ci in range(nc):
        states_prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + s_c[:, ci]
    states_prev = torch.stack(states_prev, dim=1)                  # (B,nc,H,N,hd)

    # inter-chunk: y_i += C_i . state_prev * exp(cum_i)
    y_inter = torch.einsum("bcqn,bchnd,bcqh->bcqhd", cmc, states_prev, torch.exp(cum))
    return (y_intra + y_inter).reshape(b, s, h, hd), state


def ssd_serial_ref(xh, dt, a_neg, bm, cm):
    """Serial oracle: the recurrence step by step (tests only)."""
    b, s, h, hd = xh.shape
    n = bm.shape[-1]
    state = xh.new_zeros((b, h, n, hd))
    ys = []
    for t in range(s):
        a_t = torch.exp(dt[:, t] * a_neg)                          # (B,H)
        upd = torch.einsum("bn,bhd->bhnd", bm[:, t], xh[:, t] * dt[:, t, :, None])
        state = state * a_t[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnd->bhd", cm[:, t], state))
    return torch.stack(ys, dim=1)


def _rmsnorm_cut(scale, x, model, width: int, eps: float = 1e-6):
    """``layers.rmsnorm_raw`` of a row cut over ``model`` (this rank holds
    ``x``'s and ``scale``'s block of ``width`` features): the sum of squares
    summed over ``model``.  The sum's gradient is the ranks' partial ones,
    summed (a copy before the psum)."""
    dtype = x.dtype
    x32 = x.float()
    ss = model.all_reduce(model.copy(torch.sum(torch.square(x32), dim=-1, keepdim=True)))
    y = x32 * torch.rsqrt(ss / width + eps)
    return (y * scale.float()).to(dtype)


def _conv_tp(p, xbc_raw, tp, conv):
    """``conv(block, w, b)`` (the causal conv and silu, or a decode step's)
    of the xBC channels every model rank holds: on this rank's block of them
    where ``model`` cuts the conv, the outputs all-gathered.  Returns (the
    whole output, the input block the conv cache keeps); without ``tp`` the
    conv of every channel."""
    if tp is None or not tp.split(tp.specs["mixer"]["conv_w"], 1):
        return conv(xbc_raw, p["conv_w"], p["conv_b"]), xbc_raw
    model = tp.model
    blk = model.block(model.copy(xbc_raw), -1)
    out = conv(blk, p["conv_w"], p["conv_b"])
    return model.all_gather(out, -1, replicated=True), blk


def _out_proj_tp(p, y, tp, heads_local: bool):
    """``out_proj`` on y (this rank's block of d_inner when ``heads_local``):
    row-parallel with a psum over ``model`` where ``model`` cuts its rows;
    without ``tp`` the plain product."""
    if tp is None:
        return y @ p["out_proj"]["w"].to(y.dtype)
    sp, model = tp.specs["mixer"]["out_proj"]["w"], tp.model
    w = tp.weight(p["out_proj"]["w"], sp)
    if not tp.split(sp, 0):
        return y @ w.to(y.dtype)
    if not heads_local:
        y = model.block(model.copy(y), -1)
    return model.all_reduce(y @ w.to(y.dtype))


def mamba2_apply(p, x, cfg, *, compute_dtype=None, return_cache: bool = False, tp=None):
    """Full-sequence SSD block. x: (B, S, D) -> (B, S, D)[, decode cache].
    Under ``tp``: this rank's shards (the module docstring)."""
    if tp is not None and tp.model.size == 1:
        p, tp = tp.dense(p, tp.specs["mixer"]), None   # a model axis of 1: gathered over data
    b, s, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_raw, dt = _split_proj(p, x, cfg, compute_dtype, tp)
    conv = lambda u, w, bias: F.silu(_causal_conv(u, w.to(u.dtype), bias.to(u.dtype)))
    xbc, conv_in = _conv_tp(p, xbc_raw, tp, conv)
    xs, bm, cm = torch.split(xbc, [di, n, n], dim=-1)
    f32 = torch.float32
    dt_bias, a_log, d_skip, scale = p["dt_bias"], p["A_log"], p["D"], p["norm"]["scale"]
    heads = tp is not None and h % tp.model.size == 0     # this rank scans h / M heads
    if heads:
        model = tp.model
        blk = lambda u, dim: model.block(model.copy(u), dim)
        xs, dt, z = blk(xs, -1), blk(dt, -1), blk(z, -1)
        bm, cm = model.copy(bm), model.copy(cm)
        dt_bias, a_log, d_skip, scale = (blk(t, 0) for t in (dt_bias, a_log, d_skip, scale))
    hl = dt.shape[-1]
    dt = F.softplus(dt.to(f32) + dt_bias.to(f32))
    xh = xs.reshape(b, s, hl, hd)
    y, final_state = ssd_chunked(xh.to(f32), dt, -torch.exp(a_log.to(f32)), bm.to(f32),
                                 cm.to(f32), chunk=min(cfg.ssm_chunk, s))
    y = y + d_skip.to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(b, s, hl * hd).to(x.dtype) * F.silu(z)               # gated RMSNorm
    y = _rmsnorm_cut(scale, y, tp.model, di) if heads else rmsnorm_apply({"scale": scale}, y)
    out = _out_proj_tp(p, y, tp, heads_local=heads)
    if return_cache:
        if heads:
            final_state = tp.model.all_gather(final_state, 1, kind="state")
        return out, {"state": final_state, "conv": conv_in[:, -(cfg.ssm_conv - 1):, :].to(x.dtype)}
    return out


def mamba2_cache_init(cfg, batch: int, dtype=torch.float32, device=None):
    h, n, hd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, n, hd), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def _conv_step(hist, w, bias):
    """The decode conv over ``hist`` (B, W, C): the cached W-1 inputs and the
    current one; silu of its output, (B, 1, C)."""
    out = torch.einsum("bwc,wc->bc", hist, w.to(hist.dtype)) + bias.to(hist.dtype)
    return F.silu(out)[:, None, :]


def mamba2_decode_step(p, x, cache, cfg, *, compute_dtype=None, tp=None):
    """One-token decode. x: (B, 1, D) -> (y (B, 1, D), cache').  Under
    ``tp``: this rank's shards and cache blocks (the module docstring)."""
    b = x.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    if tp is not None and tp.model.size == 1:
        p, tp = tp.dense(p, tp.specs["mixer"]), None
    history = lambda u: torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)
    conv = lambda u, w, bias: _conv_step(history(u), w, bias)
    z, xbc, dt = _split_proj(p, x, cfg, compute_dtype, tp)
    xbc_t, xbc = _conv_tp(p, xbc, tp, conv)          # xbc: the block the cache keeps
    new_conv = history(xbc)[:, 1:, :]
    xs, bm, cm = torch.split(xbc_t, [di, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))[:, 0]
    a_t = torch.exp(dt * -torch.exp(p["A_log"].to(f32)))           # (B,H)
    xh = xs.reshape(b, h, hd).to(f32)
    upd = torch.einsum("bn,bhd->bhnd", bm[:, 0].to(f32), xh * dt[..., None])
    state = cache["state"] * a_t[..., None, None] + upd
    y = torch.einsum("bn,bhnd->bhd", cm[:, 0].to(f32), state)
    y = y + p["D"].to(f32)[None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    return _out_proj_tp(p, y, tp, heads_local=False), {"state": state, "conv": new_conv}
