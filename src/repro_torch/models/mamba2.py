"""Mamba-2 (SSD, state-space duality) layer -- mamba2-130m [arXiv:2405.21060],
the port of the JAX package's ``models/mamba2.py``.

Chunked dual-form computation for train/prefill (quadratic within chunks,
a linear recurrence across them: a loop over the S / chunk chunks where the
JAX package scans) and an O(1)-state decode step.

Recurrence (per head h, state size N):
    state_t = a_t * state_{t-1} + B_t (x_t * dt_t)^T ;  y_t = C_t . state_t + D x_t
with a_t = exp(dt_t * A_h), A_h = -exp(A_log_h) < 0.
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


def _split_proj(p, x, cfg, compute_dtype):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cd = compute_dtype or x.dtype
    zxbcdt = x.to(cd) @ p["in_proj"]["w"].to(cd)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)
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

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xs_j
    cb = torch.einsum("bcqn,bckn->bcqk", cmc, bmc)                 # (B,nc,Q,Q)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,nc,Q,K,H)
    idx = torch.arange(chunk, device=xh.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    scores = cb[..., None] * torch.where(mask, decay, 0.0)
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


def mamba2_apply(p, x, cfg, *, compute_dtype=None, return_cache: bool = False):
    """Full-sequence SSD block. x: (B, S, D) -> (B, S, D)[, decode cache]."""
    b, s, d = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_raw, dt = _split_proj(p, x, cfg, compute_dtype)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"].to(xbc_raw.dtype),
                              p["conv_b"].to(xbc_raw.dtype)))
    xs, bm, cm = torch.split(xbc, [di, n, n], dim=-1)
    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
    a_neg = -torch.exp(p["A_log"].to(f32))
    xh = xs.reshape(b, s, h, hd)
    y, final_state = ssd_chunked(xh.to(f32), dt, a_neg, bm.to(f32), cm.to(f32),
                                 chunk=min(cfg.ssm_chunk, s))
    y = y + p["D"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(b, s, di).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))                    # gated RMSNorm
    out = y @ p["out_proj"]["w"].to(y.dtype)
    if return_cache:
        cache = {"state": final_state,
                 "conv": xbc_raw[:, -(cfg.ssm_conv - 1):, :].to(x.dtype)}
        return out, cache
    return out


def mamba2_cache_init(cfg, batch: int, dtype=torch.float32, device=None):
    h, n, hd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, n, hd), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba2_decode_step(p, x, cache, cfg, *, compute_dtype=None):
    """One-token decode. x: (B, 1, D) -> (y (B, 1, D), cache')."""
    b = x.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    z, xbc, dt = _split_proj(p, x, cfg, compute_dtype)
    # conv over (cached W-1 inputs + current)
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(hist.dtype)
    conv_out = torch.einsum("bwc,wc->bc", hist, w) + p["conv_b"].to(hist.dtype)
    xbc_t = F.silu(conv_out)[:, None, :]
    new_conv = hist[:, 1:, :]
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
    y = y @ p["out_proj"]["w"].to(y.dtype)
    return y, {"state": state, "conv": new_conv}
