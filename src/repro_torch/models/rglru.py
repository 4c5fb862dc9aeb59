"""RG-LRU recurrent block (recurrentgemma / Griffin, arXiv:2402.19427), the
port of the JAX package's ``models/rglru.py``.

The recurrent branch: x -> {gelu gate, conv1d -> RG-LRU} -> elementwise
product -> out projection.  RG-LRU:

    r_t = sigmoid(W_a xi_t);  i_t = sigmoid(W_x xi_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

The sequence form is a log-depth (Hillis-Steele) scan over the (a, b) pairs
of the linear recurrence, where the JAX package calls
``jax.lax.associative_scan``: log2(S) passes, not S steps.  Its products are
taken in another order than XLA's, so the two agree within f32 rounding, not
bit for bit.  Decode carries the O(lru_width) hidden state.  The gate
projections are block-diagonal with num_heads blocks.

Under a mesh (``tp``, a ``layers.TensorParallel``; the JAX package's specs)
the block is cut by head over ``model``: ``w_x`` and ``w_y`` column-parallel,
the conv on this rank's channels, the block-diagonal gates and ``lam`` on
its heads -- so the RG-LRU scan and its state ``h`` ("data", "model") stay
on the rank -- and ``w_out`` row-parallel with a psum over ``model``.  Where
``model`` does not divide the heads (or the width), the weights are gathered
whole, every rank computes the block, and the caches enter gathered and
leave as this rank's block where their specs cut them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _device, _empty_or, dense_init

_C = 8.0


def _blockdiag_init(generator, width: int, blocks: int, dtype=torch.float32, device=None,
                    lead: tuple = ()):
    bw = width // blocks
    dev = _device(generator, device)
    w = _empty_or(generator, lead + (blocks, bw, bw), dtype, dev)
    if generator is not None:
        w.mul_(bw ** -0.5)
    return {"w": w, "b": torch.zeros(lead + (width,), dtype=dtype, device=dev)}


def _blockdiag_apply(p, x):
    """x: (..., width) -> (..., width) with block-diagonal weight."""
    blocks, bw, _ = p["w"].shape
    xs = x.reshape(x.shape[:-1] + (blocks, bw))
    y = torch.einsum("...gi,gij->...gj", xs, p["w"].to(x.dtype))
    return y.reshape(x.shape) + p["b"].to(x.dtype)


def rglru_init(generator, cfg, dtype=torch.float32, device=None, lead: tuple = ()):
    d = cfg.d_model
    lru = cfg.lru_width or d
    heads = cfg.num_heads
    dev = _device(generator, device)
    kw = dict(dtype=dtype, device=device, lead=lead)
    conv_w = _empty_or(generator, lead + (cfg.ssm_conv, lru), dtype, dev)
    if generator is not None:
        conv_w.mul_(0.1)
    return {
        "w_x": dense_init(generator, d, lru, **kw),        # recurrent branch in
        "w_y": dense_init(generator, d, lru, **kw),        # gelu gate branch
        "conv_w": conv_w,
        "conv_b": torch.zeros(lead + (lru,), dtype=dtype, device=dev),
        "gate_a": _blockdiag_init(generator, lru, heads, **kw),
        "gate_x": _blockdiag_init(generator, lru, heads, **kw),
        "lam": torch.full(lead + (lru,), 4.0, dtype=dtype, device=dev),  # softplus(4) ~ 4.02
        "w_out": dense_init(generator, lru, d, **kw),
    }


def _causal_conv(x, w, b):
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width)) + b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0 along axis 1, for every t:
    the inclusive scan of ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``
    in log2(S) Hillis-Steele passes (each pass combines every element with
    the one ``shift`` before it)."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        a_cur, b_cur = a[:, shift:], b[:, shift:]
        b = torch.cat([b[:, :shift], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :shift], a_prev * a_cur], dim=1)
        shift *= 2
    return b


def _rg_lru_gates(p, xi):
    """(a, gated input) of each step, in f32."""
    f32 = torch.float32
    r = torch.sigmoid(_blockdiag_apply(p["gate_a"], xi).to(f32))
    i = torch.sigmoid(_blockdiag_apply(p["gate_x"], xi).to(f32))
    log_a = -_C * F.softplus(p["lam"].to(f32)) * r
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (i * xi.to(f32))
    return torch.exp(log_a), gated


def _rg_lru_scan(xi, p, h0=None):
    """xi: (B, S, lru) -> (h (B, S, lru), h_last)."""
    a, gated = _rg_lru_gates(p, xi)
    if h0 is not None:  # decode: fold the carried state into the first step
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None], gated[:, 1:]], dim=1)
    h = linear_scan(a, gated)
    return h.to(xi.dtype), h[:, -1, :]


def _heads_split(tp) -> bool:
    """Whether ``model`` cuts the block by head: the gates' heads and the
    projections' lru columns both."""
    sp = tp.specs["rec"]
    return tp.split(sp["gate_a"]["w"], 0) and tp.split(sp["w_x"]["w"], 1)


def _cache_cut(c, cfg, tp, gather: bool):
    """A cache of the block, whose specs cut its lru dim (the last) over
    ``model`` where ``model`` divides it: gathered whole, or this rank's
    block of it."""
    model = tp.model
    if model.size == 1 or (cfg.lru_width or cfg.d_model) % model.size:
        return c
    if gather:
        return {k: model.all_gather(v, -1, kind="state") for k, v in c.items()}
    return {k: model.block(v, -1) for k, v in c.items()}


def _on_mesh(fn, p, x, cfg, tp, cache=None, **kw):
    """``fn`` (the block or its decode step) on this rank's shards: the
    weights gathered over ``data`` (and whole over ``model`` unless it cuts
    the block by head), a psum over ``model`` of a head-cut block's output."""
    split = _heads_split(tp)
    w = tp.dense(p, tp.specs["rec"], full=not split)
    args = () if cache is None else (cache if split else _cache_cut(cache, cfg, tp, True),)
    y, out = fn(w, tp.model.copy(x) if split else x, *args, cfg, **kw)
    if split:
        return tp.model.all_reduce(y), out
    return y, out if not isinstance(out, dict) else _cache_cut(out, cfg, tp, False)


def rglru_block_apply(p, x, cfg, *, compute_dtype=None, h0=None, return_cache: bool = False,
                      tp=None):
    """Recurrent temporal block. x: (B, S, D) -> (y, h_last | decode cache).
    Under ``tp``: this rank's shards, the cache its blocks."""
    if tp is not None:
        return _on_mesh(rglru_block_apply, p, x, cfg, tp, compute_dtype=compute_dtype, h0=h0,
                        return_cache=return_cache)
    cd = compute_dtype or x.dtype
    x = x.to(cd)
    gate = F.gelu(x @ p["w_y"]["w"].to(cd), approximate="tanh")
    xi_raw = x @ p["w_x"]["w"].to(cd)
    xi = _causal_conv(xi_raw, p["conv_w"].to(cd), p["conv_b"].to(cd))
    h, h_last = _rg_lru_scan(xi, p, h0=h0)
    y = (gate * h) @ p["w_out"]["w"].to(cd)
    if return_cache:
        width = p["conv_w"].shape[0]
        return y, {"h": h_last, "conv": xi_raw[:, -(width - 1):, :]}
    return y, h_last


def rglru_cache_init(cfg, batch: int, dtype=torch.float32, device=None):
    lru = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, lru), dtype=dtype, device=device),
    }


def rglru_decode_step(p, x, cache, cfg, *, compute_dtype=None, tp=None):
    """One-token decode. x: (B, 1, D) -> (y (B, 1, D), cache').  Under
    ``tp``: this rank's shards and cache blocks."""
    if tp is not None:
        return _on_mesh(rglru_decode_step, p, x, cfg, tp, cache, compute_dtype=compute_dtype)
    cd = compute_dtype or x.dtype
    x = x.to(cd)
    gate = F.gelu(x @ p["w_y"]["w"].to(cd), approximate="tanh")
    xi = x @ p["w_x"]["w"].to(cd)                                  # (B, 1, lru)
    hist = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(hist.dtype)
    xi_t = (torch.einsum("bwc,wc->bc", hist, w) + p["conv_b"].to(hist.dtype))[:, None, :]
    a, gated = _rg_lru_gates(p, xi_t)
    h_new = a[:, 0] * cache["h"] + gated[:, 0]
    y = (gate * h_new[:, None, :].to(cd)) @ p["w_out"]["w"].to(cd)
    return y, {"h": h_new, "conv": hist[:, 1:, :]}
