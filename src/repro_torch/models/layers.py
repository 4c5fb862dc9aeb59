"""Transformer building blocks shared by the assigned architectures, the port
of the JAX package's ``models/layers.py``.

Everything is functional: ``*_init(generator, ...) -> params`` (a nested
dict of tensors, the JAX package's tree) and ``*_apply(params, x, ...) ->
y``.  Attention is a memory-bounded chunked (flash-style) computation:
queries go in blocks with an online softmax over KV blocks, so the N x N
score matrix is never held, in the forward or in the backward
(:class:`_FlashAttention` recomputes the score tiles).

Where the JAX package asks for ``preferred_element_type=jnp.float32`` (a
product of compute-dtype operands accumulated and returned in f32), the port
upcasts the operands to f32: a product of two bf16 numbers is exact in f32,
so the two agree but for the order of the sums.  The eager Python loops over
the tiles are already the "unrolled" form of the JAX package's probe switch
``UNROLL_ATTN``, so the port has no such switch.

An ``*_init`` draws from ``generator`` on its device; with ``generator=None``
it makes uninitialised tensors on ``device`` (``"meta"``: shapes and dtypes
only, no memory).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _empty_or(generator, shape, dtype, device):
    """``randn(shape)`` from ``generator`` on its device, or an empty tensor
    on ``device`` when there is no generator (the meta device)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)


def _device(generator, device):
    return generator.device if generator is not None else device


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_raw(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in f32 and
    cast back to ``x``'s dtype, written as the reference writes it.  The
    deploy plan's head and :func:`rmsnorm_apply` share it.  Against XLA on
    the CPU, ``torch.rsqrt`` and the mean's order may differ in the last
    bit."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dtype)


def rmsnorm_apply(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as a layer of the oracle view and of the embedding fold:
    :func:`rmsnorm_raw` inside a ``record_function`` region named
    ``rmsnorm_apply``, which ``engine.analysis.rmsnorm_op_count`` counts (the
    JAX package jits it to count it in a jaxpr by name)."""
    with torch.profiler.record_function("rmsnorm_apply"):
        return rmsnorm_raw(p, x, eps=eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float) -> torch.Tensor:
    """x: (..., S, n, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                        # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs        # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense / MLP
# ---------------------------------------------------------------------------

def dense_init(generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, device=None, lead: tuple = ()):
    """Weight N(0, 1/d_in) of shape ``lead + (d_in, d_out)`` (``lead`` stacks
    layers), bias zeros."""
    dev = _device(generator, device)
    w = _empty_or(generator, lead + (d_in, d_out), dtype, dev)
    if generator is not None:
        w.mul_(1.0 / math.sqrt(d_in))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=dev)
    return p


def dense_apply(p, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    w = p["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def mlp_init(generator, d: int, d_ff: int, *, act: str, dtype=torch.float32,
             device=None, lead: tuple = ()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"down": dense_init(generator, d_ff, d, **kw)}
    if act in ("swiglu", "geglu"):
        p["gate"] = dense_init(generator, d, d_ff, **kw)
    p["up"] = dense_init(generator, d, d_ff, **kw)  # gelu: musicgen's plain MLP
    return p


def mlp_apply(p, x: torch.Tensor, *, act: str, compute_dtype=None) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(dense_apply(p["gate"], x, compute_dtype=compute_dtype))
        h = h * dense_apply(p["up"], x, compute_dtype=compute_dtype)
    elif act == "geglu":
        h = F.gelu(dense_apply(p["gate"], x, compute_dtype=compute_dtype), approximate="tanh")
        h = h * dense_apply(p["up"], x, compute_dtype=compute_dtype)
    elif act == "gelu":
        h = F.gelu(dense_apply(p["up"], x, compute_dtype=compute_dtype), approximate="tanh")
    else:
        raise ValueError(act)
    return dense_apply(p["down"], h, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------

_NEG_INF = -1e30


def _mask_block(qpos_i, kpos_j, prefix_len, window):
    """(bq, bk) attention mask for one tile."""
    mask = kpos_j[None, :] <= qpos_i[:, None]  # causal
    if prefix_len > 0:
        mask = mask | (kpos_j[None, :] < prefix_len)
    if window is not None:
        mask = mask & (kpos_j[None, :] > qpos_i[:, None] - window)
    return mask


def _f32(x):
    return x.to(torch.float32)


def _flash_fwd(q, k, v, q_positions, kv_positions, prefix_len, window,
               block_q, block_k, scale):
    """Online softmax over KV blocks. Returns (out, lse).

    q: (B, Sq, KV, G, Dh); k, v: (B, Skv, KV, Dh). out: q's shape and dtype;
    lse: (B, Sq, KV, G) f32 log-sum-exp rows (saved for the backward).
    """
    b, sq, kv, g, dh = q.shape
    skv = k.shape[1]
    nq, nk = sq // block_q, skv // block_k
    outs, lses = [], []
    for qi in range(nq):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        q_i, qpos_i = _f32(q[:, qs]), q_positions[qs]
        acc = q.new_zeros((b, block_q, kv, g, dh), dtype=torch.float32)
        m = q.new_full((b, block_q, kv, g), _NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, block_q, kv, g), dtype=torch.float32)
        for kj in range(nk):
            ks = slice(kj * block_k, (kj + 1) * block_k)
            k_j, v_j = k[:, ks], v[:, ks]
            s = torch.einsum("bqhgd,bkhd->bqhgk", q_i, _f32(k_j)) * scale
            mask = _mask_block(qpos_i, kv_positions[ks], prefix_len, window)
            s = torch.where(mask[None, :, None, None, :], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", _f32(p.to(v_j.dtype)), _f32(v_j))
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-37)).to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-37)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _flash_bwd(q, k, v, out, lse, do, q_positions, kv_positions, prefix_len,
               window, block_q, block_k, scale):
    """FA2-style backward: recompute the tiles, O(N) residual memory."""
    b, sq, kv, g, dh = q.shape
    skv = k.shape[1]
    nq, nk = sq // block_q, skv // block_k
    delta = torch.sum(_f32(do) * _f32(out), dim=-1)
    dk = k.new_zeros((b, skv, kv, dh), dtype=torch.float32)
    dv = v.new_zeros((b, skv, kv, dh), dtype=torch.float32)
    dqs = []
    for qi in range(nq):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        q_i, do_i = _f32(q[:, qs]), do[:, qs]
        lse_i, delta_i, qpos_i = lse[:, qs], delta[:, qs], q_positions[qs]
        dq_i = q.new_zeros((b, block_q, kv, g, dh), dtype=torch.float32)
        for kj in range(nk):
            ks = slice(kj * block_k, (kj + 1) * block_k)
            k_j, v_j = _f32(k[:, ks]), _f32(v[:, ks])
            s = torch.einsum("bqhgd,bkhd->bqhgk", q_i, k_j) * scale
            mask = _mask_block(qpos_i, kv_positions[ks], prefix_len, window)
            p = torch.where(mask[None, :, None, None, :],
                            torch.exp(s - lse_i[..., None]), 0.0)
            dv[:, ks] += torch.einsum("bqhgk,bqhgd->bkhd", p, _f32(do_i))
            dp = torch.einsum("bqhgd,bkhd->bqhgk", _f32(do_i), v_j)
            ds = p * (dp - delta_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bqhgk,bkhd->bqhgd", ds, k_j)
            dk[:, ks] += torch.einsum("bqhgk,bqhgd->bkhd", ds, q_i)
        dqs.append(dq_i)
    dq = torch.cat(dqs, dim=1).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash_attention`` custom VJP: the forward returns
    (out, lse) and saves only q, k, v, the output, the log-sum-exp rows and
    the positions; the backward recomputes the score tiles, so peak memory is
    O(block_q * block_k) per (batch, kv head) in both directions.  The lse
    rows carry no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, prefix_len, window,
                block_q, block_k, scale):
        out, lse = _flash_fwd(q, k, v, q_positions, kv_positions, prefix_len,
                              window, block_q, block_k, scale)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.args = (prefix_len, window, block_q, block_k, scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, q_positions, kv_positions = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, q_positions, kv_positions,
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def chunked_attention(q, k, v, *, q_positions, kv_positions, causal: bool = True,
                      prefix_len: int = 0, window: int | None = None,
                      block_q: int = 512, block_k: int = 1024,
                      scale: float | None = None) -> torch.Tensor:
    """Memory-bounded GQA flash attention (forward and recomputing backward).

    q: (B, Sq, H, Dh); k, v: (B, Skv, KV, Dh).  Query heads are grouped onto
    KV heads (H = KV * G).  Masking: causal (and an optional prefix-LM
    bidirectional region of length ``prefix_len``, the VLM image prefix) and
    an optional sliding ``window`` (recurrentgemma local attention).
    """
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    block_q = min(block_q, sq)
    block_k = min(block_k, skv)
    assert sq % block_q == 0 and skv % block_k == 0, (sq, block_q, skv, block_k)
    qg = q.reshape(b, sq, kv, g, dh)
    out, _ = _FlashAttention.apply(qg, k, v, q_positions, kv_positions, prefix_len,
                                   window, block_q, block_k, scale)
    return out.reshape(b, sq, h, dh)


def decode_attention(q, k_cache, v_cache, *, cache_len, scale: float | None = None):
    """Single-token decode attention over the full cache.

    q: (B, 1, H, Dh); caches: (B, S, KV, Dh); positions < cache_len are valid.
    """
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kv, g, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", _f32(qg), _f32(k_cache)) * scale
    valid = torch.arange(s, device=q.device) < cache_len
    scores = torch.where(valid, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", _f32(probs.to(v_cache.dtype)), _f32(v_cache))
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (params + full/decode apply)
# ---------------------------------------------------------------------------

def attention_init(generator, cfg, dtype=torch.float32, device=None, lead: tuple = ()):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device, lead=lead)
    p = {
        "wq": dense_init(generator, d, h * dh, **kw),
        "wk": dense_init(generator, d, kv * dh, **kw),
        "wv": dense_init(generator, d, kv * dh, **kw),
        "wo": dense_init(generator, h * dh, d, dtype=dtype, device=device, lead=lead),
    }
    if cfg.qk_norm:
        dev = _device(generator, device)
        p["q_norm"] = {"scale": torch.ones(lead + (dh,), dtype=dtype, device=dev)}
        p["k_norm"] = {"scale": torch.ones(lead + (dh,), dtype=dtype, device=dev)}
    return p


def _project_qkv(p, x, cfg, positions, compute_dtype):
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense_apply(p["wq"], x, compute_dtype=compute_dtype).reshape(b, s, h, dh)
    k = dense_apply(p["wk"], x, compute_dtype=compute_dtype).reshape(b, s, kv, dh)
    v = dense_apply(p["wv"], x, compute_dtype=compute_dtype).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm_apply(p["k_norm"], k, eps=cfg.norm_eps)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def attention_apply(p, x, cfg, *, positions, window=None, prefix_len: int = 0,
                    compute_dtype=None):
    """Full-sequence (train/prefill) attention. x: (B, S, D). Returns y, (k, v)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    out = chunked_attention(q, k, v, q_positions=positions, kv_positions=positions,
                            prefix_len=prefix_len, window=window,
                            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    y = dense_apply(p["wo"], out.reshape(b, s, -1), compute_dtype=compute_dtype)
    return y, (k, v)


def _write_slot(cache, new, slot: int):
    """``cache`` with ``new`` (B, 1, ...) written at sequence index ``slot``,
    out of place; the index is clamped into the cache as
    ``lax.dynamic_update_slice`` clamps it."""
    i = min(max(slot, 0), cache.shape[1] - 1)
    return torch.cat([cache[:, :i], new.to(cache.dtype), cache[:, i + 1:]], dim=1)


def attention_decode_apply(p, x, cfg, *, cache_k, cache_v, pos: int, compute_dtype=None,
                           ring: bool = False):
    """One-token decode. x: (B, 1, D); caches (B, S, KV, Dh); pos: an int.

    Returns (y, k', v'): new caches with the token's K/V written at ``pos``
    (``pos % S`` when ``ring``, for sliding-window caches), the old ones
    untouched; attention runs over the valid region.
    """
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    slot = pos % s_cache if ring else pos
    cache_k = _write_slot(cache_k, k, slot)
    cache_v = _write_slot(cache_v, v, slot)
    cache_len = min(pos + 1, s_cache) if ring else pos + 1
    out = decode_attention(q, cache_k, cache_v, cache_len=cache_len)
    y = dense_apply(p["wo"], out.reshape(b, 1, -1), compute_dtype=compute_dtype)
    return y, cache_k, cache_v
