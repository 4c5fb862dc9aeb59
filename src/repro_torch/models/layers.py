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

Tensor parallelism.  With ``tp`` (a :class:`TensorParallel`: this rank's
``data`` and ``model`` axes of a host mesh and one block's sanitized specs)
the attention and MLP layers run on this rank's weight shards, Megatron's
way: ``wq``/``wk``/``wv``/``up``/``gate`` column-parallel over ``model``,
``wo``/``down`` row-parallel with a psum over ``model``, every ``data``
(FSDP) dim of a weight all-gathered before use.  A column shard must hold
whole heads; where the model axis does not divide the q (or kv) heads the
layer gathers that weight over ``model`` and computes those heads on every
rank alike.  A value every rank holds alike enters a rank-specific
computation through ``MeshAxis.copy`` (Megatron's f), so its gradient stays
whole on every rank.  Decode attention runs against the sequence-sharded
cache (``tp.seq``): each model rank scores every head against its ``S/M``
positions and the partial softmaxes meet in a max and two psums over
``model``; the new token's k/v go only to the rank that owns ``pos``
(``pos % W`` for a sliding window's W-slot ring, whose slots are cut over
``model`` the same way).  The MoE, Mamba-2 and RG-LRU layers take the same
``tp`` (their modules say how each is cut).  Under rules that cut no heads
or ffn over ``model`` (``fsdp``, ``zero2``) ``tp.model`` is an axis of size
1, so every layer runs whole on the rank's own rows, its weights gathered
whole (``TensorParallel.weight``) and the cache's sequence whole.  With
``tp=None`` every layer is the single-device code, op for op.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

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


@dataclass(frozen=True)
class TensorParallel:
    """One rank's place in a block's SPMD: the ``data`` (FSDP) and
    ``model`` (tensor-parallel) axes (``launch.mesh.MeshAxis``; ``model`` an
    axis of size 1 where the rules cut no heads or ffn over the mesh's
    ``model`` axis), ``specs`` (the block's parameter specs sanitized on the
    mesh, no layer dim), which parts run split over ``model``: ``q_split``
    (whole q heads on each rank), ``kv_split`` (whole kv heads too) and
    ``mlp_split`` (the d_ff columns), ``batch``, the axes the batch is cut
    over (the MoE's load statistics are summed over them), ``seq``, the axis
    the decode cache's sequence is cut over (``model``, or an axis of size
    1), ``expert_split`` (the MoE's experts cut over ``data``, where its
    spec cuts them: expert parallelism) and ``stored``: the mesh's
    ``model`` axis where the weights are stored cut over it but no tensor
    parallelism uses it (the ``fsdp`` rules), over which every weight is
    gathered whole."""

    data: Any
    model: Any
    specs: dict
    q_split: bool
    kv_split: bool
    mlp_split: bool
    batch: tuple = ()
    seq: Any = None
    expert_split: bool = True
    stored: Any = None

    def split(self, spec, dim: int, axis: str = "model") -> bool:
        """Whether a sanitized ``spec`` cuts ``dim`` over ``axis`` (of size
        above 1): whether the leaf holds a block of that dim."""
        ax = self.model if axis == "model" else self.data
        return ax.size > 1 and dim < len(spec) and spec[dim] == axis

    def weight(self, w, spec, *, full: bool = False):
        """A weight shard ready to use: gathered over ``data`` where its spec
        shards it (backward: a reduce-scatter of the data ranks' partial
        gradients) and over ``stored`` (backward: a reduce-scatter, its ranks
        hold other rows of the batch), and with ``full`` over ``model`` too
        (its use is the same on every model rank, backward: this rank's
        block)."""
        for dim, entry in enumerate(spec):
            if entry == "data":
                w = self.data.all_gather(w, dim, kind="weight")
            elif entry == "model" and self.stored is not None:
                w = self.stored.all_gather(w, dim, kind="weight")
        if full:
            for dim, entry in enumerate(spec):
                if entry == "model":
                    w = self.model.all_gather(w, dim, kind="weight", replicated=True)
        return w

    def dense(self, p, spec, *, full: bool = False):
        """:meth:`weight` over a tree of parameters and its specs."""
        if isinstance(p, dict):
            return {k: self.dense(v, spec[k], full=full) for k, v in p.items()}
        return self.weight(p, spec, full=full)

    def shared(self, p):
        """A replicated parameter (a norm scale) used on this rank's heads
        only: its gradient is summed over ``model``."""
        return {k: self.model.copy(v) for k, v in p.items()}


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


def mlp_apply(p, x: torch.Tensor, *, act: str, compute_dtype=None,
              tp: TensorParallel | None = None) -> torch.Tensor:
    if tp is not None:
        return _mlp_apply_tp(p, x, act=act, compute_dtype=compute_dtype, tp=tp)
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


def _mlp_apply_tp(p, x, *, act, compute_dtype, tp: TensorParallel):
    """Column-parallel up/gate, row-parallel down with a psum over
    ``model``; the whole MLP on every rank where ``model`` does not divide
    d_ff."""
    split, sp = tp.mlp_split, tp.specs["mlp"]
    w = {k: tp.dense(p[k], sp[k], full=not split) for k in p}
    xs = tp.model.copy(x) if split else x
    y = mlp_apply(w, xs, act=act, compute_dtype=compute_dtype)
    return tp.model.all_reduce(y) if split else y


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


def _heads_for(k, h0: int, hl: int, g: int):
    """The kv heads of ``k`` (B, S, KV, Dh) that q heads ``h0 .. h0+hl`` read,
    laid out so that q head ``h0 + j`` groups onto kv head ``j // g'``: a
    slice when the q heads cover whole groups or lie in one, else one kv head
    per q head."""
    if h0 % g == 0 and hl % g == 0:
        return k[:, :, h0 // g:(h0 + hl) // g]
    if h0 // g == (h0 + hl - 1) // g:
        return k[:, :, h0 // g:h0 // g + 1]
    idx = torch.div(torch.arange(h0, h0 + hl, device=k.device), g, rounding_mode="floor")
    return k[:, :, idx]


def _project_qkv_tp(p, x, cfg, positions, compute_dtype, tp: TensorParallel):
    """This rank's q heads and the kv heads it computes: split over
    ``model`` where ``tp`` says, whole (weights gathered) elsewhere."""
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m, sp = tp.model.size, tp.specs["attn"]
    hl = h // m if tp.q_split else h
    kvl = kv // m if tp.kv_split else kv
    xs = tp.model.copy(x) if tp.q_split else x
    q = dense_apply(tp.dense(p["wq"], sp["wq"], full=not tp.q_split), xs,
                    compute_dtype=compute_dtype).reshape(b, s, hl, dh)
    k = dense_apply(tp.dense(p["wk"], sp["wk"], full=not tp.kv_split),
                    xs if tp.kv_split else x, compute_dtype=compute_dtype).reshape(b, s, kvl, dh)
    v = dense_apply(tp.dense(p["wv"], sp["wv"], full=not tp.kv_split),
                    xs if tp.kv_split else x, compute_dtype=compute_dtype).reshape(b, s, kvl, dh)
    if cfg.qk_norm:
        q = rmsnorm_apply(tp.shared(p["q_norm"]) if tp.q_split else p["q_norm"], q,
                          eps=cfg.norm_eps)
        k = rmsnorm_apply(tp.shared(p["k_norm"]) if tp.kv_split else p["k_norm"], k,
                          eps=cfg.norm_eps)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _out_proj_tp(p, o, tp: TensorParallel, compute_dtype, *, heads_local: bool):
    """``wo`` on the attention output (B, S, H * Dh, or this rank's heads when
    ``heads_local``): row-parallel with a psum over ``model`` where ``model``
    divides its rows (an output of every head enters through this rank's
    block of it)."""
    spec = tp.specs["attn"]["wo"]
    if not tp.split(spec["w"], 0):
        return dense_apply(tp.dense(p["wo"], spec, full=True), o, compute_dtype=compute_dtype)
    if not heads_local:
        o = tp.model.block(tp.model.copy(o), -1)
    return tp.model.all_reduce(dense_apply(tp.dense(p["wo"], spec), o,
                                           compute_dtype=compute_dtype))


def attention_apply(p, x, cfg, *, positions, window=None, prefix_len: int = 0,
                    compute_dtype=None, tp: TensorParallel | None = None):
    """Full-sequence (train/prefill) attention. x: (B, S, D). Returns y, (k, v):
    under ``tp``, the kv heads this rank computed."""
    if tp is not None:
        return _attention_apply_tp(p, x, cfg, positions=positions, window=window,
                                   prefix_len=prefix_len, compute_dtype=compute_dtype, tp=tp)
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    out = chunked_attention(q, k, v, q_positions=positions, kv_positions=positions,
                            prefix_len=prefix_len, window=window,
                            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    y = dense_apply(p["wo"], out.reshape(b, s, -1), compute_dtype=compute_dtype)
    return y, (k, v)


def _attention_apply_tp(p, x, cfg, *, positions, window, prefix_len, compute_dtype,
                        tp: TensorParallel):
    b, s, _ = x.shape
    q, k, v = _project_qkv_tp(p, x, cfg, positions, compute_dtype, tp)
    ka, va = k, v
    if tp.q_split and not tp.kv_split:
        # the kv heads are whole on every rank; this rank's q heads read some
        g, hl = cfg.num_heads // cfg.num_kv_heads, q.shape[2]
        h0 = tp.model.rank * hl
        ka = _heads_for(tp.model.copy(k), h0, hl, g)
        va = _heads_for(tp.model.copy(v), h0, hl, g)
    out = chunked_attention(q, ka, va, q_positions=positions, kv_positions=positions,
                            prefix_len=prefix_len, window=window,
                            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    y = _out_proj_tp(p, out.reshape(b, s, -1), tp, compute_dtype, heads_local=tp.q_split)
    return y, (k, v)


def _write_slot(cache, new, slot: int):
    """``cache`` with ``new`` (B, 1, ...) written at sequence index ``slot``,
    out of place; the index is clamped into the cache as
    ``lax.dynamic_update_slice`` clamps it."""
    i = min(max(slot, 0), cache.shape[1] - 1)
    return torch.cat([cache[:, :i], new.to(cache.dtype), cache[:, i + 1:]], dim=1)


def decode_attention_sharded(q, k_cache, v_cache, *, cache_len, offset: int, model,
                             scale: float | None = None):
    """:func:`decode_attention` over a cache sharded along the sequence over
    ``model``: this rank holds positions ``offset .. offset + S_local``.  The
    scores of every head against those positions, their max over ``model``,
    the softmax's sum as a psum, and the probabilities times v as another:
    the single-device softmax, its sums in another order."""
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kv, g, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", _f32(qg), _f32(k_cache)) * scale
    valid = torch.arange(offset, offset + s, device=q.device) < cache_len
    scores = torch.where(valid, scores, _NEG_INF)
    top = model.all_reduce(scores.amax(dim=-1, keepdim=True), op="max", kind="state")
    e = torch.exp(scores - top)
    probs = e / model.all_reduce(e.sum(dim=-1, keepdim=True), kind="state")
    out = torch.einsum("bhgs,bshd->bhgd", _f32(probs.to(v_cache.dtype)), _f32(v_cache))
    out = model.all_reduce(out, kind="state")
    return out.reshape(b, 1, h, dh).to(q.dtype)


def attention_decode_apply(p, x, cfg, *, cache_k, cache_v, pos: int, compute_dtype=None,
                           ring: bool = False, tp: TensorParallel | None = None):
    """One-token decode. x: (B, 1, D); caches (B, S, KV, Dh); pos: an int.

    Returns (y, k', v'): new caches with the token's K/V written at ``pos``
    (``pos % S`` when ``ring``, for sliding-window caches), the old ones
    untouched; attention runs over the valid region.  Under ``tp`` the
    caches are this rank's block of the sequence (B, S/M, KV, Dh), of a
    cache (or ring) of S = M x S/M positions.
    """
    if tp is not None:
        return _attention_decode_tp(p, x, cfg, cache_k=cache_k, cache_v=cache_v, pos=pos,
                                    compute_dtype=compute_dtype, ring=ring, tp=tp)
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


def _attention_decode_tp(p, x, cfg, *, cache_k, cache_v, pos, compute_dtype, ring, tp):
    b = x.shape[0]
    model, seq = tp.model, tp.seq
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv_tp(p, x, cfg, positions, compute_dtype, tp)
    # every rank scores all heads against its positions: gather the heads
    if tp.q_split:
        q = model.all_gather(q, 2, kind="state", replicated=True)
    if tp.kv_split:
        k = model.all_gather(k, 2, kind="state", replicated=True)
        v = model.all_gather(v, 2, kind="state", replicated=True)
    s_local = cache_k.shape[1]
    s_cache = s_local * seq.size
    if ring:    # the ring's slot; once it is full every slot is valid
        slot, cache_len = pos % s_cache, min(pos + 1, s_cache)
    else:       # clamped as on one device
        slot, cache_len = min(max(pos, 0), s_cache - 1), pos + 1
    owner, offset = slot // s_local, seq.rank * s_local
    if seq.rank == owner:
        cache_k = _write_slot(cache_k, k, slot - offset)
        cache_v = _write_slot(cache_v, v, slot - offset)
    if seq.size == 1:
        out = decode_attention(q, cache_k, cache_v, cache_len=cache_len)
    else:
        out = decode_attention_sharded(q, cache_k, cache_v, cache_len=cache_len, offset=offset,
                                       model=seq)
    y = _out_proj_tp(p, out.reshape(b, 1, -1), tp, compute_dtype, heads_local=False)
    return y, cache_k, cache_v
