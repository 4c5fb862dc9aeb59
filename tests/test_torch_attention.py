"""The port's attention layers held against the JAX package's (the twin of
``tests/test_attention.py``): ``chunked_attention`` forward and its q/k/v
gradients against JAX's ``chunked_attention`` (its custom VJP) with no mask,
a prefix-LM region and a sliding window, at blocks 32/16, with the JAX side
at both values of its ``UNROLL_ATTN`` probe switch; the autograd Function's
saved tensors (no Sq x Skv score matrix); ``decode_attention`` against the
last row; RoPE; and the qk-norm, QKV-bias and ring-buffer decode paths of
the attention layer on the qwen3 / qwen1.5 / recurrentgemma smoke configs.

Tolerances: rtol/atol 2e-5 on forwards, 1e-4 on gradients (f32 sums of
another order than XLA's, the reference test's own bounds)."""

import math

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

B, S, H, KV, DH = 2, 128, 8, 4, 32
FWD, GRAD = dict(rtol=2e-5, atol=2e-5), dict(rtol=1e-4, atol=1e-4)
MASKS = [{}, {"prefix_len": 37}, {"window": 64}]


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 [(B, S, H, DH), (B, S, KV, DH), (B, S, KV, DH), (B, S, H, DH)])


@pytest.fixture(scope="module")
def JL():
    pytest.importorskip("jax")
    import repro.models.layers as JL
    return JL


def _port_fwd_bwd(q, k, v, do, **kwargs):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    pos = torch.arange(S, dtype=torch.int32)
    out = TL.chunked_attention(q, k, v, q_positions=pos, kv_positions=pos, block_q=32,
                               block_k=16, **kwargs)
    (out * torch.from_numpy(do)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("kwargs", MASKS, ids=["causal", "prefix37", "window64"])
@pytest.mark.parametrize("unroll", [False, True])
def test_flash_vs_jax_fwd_bwd(JL, qkv, kwargs, unroll):
    import jax
    import jax.numpy as jnp

    q, k, v, do = qkv
    pos = jnp.arange(S)
    old = JL.UNROLL_ATTN
    JL.UNROLL_ATTN = unroll
    try:
        f = lambda q, k, v: JL.chunked_attention(  # noqa: E731
            q, k, v, q_positions=pos, kv_positions=pos, block_q=32, block_k=16, **kwargs)
        want = np.asarray(f(q, k, v))
        g_want = jax.grad(lambda *a: (f(*a) * do).sum(), argnums=(0, 1, 2))(q, k, v)
    finally:
        JL.UNROLL_ATTN = old
    got, g_got = _port_fwd_bwd(q, k, v, do, **kwargs)
    np.testing.assert_allclose(got, want, **FWD)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD)


def _dense_ref(q, k, v, prefix_len=0, window=None):
    """The reference test's dense oracle, in the port's arithmetic."""
    pos = torch.arange(S)
    qg = q.reshape(B, S, KV, H // KV, DH)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(DH)
    mask = pos[None, :] <= pos[:, None]
    if prefix_len:
        mask = mask | (pos[None, :] < prefix_len)
    if window:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    p = torch.softmax(torch.where(mask, scores, -1e30), -1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, S, H, DH)


@pytest.mark.parametrize("kwargs", MASKS, ids=["causal", "prefix37", "window64"])
def test_flash_vs_dense_and_saved_tensors(qkv, kwargs):
    """Against the dense oracle in the port alone; the Function saves only
    q, k, v, the output, the lse rows and the positions -- no tensor as
    large as one (Sq x Skv) score plane of a head."""
    q, k, v, do = (torch.from_numpy(a) for a in qkv)
    saved = []
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    pos = torch.arange(S, dtype=torch.int32)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        out = TL.chunked_attention(*leaves, q_positions=pos, kv_positions=pos, block_q=32,
                                   block_k=16, **kwargs)
    assert sorted(saved) == sorted([q.reshape(B, S, KV, H // KV, DH).shape, k.shape, v.shape,
                                    (B, S, KV, H // KV, DH), (B, S, KV, H // KV),
                                    pos.shape, pos.shape])
    assert max(math.prod(s) for s in saved) < S * S * B * KV
    np.testing.assert_allclose(out.detach().numpy(), _dense_ref(q, k, v, **kwargs).numpy(), **FWD)
    (out * do).sum().backward()
    dense = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (_dense_ref(*dense, **kwargs) * do).sum().backward()
    for a, b in zip(leaves, dense):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **GRAD)


def test_decode_matches_last_row(JL, qkv):
    q, k, v, _ = qkv
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TL.decode_attention(tq[:, -1:], tk, tv, cache_len=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(JL.decode_attention(q[:, -1:], k, v,
                                                                           cache_len=S)), **FWD)
    np.testing.assert_allclose(got.numpy(), _dense_ref(tq, tk, tv)[:, -1:].numpy(), **FWD)
    # a shorter valid region
    got = TL.decode_attention(tq[:, -1:], tk, tv, cache_len=40)
    want = JL.decode_attention(q[:, -1:], k, v, cache_len=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_rope_against_jax_and_relative(JL):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    for theta, offset in ((10000.0, 0), (500_000.0, 4093)):
        pos = np.arange(6, dtype=np.int32) + offset
        got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta)
        want = JL.apply_rope(x, pos, theta=theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(TL.rope_freqs(16, 10000.0).numpy(),
                               np.asarray(JL.rope_freqs(16, 10000.0)), rtol=1e-6)
    # scores depend only on relative positions
    t = torch.from_numpy(x[:1, :4, :2])
    a = TL.apply_rope(t, torch.arange(4), theta=10000.0)
    b = TL.apply_rope(t, torch.arange(4) + 7, theta=10000.0)
    np.testing.assert_allclose(torch.einsum("bqhd,bkhd->bqk", a, a).numpy(),
                               torch.einsum("bqhd,bkhd->bqk", b, b).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-8b_smoke", "qwen1.5-4b_smoke", "recurrentgemma-9b_smoke"])
def test_attention_layer_paths(JL, arch):
    """``attention_apply`` (qk-norm, QKV bias, the local window) and
    ``attention_decode_apply`` (with the ring buffer of an ``attn_local``
    block past its window) against the JAX package's on one layer."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.models import transformer as JT

    jcfg, cfg = jlm.get_config(arch), tlm.get_config(arch)
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    layer0 = (jax.tree_util.tree_map(lambda a: a[0], params["layers"])
              if isinstance(params["layers"], dict) else params["layers"][2])
    jp = layer0["attn"]
    assert ("q_norm" in jp) == cfg.qk_norm and ("b" in jp["wq"]) == cfg.qkv_bias
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu", None)
    window = cfg.local_window if cfg.family == "hybrid" else None
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)
    want, (wk, wv) = JL.attention_apply(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                        window=window)
    got, (gk, gv) = TL.attention_apply(tp, torch.from_numpy(x), cfg,
                                       positions=torch.from_numpy(pos), window=window)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD)

    ring = window is not None
    s_cache = min(24, cfg.local_window) if ring else 24
    ck = rng.standard_normal((B, s_cache, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    for p in (5, 20, 23):
        xt = x[:, p:p + 1]
        want = JL.attention_decode_apply(jp, jnp.asarray(xt), jcfg, cache_k=jnp.asarray(ck),
                                         cache_v=jnp.asarray(cv), pos=jnp.asarray(p), ring=ring)
        got = TL.attention_decode_apply(tp, torch.from_numpy(xt), cfg,
                                        cache_k=torch.from_numpy(ck),
                                        cache_v=torch.from_numpy(cv), pos=p, ring=ring)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
