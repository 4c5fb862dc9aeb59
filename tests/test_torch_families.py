"""The family-specific layers of the port held against the JAX package (the
twin of ``tests/test_families.py`` and ``tests/test_moe_property.py``): the
MoE dispatch (against JAX's ``moe_apply`` on the same weights and the port's
dense oracle, group invariance, capacity drops, gradients against
``jax.grad``, a hypothesis property), the SSD chunked form (against JAX and
the serial recurrence), Mamba-2 and RG-LRU blocks with their decode steps
and caches, and the RG-LRU scan.

Tolerances, each with its reason (f32 throughout; sums and products of
another order than XLA's):
* MoE against JAX: rtol 1e-4 / atol 1e-5 on outputs, aux within rtol 1e-5;
  gradients within 1e-4 of each leaf's largest magnitude.  Against the dense
  oracle at ample capacity: the reference's rtol 2e-4 / atol 2e-5.
* SSD, Mamba-2 and RG-LRU against JAX: rtol/atol 1e-4 (the RG-LRU scan is a
  Hillis-Steele scan where XLA runs its associative-scan tree).  Decode
  against the full sequence: the reference's 1e-3 (state) / 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import mamba2 as tm2
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models.config import ArchConfig

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-4


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    return jax


def _moe_cfg(e=8, k=2, cf=8.0, d=32, f=16):
    return ArchConfig(name="t", family="moe", num_layers=1, d_model=d, num_heads=4,
                      num_kv_heads=2, d_ff=f, vocab_size=100, num_experts=e,
                      num_experts_per_tok=k, capacity_factor=cf)


def _jcfg(cfg):
    from repro.models.config import ArchConfig as JArchConfig
    import dataclasses
    return JArchConfig(**dataclasses.asdict(cfg))


def _cross(jx, tree):
    return bridge.to_torch(jx.tree_util.tree_map(np.asarray, tree), "cpu", None)


@pytest.fixture(scope="module")
def moe_setup(jx):
    from repro.models import moe as jmoe

    cfg = _moe_cfg()
    p = jmoe.moe_init(jx.random.PRNGKey(0), _jcfg(cfg))
    x = np.random.default_rng(1).standard_normal((4, 16, 32)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("cf,groups", [(8.0, None), (8.0, 1), (8.0, 4), (0.5, None),
                                       (0.25, 2)])
def test_moe_against_jax(jx, moe_setup, cf, groups):
    """Same weights, same tokens: outputs and aux equal JAX's, with ample
    capacity and under drops, for several groupings."""
    from repro.models import moe as jmoe

    cfg, p, x = moe_setup
    cfg = cfg.replace(capacity_factor=cf)
    want, want_aux = jmoe.moe_apply(p, x, _jcfg(cfg), num_groups=groups)
    got, got_aux = tmoe.moe_apply(_cross(jx, p), torch.from_numpy(x), cfg, num_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert tmoe._capacity(16, cfg) == jmoe._capacity(16, _jcfg(cfg))
    assert tmoe._logical_capacity(16, cfg) == jmoe._logical_capacity(16, _jcfg(cfg))


def test_moe_dense_oracle_group_invariance_and_drops(jx, moe_setup):
    from repro.models import moe as jmoe

    cfg, p, x = moe_setup
    tp, tx = _cross(jx, p), torch.from_numpy(x)
    y, aux = tmoe.moe_apply(tp, tx, cfg)
    y_ref = tmoe.moe_apply_dense(tp, tx, cfg)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(jmoe.moe_apply_dense(p, x, _jcfg(cfg))),
                               **MOE_TOL)
    assert float(aux) > 0
    y1, _ = tmoe.moe_apply(tp, tx, cfg, num_groups=1)
    y4, _ = tmoe.moe_apply(tp, tx, cfg, num_groups=4)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), rtol=1e-4, atol=1e-5)
    y_drop, _ = tmoe.moe_apply(tp, tx, cfg.replace(capacity_factor=0.5))
    assert float(torch.abs(y - y_drop).max()) > 0


def test_moe_ties_break_toward_the_lower_index():
    """Equal router probabilities pick the lower expert ids, as
    ``jax.lax.top_k`` does."""
    cfg = _moe_cfg(e=8, k=3)
    p = {"router": {"w": torch.zeros((32, 8))}}
    w, idx, _ = tmoe._route(p, torch.randn(5, 32), cfg)
    assert idx.tolist() == [[0, 1, 2]] * 5
    np.testing.assert_allclose(w.numpy(), np.full((5, 3), 1 / 3), rtol=1e-6)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_gradients_against_jax(jx, moe_setup, cf):
    """Every weight's gradient and the input's of ``sum(y) + aux`` against
    ``jax.grad`` (the dispatch gathers' backward is a scatter-add in both)."""
    from repro.models import moe as jmoe

    cfg, p, x = moe_setup
    cfg = cfg.replace(capacity_factor=cf)
    jcfg = _jcfg(cfg)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        return y.sum() + aux

    gp, gx = jx.grad(jloss, argnums=(0, 1))(p, x)
    tp = bridge.rebuild(_cross(jx, p), iter(t.requires_grad_(True)
                                             for t in bridge.leaves(_cross(jx, p))))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, cfg)
    (y.sum() + aux).backward()
    want = {**{k: np.asarray(v) for k, v in gp.items() if k != "router"},
            "router": np.asarray(gp["router"]["w"]), "x": np.asarray(gx)}
    got = {**{k: tp[k].grad.numpy() for k in ("w_gate", "w_up", "w_down")},
           "router": tp["router"]["w"].grad.numpy(), "x": tx.grad.numpy()}
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        assert float(np.abs(got[k] - w).max()) <= GRAD_REL * scale, k


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@hypothesis.settings(deadline=None, max_examples=8, derandomize=True,
                     suppress_health_check=[hypothesis.HealthCheck.too_slow])
@hypothesis.given(st.integers(0, 2**31 - 1), st.sampled_from([4, 8, 16]),
                  st.sampled_from([1, 2, 4]), st.sampled_from([1, 2, 4]))
def test_moe_property_ample_capacity_exact_and_drops_bounded(seed, e, k, b):
    """At ample capacity the sort-based dispatch equals the dense oracle for
    any expert count / top-k / batch split; under heavy drops the output
    stays finite and bounded by the undropped output's scale."""
    cfg = _moe_cfg(e=e, k=k, d=16, f=8)
    gen = torch.Generator().manual_seed(seed)
    p = tmoe.moe_init(gen, cfg)
    x = torch.randn((b, 8, 16), generator=gen)
    y, _ = tmoe.moe_apply(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), tmoe.moe_apply_dense(p, x, cfg).numpy(),
                               rtol=2e-4, atol=2e-5)
    y_drop, aux = tmoe.moe_apply(p, x, cfg.replace(capacity_factor=0.25))
    assert bool(torch.isfinite(y_drop).all()) and bool(torch.isfinite(aux))
    assert float(y_drop.abs().max()) <= float(y.abs().max()) * 4 + 1.0


# -- Mamba-2 / SSD ---------------------------------------------------------

def _ssm_cfg():
    return ArchConfig(name="m", family="ssm", num_layers=1, d_model=32, num_heads=1,
                      num_kv_heads=1, d_ff=0, vocab_size=100, ssm_state=16, ssm_head_dim=8,
                      ssm_expand=2, ssm_chunk=8, ssm_conv=4)


def test_ssd_chunked_against_jax_and_serial(jx):
    from repro.models import mamba2 as jm2

    cfg = _ssm_cfg()
    b, s, h, hd, n = 2, 64, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_neg = -np.exp(rng.standard_normal((h,)) * 0.2).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xh, dt, a_neg, bm, cm)]
    y, state = tm2.ssd_chunked(*args, chunk=8)
    want_y, want_state = jm2.ssd_chunked(xh, dt, a_neg, bm, cm, chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **TOL)
    serial = tm2.ssd_serial_ref(*args)
    np.testing.assert_allclose(y.numpy(), serial.numpy(), **TOL)
    np.testing.assert_allclose(serial.numpy(), np.asarray(jm2.ssd_serial_ref(xh, dt, a_neg, bm, cm)),
                               **TOL)


def test_ssd_gradient_finite_where_the_masked_exponent_overflows(jx):
    """At mamba2-130m's chunk of 128 with dt near 1, cum_i - cum_j of the
    masked triangle exceeds f32's exp range.  The JAX package's where after
    the exp has a NaN gradient there; the port masks the exponent, so its
    forward equals the JAX package's and its gradients equal the serial
    recurrence's."""
    import jax
    import jax.numpy as jnp

    from repro.models import mamba2 as jm2

    b, s, h, hd, n = 1, 128, 2, 4, 4
    rng = np.random.default_rng(1)
    xh = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dt = (1.0 + 0.1 * rng.standard_normal((b, s, h))).astype(np.float32)
    a_neg = -np.ones((h,), np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (xh, dt, a_neg, bm, cm)]
    y, _ = tm2.ssd_chunked(*args, chunk=s)
    want_y, _ = jm2.ssd_chunked(xh, dt, a_neg, bm, cm, chunk=s)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    jgrad = jax.grad(lambda d: jnp.sum(jm2.ssd_chunked(xh, d, a_neg, bm, cm, chunk=s)[0]))(dt)
    assert np.isnan(np.asarray(jgrad)).any()            # the reference's trap, reproduced
    grads = torch.autograd.grad(y.sum(), args)
    serial = torch.autograd.grad(tm2.ssd_serial_ref(*args).sum(), args)
    for g, want in zip(grads, serial):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_mamba2_block_and_decode_against_jax(jx):
    from repro.models import mamba2 as jm2

    cfg = _ssm_cfg()
    b, s = 2, 32
    p = jm2.mamba2_init(jx.random.PRNGKey(0), _jcfg(cfg))
    tp = _cross(jx, p)
    x = (np.random.default_rng(1).standard_normal((b, s, 32)) * 0.5).astype(np.float32)
    want, want_cache = jm2.mamba2_apply(p, x, _jcfg(cfg), return_cache=True)
    got, cache_pref = tm2.mamba2_apply(tp, torch.from_numpy(x), cfg, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("state", "conv"):
        np.testing.assert_allclose(cache_pref[k].numpy(), np.asarray(want_cache[k]), **TOL)
    cache, jcache = tm2.mamba2_cache_init(cfg, b), jm2.mamba2_cache_init(_jcfg(cfg), b)
    ys = []
    for t in range(s):
        y_t, cache = tm2.mamba2_decode_step(tp, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        jy_t, jcache = jm2.mamba2_decode_step(p, x[:, t:t + 1], jcache, _jcfg(cfg))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), **TOL)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), got.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(cache_pref["state"].numpy(), cache["state"].numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(cache_pref["conv"].numpy(), cache["conv"].numpy(),
                               rtol=1e-4, atol=1e-5)


# -- RG-LRU -----------------------------------------------------------------

def _rec_cfg(d=32):
    return ArchConfig(name="r", family="hybrid", num_layers=3, d_model=d, num_heads=4,
                      num_kv_heads=1, d_ff=64, vocab_size=100, lru_width=d, ssm_conv=4)


def test_linear_scan_equals_the_recurrence():
    gen = torch.Generator().manual_seed(0)
    for s in (1, 2, 7, 64, 100):
        a = torch.rand((2, s, 5), generator=gen)
        b = torch.randn((2, s, 5), generator=gen)
        h, want = torch.zeros(2, 5), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        np.testing.assert_allclose(trg.linear_scan(a, b).numpy(), torch.stack(want, 1).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_rglru_block_and_decode_against_jax(jx):
    from repro.models import rglru as jrg

    cfg = _rec_cfg()
    b, s = 2, 32
    p = jrg.rglru_init(jx.random.PRNGKey(0), _jcfg(cfg))
    tp = _cross(jx, p)
    x = (np.random.default_rng(1).standard_normal((b, s, 32)) * 0.5).astype(np.float32)
    want, want_cache = jrg.rglru_block_apply(p, x, _jcfg(cfg), return_cache=True)
    got, cache_pref = trg.rglru_block_apply(tp, torch.from_numpy(x), cfg, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(cache_pref[k].numpy(), np.asarray(want_cache[k]), **TOL)
    # the carried-state form (h0) of the sequence scan
    h0 = np.random.default_rng(2).standard_normal((b, 32)).astype(np.float32)
    want_h0, _ = jrg.rglru_block_apply(p, x, _jcfg(cfg), h0=h0)
    got_h0, _ = trg.rglru_block_apply(tp, torch.from_numpy(x), cfg, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(got_h0.numpy(), np.asarray(want_h0), **TOL)
    cache, jcache = trg.rglru_cache_init(cfg, b), jrg.rglru_cache_init(_jcfg(cfg), b)
    ys = []
    for t in range(s):
        y_t, cache = trg.rglru_decode_step(tp, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        jy_t, jcache = jrg.rglru_decode_step(p, x[:, t:t + 1], jcache, _jcfg(cfg))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), **TOL)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), got.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(cache_pref["h"].numpy(), cache["h"].numpy(), rtol=1e-3, atol=1e-4)


def test_rglru_decay_bounded():
    """0 <= a_t <= 1 always (log a_t = -8 softplus(lam) r_t <= 0; a_t rounds to
    1.0 in f32 where the gate r_t is ~0): the recurrence never grows, and
    stays finite on large inputs."""
    cfg = _rec_cfg(d=16)
    p = trg.rglru_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 128, 16), generator=torch.Generator().manual_seed(1)) * 10.0
    a, _ = trg._rg_lru_gates(p, x @ p["w_x"]["w"])
    assert float(a.max()) <= 1.0 and float(a.min()) >= 0.0
    y, h_last = trg.rglru_block_apply(p, x, cfg)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h_last).all())
