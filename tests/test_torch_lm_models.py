"""The generic LM families of the port held against the JAX package at the
smoke configs' widths (the twin of ``tests/test_models_smoke.py``): for each
of the ten assigned archs, the JAX package's ``init_lm(PRNGKey(0))`` weights
cross through ``bridge`` with their own dtypes, and both packages run the
same numpy inputs (batch 2 x 32, made from a seed).

Tolerances, each with its reason (the smoke configs compute in f32; the
port's sums run in another order than XLA's):
* ``forward`` and ``make_prefill_step`` logits, the prefill cache, one
  ``make_serve_step`` from a given cache (JAX's after three decode steps):
  rtol/atol 1e-4.
* ``loss_fn``: the loss within rtol 1e-5; each gradient leaf within 1e-4 of
  that leaf's largest magnitude.
* one ``make_train_step`` with AdamW (``warmup_steps=0``, so the parameters
  move): the loss within rtol 1e-5, and the parameters after the step within
  1e-5 wherever the clipped gradient exceeds ``ADAM_WELL_POSED`` 1e-6 in
  magnitude.  AdamW's first step is lr * g / (|g| + 1e-8): there it is
  within 1% of +-lr and set by the gradient's sign.  Where |g| <= 1e-6 the
  step turns on rounding noise (the k-projection bias's gradient is zero but
  for rounding, since the softmax ignores a constant added to a row of
  scores), and those elements are held within lr * (1 + weight decay * |p|)
  of the JAX package's, the most one AdamW step moves them apart.
* token-by-token decode from a fresh cache against the full forward, in the
  port alone: the reference's 2e-3.
* bf16 compute (``compute_dtype="bfloat16"``, the full configs' setting).
  Every output and cache leaf has the JAX package's dtype.  The layers
  without a transcendental function (``_logits`` and one attention layer's
  ``attention_apply`` / ``attention_decode_apply``: dense, RMSNorm, RoPE, the
  flash tiles, the cache write) agree with the JAX package's bit for bit but
  on at most ``BF16_FLIPS`` 2% of the elements (0-1.3% measured), and no
  element is further off than one bf16 ulp at the leaf's largest magnitude,
  ``BF16_ULP`` 2^-7 of it (2^-10 measured): an f32 sum in another order
  rounds to the neighbouring bf16 value, and an attention projection
  carries that one-ulp flip on.  A cast the JAX package does not make, or
  one it makes that the port skips, moves far more elements.  The whole
  model in bf16 is held only within a relative mean error of
  ``BF16_REL_MEAN`` 5% per leaf (at most 1.8% measured): XLA's CPU bf16
  ``logistic`` and tanh-``gelu`` round otherwise than torch's (a quarter to
  a third of a SiLU's outputs differ by an ulp), so the port's gap to the
  JAX package in bf16 is as large as the JAX package's own f32-to-bf16 gap,
  and no whole-model bound can tell a cast fault from that noise; the
  dtypes and the layer checks do.
"""

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as TT
from repro_torch.optim.optimizer import OptimizerConfig as TOptConfig
from repro_torch.optim.optimizer import make_optimizer as t_make_optimizer

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

B, S = 2, 32
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL, LOSS_RTOL, STEP_ATOL, DECODE_TOL = 1e-4, 1e-5, 1e-5, 2e-3
ADAM_WELL_POSED = 1e-6
BF16_ULP, BF16_FLIPS, BF16_REL_MEAN = 2.0 ** -7, 0.02, 0.05


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.modality == "text":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.modality == "audio_stub":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    p = cfg.num_prefix_tokens
    return {"image_embeds": rng.standard_normal((B, p, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S - p)).astype(np.int32)}


def _step_batches(cfg, steps, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio_stub":
        return [{"embeds": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)}
                for _ in range(steps)]
    return [{"token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)}
            for _ in range(steps)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree) -> dict:
    return dict(flatten_with_names(tree))


def _assert_tree_close(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k].float() if isinstance(g[k], torch.Tensor)
                                              else g[k], dtype=np.float32),
                                   np.asarray(w[k], dtype=np.float32), err_msg=k, **tol)


class _Ref:
    """One arch's JAX side: config, weights (numpy) and a jitted step each."""

    def __init__(self, arch):
        import jax

        from repro.models import lm as jlm
        from repro.models import transformer as JT

        self.jax, self.jlm, self.JT = jax, jlm, JT
        self.cfg = jlm.get_config(arch + "_smoke")
        self.tcfg = tlm.get_config(arch + "_smoke")
        self.params = JT.init_lm(jax.random.PRNGKey(0), self.cfg)
        self.np_params = jax.tree_util.tree_map(np.asarray, self.params)
        self._vg = {}

    def torch_params(self):
        return bridge.to_torch(self.np_params, "cpu", None)

    def value_and_grad(self, seed):
        """JAX's ``value_and_grad(loss_fn)`` on ``_batch(cfg, seed)``: loss,
        metrics and the gradients as numpy arrays by tree path (memoised)."""
        if seed not in self._vg:
            import jax.numpy as jnp

            fn = self.jax.jit(self.jax.value_and_grad(
                lambda p, b: self.jlm.loss_fn(p, b, self.cfg), has_aux=True))
            batch = {k: jnp.asarray(v) for k, v in _batch(self.cfg, seed).items()}
            (loss, m), g = fn(self.params, batch)
            self._vg[seed] = (float(loss), {k: float(v) for k, v in m.items()},
                              _flat(self.jax.tree_util.tree_map(np.asarray, g)))
        return self._vg[seed]


@pytest.fixture(scope="module", params=ASSIGNED_ARCHS)
def ref(request):
    pytest.importorskip("jax")
    return _Ref(request.param)


def test_forward_prefill_and_serve_step(ref):
    import jax.numpy as jnp

    jax, jlm, JT = ref.jax, ref.jlm, ref.JT
    cfg, tcfg = ref.cfg, ref.tcfg
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = ref.torch_params()

    want, want_aux, _ = jax.jit(lambda p, b: JT.forward(p, b, cfg))(ref.params, jb)
    got, got_aux, _ = TT.forward(tp, _t(batch), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)

    want_last, want_cache = jax.jit(jlm.make_prefill_step(cfg))(ref.params, jb)
    got_last, got_cache = tlm.make_prefill_step(tcfg)(tp, _t(batch))
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **TOL)
    _assert_tree_close(got_cache, jax.tree_util.tree_map(np.asarray, want_cache), **TOL)

    # one serve step from a given cache: JAX's after three decode steps
    jstep = jax.jit(jlm.make_serve_step(cfg))
    cache = JT.cache_init(cfg, B, S)
    steps = _step_batches(cfg, 4)
    for t, sb in enumerate(steps[:3]):
        _, cache = jstep(ref.params, cache, {k: jnp.asarray(v) for k, v in sb.items()},
                         jnp.asarray(t))
    tcache = bridge.to_torch(jax.tree_util.tree_map(np.asarray, cache), "cpu", None)
    want_l, want_c = jstep(ref.params, cache, {k: jnp.asarray(v) for k, v in steps[3].items()},
                           jnp.asarray(3))
    got_l, got_c = tlm.make_serve_step(tcfg)(tp, tcache, _t(steps[3]), 3)
    assert got_l.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    _assert_tree_close(got_c, jax.tree_util.tree_map(np.asarray, want_c), **TOL)
    # functional caches: the given cache is untouched
    _assert_tree_close(tcache, jax.tree_util.tree_map(np.asarray, cache), rtol=0, atol=0)


def _bf16_pairs(got, want):
    """(name, port tensor, JAX array) leaf by leaf, with the dtypes equal."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert str(g[k].dtype).removeprefix("torch.") == str(w[k].dtype), (k, g[k].dtype, w[k].dtype)
        yield k, g[k].float().numpy(), np.asarray(w[k], dtype=np.float32)


def _assert_bf16_ulp(got, want):
    """Equal bit for bit but on at most ``BF16_FLIPS`` of the elements, and
    none further apart than one bf16 ulp at the leaf's largest magnitude."""
    for k, g, w in _bf16_pairs(got, want):
        err = np.abs(g - w)
        assert float(err.max()) <= BF16_ULP * float(np.abs(w).max()), (k, float(err.max()))
        assert np.mean(err > 0) <= BF16_FLIPS, (k, float(np.mean(err > 0)))


def _assert_bf16_rel_mean(got, want):
    for k, g, w in _bf16_pairs(got, want):
        rel = float(np.abs(g - w).mean() / max(float(np.abs(w).mean()), 1e-30))
        assert rel <= BF16_REL_MEAN, (k, rel)


def test_bf16_compute_against_jax(ref):
    """The ten archs with ``compute_dtype="bfloat16"`` on the same weights:
    the whole model (forward, prefill, one serve step from JAX's cache)
    and, bit for bit but for one-ulp flips, ``_logits`` and the first
    attention layer (full sequence and one decode step)."""
    import jax.numpy as jnp

    from repro.models import layers as JL

    from repro_torch.models import layers as TL

    jax, jlm, JT = ref.jax, ref.jlm, ref.JT
    cfg = ref.cfg.replace(compute_dtype="bfloat16")
    tcfg = ref.tcfg.replace(compute_dtype="bfloat16")
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = ref.torch_params()
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    want = jax.jit(lambda p, b: JT.forward(p, b, cfg)[0])(ref.params, jb)
    got = TT.forward(tp, _t(batch), tcfg)[0]
    _assert_bf16_rel_mean(got, np.asarray(want))
    # the prefill's logits are the forward's last row (its values are held
    # above, over every row: two rows alone would swing with a router tie)
    got_last, got_cache = tlm.make_prefill_step(tcfg)(tp, _t(batch))
    assert torch.equal(got_last, got[:, -1:])
    _assert_bf16_rel_mean(got_cache, np_tree(jax.jit(jlm.make_prefill_step(cfg))(ref.params, jb)[1]))
    jstep = jax.jit(jlm.make_serve_step(cfg))
    cache = JT.cache_init(cfg, B, S)
    steps = _step_batches(cfg, 4)
    for t, sb in enumerate(steps[:3]):
        _, cache = jstep(ref.params, cache, {k: jnp.asarray(v) for k, v in sb.items()},
                         jnp.asarray(t))
    want = jstep(ref.params, cache, {k: jnp.asarray(v) for k, v in steps[3].items()},
                 jnp.asarray(3))
    got = tlm.make_serve_step(tcfg)(tp, bridge.to_torch(np_tree(cache), "cpu", None),
                                    _t(steps[3]), 3)
    _assert_bf16_rel_mean(got, np_tree(want))

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), jnp.bfloat16)
    tx = bridge.to_torch(np.asarray(x), "cpu", None)
    _assert_bf16_ulp(TT._logits(tp, tx, tcfg),
                     np.asarray(jax.jit(lambda p, x: JT._logits(p, x, cfg))(ref.params, x)))
    layers = ref.params["layers"]
    if isinstance(layers, dict):
        jl, tl = jax.tree_util.tree_map(lambda a: a[0], layers), bridge.layer_params(tp["layers"], 0)
    else:
        i = next((i for i, lp in enumerate(layers) if "attn" in lp), None)
        if i is None:
            return                                        # mamba2: no attention layer
        jl, tl = layers[i], tp["layers"][i]
    if "attn" not in jl:
        return
    window = cfg.local_window if cfg.family == "hybrid" else None
    pos = np.arange(S, dtype=np.int32)
    cd = dict(compute_dtype=jnp.bfloat16)
    want = jax.jit(lambda p, x: JL.attention_apply(p, x, cfg, positions=jnp.asarray(pos),
                                                   window=window, **cd))(jl["attn"], x)
    got = TL.attention_apply(tl["attn"], tx, tcfg, positions=torch.from_numpy(pos),
                             window=window, compute_dtype=torch.bfloat16)
    _assert_bf16_ulp(got, np_tree(want))
    ck = jnp.asarray(rng.standard_normal(want[1][0].shape), jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal(ck.shape), jnp.bfloat16)
    ring = window is not None
    want = jax.jit(lambda p, x, ck, cv: JL.attention_decode_apply(
        p, x, cfg, cache_k=ck, cache_v=cv, pos=jnp.asarray(20), ring=ring, **cd))(
        jl["attn"], x[:, 20:21], ck, cv)
    got = TL.attention_decode_apply(tl["attn"], tx[:, 20:21], tcfg,
                                    cache_k=bridge.to_torch(np.asarray(ck), "cpu", None),
                                    cache_v=bridge.to_torch(np.asarray(cv), "cpu", None),
                                    pos=20, ring=ring, compute_dtype=torch.bfloat16)
    _assert_bf16_ulp(got, np_tree(want))


def test_loss_and_every_gradient_leaf(ref):
    batch = _batch(ref.cfg, seed=3)
    want, want_m, w = ref.value_and_grad(3)
    (got, got_m), got_g = tlm.value_and_grad(ref.torch_params(), _t(batch), ref.tcfg)
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(got_m[key]), want_m[key], rtol=LOSS_RTOL, atol=1e-7)
    g = _flat(got_g)
    assert g.keys() == w.keys()
    for k in w:
        scale = float(np.abs(w[k]).max())
        err = float(np.abs(g[k].numpy() - w[k]).max())
        assert err <= GRAD_REL * max(scale, 1e-30), (k, err, scale)


def test_one_adamw_train_step(ref):
    import jax.numpy as jnp

    from repro.optim.optimizer import OptimizerConfig, make_optimizer

    jax, jlm = ref.jax, ref.jlm
    cfg, tcfg = ref.cfg, ref.tcfg
    batch = _batch(cfg, seed=3)
    ocfg = dict(total_steps=10, warmup_steps=0)
    jopt, topt = make_optimizer(OptimizerConfig(**ocfg)), t_make_optimizer(TOptConfig(**ocfg))
    jstate = {"params": ref.params, "opt_state": jopt.init(ref.params),
              "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jax.jit(jlm.make_train_step(cfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = ref.torch_params()
    tstate = {"params": tp, "opt_state": topt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    tstate, tm = tlm.make_train_step(tcfg, topt)(tstate, _t(batch))
    assert int(tstate["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _, _, grads = ref.value_and_grad(3)
    clip = min(1.0, TOptConfig().clip_norm / float(jm["grad_norm"]))
    lr, wd = TOptConfig().lr, TOptConfig().weight_decay
    got, want, before = (_flat(tstate["params"]),
                         _flat(jax.tree_util.tree_map(np.asarray, jstate["params"])),
                         _flat(ref.np_params))
    assert got.keys() == want.keys() == grads.keys()
    for k in want:
        err = np.abs(got[k].numpy() - want[k])
        posed = np.abs(grads[k]) * clip > ADAM_WELL_POSED
        assert float(err[posed].max(initial=0.0)) <= STEP_ATOL, k
        noisy = lr * (1 + wd * np.abs(before[k])) + STEP_ATOL
        assert np.all(err[~posed] <= noisy[~posed]), k
    moved = [not torch.equal(a, b) for a, b in zip(bridge.leaves(tp),
                                                    bridge.leaves(tstate["params"]))]
    assert any(moved)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m", "recurrentgemma-9b"])
def test_decode_matches_forward(arch):
    """Token-by-token decode from a fresh cache reproduces the full forward
    (cache correctness across the attention, SSM and hybrid families)."""
    cfg = tlm.get_config(arch + "_smoke")
    params = TT.init_lm(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 16)))
    full, _, _ = TT.forward(params, {"tokens": tokens}, cfg)
    cache = TT.cache_init(cfg, B, 16, device="cpu")
    step = tlm.make_serve_step(cfg)
    outs = []
    for t in range(16):
        logits, cache = step(params, cache, {"token": tokens[:, t:t + 1]}, t)
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.detach().numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
