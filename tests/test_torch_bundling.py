"""Row bundling and the per-row train table of the port's LM plans
(``repro_torch.core.bundling``, ``compile_plan(bundle=)``), held against the
JAX package's ``core/bundling.py`` on the same weights at a tiny width (1
layer, d 32, vocab 64).  The embedding table is made to hold 10 exact
duplicate rows and 10 rows perturbed by 1e-3, so the clusters are not empty.

Words are exact: the train table and the hamming matrix equal JAX's bit for
bit (int32 words against uint32 through ``bridge``), and the clusters too.
``bundle`` picks JAX's radius and bundle count; its measured logit error is
within 1e-4 of JAX's (both are f32 logit differences).  A sparse plan's
decode step reads the train table in place of the encoding LIF and gives the
logits and state of the same plan without it, bit for bit.  Tests marked
``cuda`` hold the card's kernel route against the plain route."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.core import bundling
from repro_torch.engine import execute as texec
from repro_torch.models import spiking_lm as tslm
from repro_torch.models.lm import get_config

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

VOCAB = 64
ERR_ATOL = 1e-4


def _cfg(get):
    return get("llama3.2-1b_smoke").replace(
        spiking=True, spike_t=4, num_layers=1, d_model=32, num_heads=2, head_dim=None,
        d_ff=64, vocab_size=VOCAB)


def _with_near_duplicates(params):
    """Rows 10-19 copy rows 0-9; rows 20-29 are rows 30-39 plus N(0, 1e-3)."""
    table = np.array(params["embed"]["table"], dtype=np.float32)
    table[10:20] = table[0:10]
    noise = np.random.default_rng(0).normal(0, 1e-3, (10, table.shape[1]))
    table[20:30] = table[30:40] + noise.astype(np.float32)
    return {**params, "embed": {**params["embed"], "table": table}}


@functools.lru_cache(maxsize=None)
def _params():
    """Seeded port parameters (no JAX needed), as numpy."""
    p = tslm.init_spiking_lm(torch.Generator().manual_seed(0), _cfg(get_config))
    return _with_near_duplicates(bridge.to_numpy(p))


def _plan(backend="torch", params=None, **kw):
    return engine.compile_plan(_params() if params is None else params, None,
                               _cfg(get_config), backend=backend, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax

    from repro import engine as jengine
    from repro.core import bundling as jbundling
    from repro.models import spiking_lm as jslm
    from repro.models.lm import get_config as jget

    cfg = _cfg(jget)
    params = _with_near_duplicates(jax.tree_util.tree_map(
        np.asarray, jslm.init_spiking_lm(jax.random.PRNGKey(0), cfg)))
    return SimpleNamespace(jax=jax, engine=jengine, bundling=jbundling, cfg=cfg,
                           params=params)


def _jplan(ref, backend="jnp", **kw):
    return ref.engine.compile_plan(ref.params, None, ref.cfg, backend=backend, **kw)


@pytest.mark.parametrize("backend,jbackend", [
    ("torch", "jnp"), ("torch+packed", "jnp+packed"),
    ("torch+packed+sparse", "jnp+packed+sparse"), ("cuda+packed", "pallas+packed")])
def test_row_train_table_vs_jax(ref, backend, jbackend):
    words = bundling.row_train_table(_plan(backend, ref.params))
    want = np.asarray(ref.bundling.row_train_table(_jplan(ref, jbackend)))
    assert words.dtype == torch.int32 and tuple(words.shape) == (1, VOCAB, 32)
    np.testing.assert_array_equal(bridge.words_to_numpy(words), want)


def test_row_train_table_blocks(monkeypatch):
    """Rows run in blocks give the words of one pass (the encoding LIF is
    positionally independent)."""
    plan = _plan("torch+packed")
    whole = bundling.row_train_table(plan)
    monkeypatch.setattr(bundling, "ROW_BLOCK", 7)
    assert torch.equal(bundling.row_train_table(plan), whole)


@pytest.mark.parametrize("radius", [0, 1, 4])
def test_hamming_and_clusters_vs_jax(ref, radius):
    sigs = bundling.row_signatures(_plan("torch", ref.params))
    jsigs = ref.bundling.row_signatures(_jplan(ref))
    np.testing.assert_array_equal(bridge.words_to_numpy(sigs), np.asarray(jsigs))
    d = bundling.hamming_matrix(sigs)
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref.bundling.hamming_matrix(jsigs)))
    assert d.dtype == torch.int32 and not d.diagonal().any()
    reps = bundling.cluster_rows(sigs, radius)
    np.testing.assert_array_equal(reps.numpy(), np.asarray(ref.bundling.cluster_rows(jsigs,
                                                                                     radius)))
    assert (reps[10:20] == torch.arange(10)).all()      # exact duplicates at any radius


def test_cluster_rows_refuses_a_negative_radius():
    with pytest.raises(ValueError, match="radius"):
        bundling.cluster_rows(torch.zeros((3, 2), dtype=torch.int32), -1)


@pytest.mark.parametrize("budget,radii", [(0.0, None), (1e9, None), (1e9, (4, 1, 0)),
                                          (0.0, (4, 1, 0))])
def test_bundle_vs_jax(ref, budget, radii):
    """``bundle`` accepts JAX's radius and bundle count, its measured logit
    error within 1e-4 of JAX's, and rewrites the table as JAX does."""
    got = bundling.bundle(_plan("torch", ref.params), budget=budget, radii=radii)
    want = ref.bundling.bundle(_jplan(ref), budget=budget, radii=radii)
    info, jinfo = got.meta.bundle, want.meta.bundle
    assert (info.num_rows, info.num_bundles, info.radius, info.budget) == \
        (jinfo.num_rows, jinfo.num_bundles, jinfo.radius, jinfo.budget)
    assert info.rows_merged == jinfo.rows_merged >= 10
    assert abs(info.logit_err - jinfo.logit_err) <= ERR_ATOL
    np.testing.assert_allclose(got.params["embed"]["table"].numpy(),
                               np.asarray(want.params["embed"]["table"]), rtol=0, atol=1e-6)


def test_bundle_zero_is_exact_and_recorded(ref):
    """``compile_plan(bundle=0.0)`` merges the duplicate rows only: logits
    ``torch.equal`` the unbundled plan's, and ``plan_stats`` reads the
    record as JAX's does."""
    plain = _plan("torch", ref.params)
    bundled = _plan("torch", ref.params, bundle=0.0)
    tokens = torch.arange(VOCAB)[None]
    assert torch.equal(engine.apply(bundled, tokens), engine.apply(plain, tokens))
    stats = engine.plan_stats(bundled)
    jstats = ref.engine.plan_stats(_jplan(ref, bundle=0.0))
    keys = ("bundled", "bundle_rows_merged", "bundle_radius", "bundle_budget",
            "bundle_logit_err")
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["bundled"] and stats["bundle_radius"] == 0 and stats["bundle_logit_err"] == 0
    off = engine.plan_stats(plain)
    assert not off["bundled"] and off["bundle_rows_merged"] == 0 and off["bundle_radius"] is None


def test_bundle_validation():
    with pytest.raises(ValueError, match="budget"):
        bundling.bundle(_plan(), budget=-1.0)
    from repro_torch.core import spikformer as tsf

    vcfg = tsf.SpikformerConfig(embed_dim=32, num_layers=1, num_heads=2, t=2)
    vparams, vstate = tsf.init(torch.Generator().manual_seed(0), vcfg)
    with pytest.raises(ValueError, match="LM embedding tables only"):
        engine.compile_plan(vparams, vstate, vcfg, device="cpu", bundle=0.0)
    vplan = engine.compile_plan(vparams, vstate, vcfg, device="cpu")
    with pytest.raises(ValueError, match="LM embedding tables only"):
        bundling.bundle(vplan, budget=0.0)


def test_sparse_plan_carries_the_train_table():
    """Every sparse LM plan carries the train table, and only sparse plans;
    bundling a plan that has one re-attaches it for the rewritten table."""
    sparse = _plan("torch+packed+sparse")
    words = sparse.params["embed"]["train_words"]
    assert torch.equal(words, bundling.row_train_table(_plan("torch+packed")))
    assert "train_words" not in _plan("torch+packed").params["embed"]
    assert "train_words" not in _plan("torch").params["embed"]
    bundled = bundling.bundle(sparse, budget=1e9)
    assert torch.equal(bundled.params["embed"]["train_words"],
                       bundling.row_train_table(bundled))
    assert engine.plan_stats(sparse)["param_count"] == \
        engine.plan_stats(_plan("torch+packed"))["param_count"] + words.numel()


@pytest.mark.parametrize("backend", ["torch+packed+sparse", "cuda+packed+sparse"])
def test_decode_step_fetches_the_train(backend):
    """The sparse decode step reads each token's train from the table (one LIF
    fewer a step) and gives the logits and state of the same plan without the
    table, bit for bit; prefill still runs the encoding LIF."""
    plan = _plan(backend)
    embed = {k: v for k, v in plan.params["embed"].items() if k != "train_words"}
    bare = engine.DeployPlan(meta=plan.meta, params={**plan.params, "embed": embed})
    seq = torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB, (3, 6)))
    _, state = engine.prefill(plan, seq[:, :4])
    _, bare_state = engine.prefill(bare, seq[:, :4])
    for i in (4, 5):
        with texec.capture_spikes() as taps:
            logits, state = engine.decode_step(plan, state, seq[:, i])
        with texec.capture_spikes() as bare_taps:
            want, bare_state = engine.decode_step(bare, bare_state, seq[:, i])
        assert torch.equal(logits, want)
        for a, b in zip(state.kv, bare_state.kv):
            assert torch.equal(a, b)
        assert len(taps) == len(bare_taps) - 1 == 7
        assert all(torch.equal(a.words, b.words) for a, b in zip(taps, bare_taps[1:]))
    with texec.capture_spikes() as taps:
        engine.prefill(plan, seq)
    assert len(taps) == 8


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_bundling_on_card(card):
    """On the card: K4's train table equals the plain route's words,
    ``compile_plan(bundle=0.0)``'s logits equal the unbundled plan's, and
    ``bundle`` accepts the plain route's radius and bundle count."""
    cfg = _cfg(get_config)
    params = _params()
    plans = {b: engine.compile_plan(params, None, cfg, backend=b, device=card)
             for b in ("cuda+packed+sparse", "torch+packed+sparse")}
    assert torch.equal(plans["cuda+packed+sparse"].params["embed"]["train_words"],
                       plans["torch+packed+sparse"].params["embed"]["train_words"])
    tokens = torch.arange(VOCAB, device=card)[None]
    for b in ("cuda", "cuda+packed+sparse"):
        base = engine.compile_plan(params, None, cfg, backend=b, device=card)
        exact = engine.compile_plan(params, None, cfg, backend=b, device=card, bundle=0.0)
        assert torch.equal(engine.apply(exact, tokens), engine.apply(base, tokens))
    for budget in (0.0, 1e9):
        got = bundling.bundle(engine.compile_plan(params, None, cfg, backend="cuda",
                                                  device=card), budget=budget).meta.bundle
        want = bundling.bundle(engine.compile_plan(params, None, cfg, backend="torch",
                                                   device=card), budget=budget).meta.bundle
        assert (got.radius, got.num_bundles) == (want.radius, want.num_bundles)
