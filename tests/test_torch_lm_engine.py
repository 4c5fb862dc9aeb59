"""The port's spiking-LM deploy plans held against the JAX package's, at the
smoke width (``spiking_lm_config``-style llama3.2-1b_smoke: d=64, L=2, H=4,
Dh=16, vocab 256) with every RMSNorm gain perturbed so that folding is
exercised.  The same numpy weights and tokens go to both packages.

Tolerances: logits atol 1e-4 (the head's and the units' f32 GEMM sums run in
another order than XLA's); spikes and words equal layer by layer, each port
layer fed the JAX layer's input; the unit folds equal to JAX's (elementwise
IEEE products), the embedding fold within 8 ulps (each package's mean and
``rsqrt`` within 4 ulps of the float64 RMSNorm, see its test).

Which JAX plan is each port plan's reference (:func:`_jax_reference`): the
JAX package's own tests pin its routes and orderings to one another bit for
bit, and its plans past T = 8, quadratic or sparse, take 4-14 s each in
eager mode, so the reference is the matching JAX route and ordering at T = 1
and 8 (sparse: ``jnp+packed`` at T = 1 and the linear ``jnp+packed+sparse``
plan at T = 8), the ``jnp`` linear plan at T = 32, and the ``jnp+packed``
linear plan at T = 40 (two words).  Tests marked ``cuda`` hold the kernel
plans against the plain plans on the card."""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.core import nn as tnn
from repro_torch.core import packing as tpk
from repro_torch.data import pipeline as tdata
from repro_torch.engine import execute as texec
from repro_torch.kernels.lif_parallel.ops import lif_parallel_fwd, lif_parallel_pack_fwd
from repro_torch.kernels.spike_matmul.ops import (
    packed_spike_matmul_fwd, sparse_packed_spike_matmul_fwd, spike_matmul_fwd)
from repro_torch.kernels.spiking_attention.ops import (
    packed_ssa_fwd, sparse_packed_ssa_fwd, ssa_fwd)
from repro_torch.launch import serve as tserve
from repro_torch.models import spiking_lm as tslm
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import get_config

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ATOL = 1e-4
BATCH, SEQ = 2, 8
ROUTES = {"torch": "jnp", "torch+packed": "jnp+packed",
          "torch+packed+sparse": "jnp+packed+sparse"}
COUNTERS = {"K1": lif_parallel_fwd, "K2": spike_matmul_fwd, "K3": ssa_fwd,
            "K4": lif_parallel_pack_fwd, "K5": packed_spike_matmul_fwd, "K6": packed_ssa_fwd,
            "K8": sparse_packed_spike_matmul_fwd, "K9": sparse_packed_ssa_fwd}


def _cfg(get, t=4):
    return get("llama3.2-1b_smoke").replace(spiking=True, spike_t=t, num_heads=4,
                                            head_dim=None)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import jax

    from repro import engine as jengine
    from repro.data import pipeline as jdata
    from repro.engine import execute as jexec
    from repro.launch import serve as jserve
    from repro.models import spiking_lm as jslm
    from repro.models.lm import get_config as jget

    return SimpleNamespace(jax=jax, engine=jengine, exec=jexec, slm=jslm, get=jget,
                           data=jdata, serve=jserve)


def _perturb_gains(tree, rng):
    """Every RMSNorm gain times U(0.7, 1.3), so that the folds fold something."""
    if isinstance(tree, dict):
        return {k: (v * rng.uniform(0.7, 1.3, v.shape).astype(v.dtype) if k == "scale"
                    else _perturb_gains(v, rng)) for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def _model(t):
    """(numpy params of the JAX package's ``init_spiking_lm``, gains
    perturbed; numpy tokens (BATCH, SEQ))."""
    import jax

    from repro.models import spiking_lm as jslm
    from repro.models.lm import get_config as jget

    params = jslm.init_spiking_lm(jax.random.PRNGKey(0), _cfg(jget, t))
    params = _perturb_gains(jax.tree_util.tree_map(np.asarray, params),
                            np.random.default_rng(t))
    tokens = np.random.default_rng(100 + t).integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    return params, tokens


def _jax_reference(t, route, ordering):
    """(JAX route, ordering) of a port plan's reference (see the docstring)."""
    sparse = route.endswith("sparse")
    if t == 1:
        return ("jnp+packed" if sparse else ROUTES[route]), ordering
    if t == 8:
        return ROUTES[route], "linear" if sparse else ordering
    return ("jnp" if t == 32 else "jnp+packed"), "linear"


@functools.lru_cache(maxsize=None)
def _jax_logits(t, jroute, ordering):
    from repro import engine as jengine
    from repro.models.lm import get_config as jget

    params, tokens = _model(t)
    plan = jengine.compile_plan(params, None, _cfg(jget, t), backend=jroute, ordering=ordering)
    return np.asarray(jengine.apply(plan, tokens))


def _plan(t, backend, ordering="quadratic", params=None):
    return engine.compile_plan(_model(t)[0] if params is None else params, None,
                               _cfg(get_config, t), backend=backend, ordering=ordering,
                               device="cpu")


# -- configs and data -------------------------------------------------------------

def test_arch_config_copy_matches_reference(ref):
    fields = [f.name for f in dataclasses.fields(ArchConfig)]
    for name in ("llama3.2-1b", "llama3.2-1b_smoke"):
        for t_cfg, j_cfg in ((get_config(name), ref.get(name)),
                             (tserve.spiking_lm_config(name),
                              ref.serve.spiking_lm_config(name))):
            assert {f: getattr(t_cfg, f) for f in fields} == \
                {f: getattr(j_cfg, f) for f in fields}
            assert t_cfg.resolved_head_dim == j_cfg.resolved_head_dim
    full = tserve.spiking_lm_config("llama3.2-1b")
    assert (full.num_layers, full.d_model, full.num_heads, full.resolved_head_dim,
            full.d_ff, full.vocab_size, full.spike_t) == (16, 2048, 4, 512, 8192, 128256, 4)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("seed,step,seq,batch,shard,shards", [
    (0, 0, 32, 8, 0, 1), (3, 7, 9, 6, 1, 2), (1, 100_000, 64, 4, 0, 1)])
def test_token_batch_bit_equal_vs_jax(ref, seed, step, seq, batch, shard, shards):
    kw = dict(seed=seed, vocab_size=128256 if seed == 1 else 256, seq_len=seq,
              global_batch=batch)
    got = tdata.make_batch(tdata.DataConfig(**kw), step, shard=shard, num_shards=shards)
    want = ref.data.make_batch(ref.data.DataConfig(**kw), step, shard=shard,
                               num_shards=shards)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


# -- folds ------------------------------------------------------------------------

def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in units of the f32 spacing at ``want``."""
    spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - want) / spacing))


def test_fold_linear_rmsnorm_vs_jax(ref):
    """The folded weights and normalizer coefficients are elementwise IEEE
    products and quotients: equal to JAX's.  The folded unit's epilogue
    (``normed_linear_apply``) on the same spikes within 1e-6 of JAX's (the
    GEMM's f32 sums reordered) and of the unfolded Linear -> RMSNorm."""
    from repro.core import nn as jnn
    from repro.models.layers import rmsnorm_apply as jrms

    rng = np.random.default_rng(0)
    lin = {"w": (rng.normal(size=(48, 96)) * 48 ** -0.5).astype(np.float32)}
    norm = {"scale": (1 + 0.3 * rng.normal(size=(96,))).astype(np.float32)}
    x = (rng.random((32, 48)) > 0.5).astype(np.float32)
    got = tnn.fold_linear_rmsnorm(bridge.to_torch(lin), bridge.to_torch(norm))
    want = jnn.fold_linear_rmsnorm(lin, norm)
    for key in ("w", "nrm"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    y = tnn.normed_linear_apply(got, torch.from_numpy(x), eps=1e-6).numpy()
    np.testing.assert_allclose(y, np.asarray(jnn.normed_linear_apply(want, x, eps=1e-6)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(jrms(norm, x @ lin["w"], eps=1e-6)),
                               rtol=1e-6, atol=1e-6)


def test_embed_norm_fold_vs_jax(ref):
    """The plan's embedding table is the RMSNorm of the table's rows, and
    gathering a row of it equals normalizing the gathered row, bit for bit.
    Against JAX it is not within 1 ulp: both packages take the mean of the
    squares in their own sum order (about 1 ulp apart) and their own rsqrt
    (XLA's and PyTorch's differ by up to 2 ulps), so each table lies within 4
    ulps of the float64 RMSNorm (read: 3.4) and the two within 8 of each
    other (read: 4-5)."""
    from repro_torch.models.layers import rmsnorm_apply

    params, tokens = _model(4)
    jplan = ref.engine.compile_plan(params, None, _cfg(ref.get), backend="jnp")
    got = _plan(4, "torch").params["embed"]["table"]
    want = np.asarray(jplan.params["embed"]["table"])
    table = params["embed"]["table"].astype(np.float64)
    exact = (table / np.sqrt(np.mean(table ** 2, axis=-1, keepdims=True) + 1e-6)
             * params["embed"]["norm"]["scale"])
    assert _ulps(got.numpy(), exact) <= 4
    assert _ulps(want, exact) <= 4
    assert _ulps(got.numpy(), want) <= 8
    rows = bridge.to_torch(params["embed"]["table"])[torch.from_numpy(tokens).long()]
    assert torch.equal(got[torch.from_numpy(tokens).long()],
                       rmsnorm_apply(bridge.to_torch(params["embed"]["norm"]), rows))


# -- the plan against the JAX plan ------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
@pytest.mark.parametrize("t", [1, 8, 32, 40])
def test_lm_plan_logits_vs_jax(ref, t, ordering, route):
    """T = 40 carries each train in two words."""
    want = _jax_logits(t, *_jax_reference(t, route, ordering))
    got = engine.apply(_plan(t, route, ordering), _model(t)[1]).numpy()
    assert got.shape == (BATCH, SEQ, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
@pytest.mark.parametrize("backend,jpacked", [("cuda", False), ("cuda+packed", True)])
def test_lm_kernel_route_plan_vs_jax_pallas(ref, backend, jpacked, ordering):
    """The kernel routes (their wrappers' plain versions on the CPU) against
    the JAX package's Pallas routes with the spike GEMM and causal SSA
    kernels forced on, in interpret mode."""
    jb = ref.engine.Backend("pallas", matmul_kernel=True, packed=jpacked)
    params, tokens = _model(4)
    jplan = ref.engine.compile_plan(params, None, _cfg(ref.get), backend=jb, ordering=ordering)
    want = np.asarray(ref.engine.apply(jplan, tokens))
    got = engine.apply(_plan(4, backend, ordering), tokens).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _jax_acts(ref, params, tokens, jroute):
    """The JAX plan's embedding spikes and each block's output, one forward."""
    jplan = ref.engine.compile_plan(params, None, _cfg(ref.get), backend=jroute)
    meta, p = jplan.meta, jplan.params
    packed = meta.backend.packed
    x = ref.exec._lif(meta, ref.exec._lm_embed_drive(meta, p["embed"], tokens),
                      pack_output=packed)
    acts = [x]
    for bp in p["blocks"]:
        x = ref.exec._lm_block_exec(meta, bp, x, packed=packed)
        acts.append(x)
    return acts


@pytest.mark.parametrize("route", ["torch", "torch+packed+sparse", "cuda+packed"])
def test_lm_spikes_layer_by_layer_vs_jax(ref, route):
    """The embedding LIF's spikes and each block's output, every port block
    fed the JAX block's input: equal (words equal on packed routes, against
    the JAX ``jnp+packed`` plan's, which its sparse plan equals)."""
    params, tokens = _model(4)
    plan = _plan(4, route)
    packed = plan.backend.packed
    acts = _jax_acts(ref, params, tokens, "jnp+packed" if packed else "jnp")
    meta, p = plan.meta, plan.params

    def to_torch(a):
        if packed:
            return tpk.PackedSpikes(bridge.words_to_torch(a.words), a.t)
        return torch.from_numpy(np.array(a))

    def same(x, a):
        if packed:
            np.testing.assert_array_equal(bridge.words_to_numpy(x.words), np.asarray(a.words))
        else:
            np.testing.assert_array_equal(x.numpy(), np.asarray(a))

    with torch.inference_mode():
        x = texec._lif(meta, texec._lm_embed_drive(meta, p["embed"],
                                                    torch.from_numpy(tokens).long()),
                       pack_output=packed)
        same(x, acts[0])
        for i, bp in enumerate(p["blocks"]):
            same(texec._lm_block_exec(meta, bp, to_torch(acts[i]), packed=packed),
                 acts[i + 1])
    fired = [tpk.spike_counts(a).sum() if packed else a.sum() for a in map(to_torch, acts)]
    assert all(float(f) > 0 for f in fired)


def test_oracle_forward_vs_jax_and_plan(ref):
    """The port's oracle view (``models.spiking_lm.forward``) within atol of
    JAX's and of the port's own plan."""
    params, tokens = _model(8)
    got = tslm.forward(bridge.to_torch(params), {"tokens": tokens}, _cfg(get_config, 8))
    want = ref.slm.forward(params, {"tokens": tokens}, _cfg(ref.get, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    plan = engine.apply(_plan(8, "torch"), tokens)
    np.testing.assert_allclose(plan.numpy(), got.numpy(), rtol=0, atol=ATOL)


def test_routes_and_orderings_agree_bit_for_bit():
    """Every route and ordering computes the same spikes (exact integer
    attention; the GEMMs of every route are the same f32 products on the
    CPU), so the logits are equal."""
    tokens = _model(8)[1]
    logits = [engine.apply(_plan(8, b, o), tokens)
              for b in ("torch", "torch+packed", "torch+packed+sparse", "cuda", "cuda+packed",
                        "cuda+packed+sparse") for o in ("quadratic", "linear")]
    for x in logits[1:]:
        assert torch.equal(x, logits[0])


# -- compile_plan ---------------------------------------------------------------------

def test_compile_lm_plan_validation():
    params = _model(4)[0]
    cfg = _cfg(get_config)
    with pytest.raises(ValueError, match="spiking=False"):
        engine.compile_plan(params, None, cfg.replace(spiking=False), device="cpu")
    with pytest.raises(ValueError, match="state=None"):
        engine.compile_plan(params, {}, cfg, device="cpu")
    with pytest.raises(ValueError, match="ordering"):
        engine.compile_plan(params, None, cfg, ordering="cubic", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        engine.compile_plan(params, None, cfg, backend="cuda+dense", device="cpu")


def test_lm_plan_params_and_stats_vs_jax(ref):
    """The plan holds every block's folded units (w, nrm), the normalized
    table, the final norm and the head, and no RMSNorm gain elsewhere;
    ``plan_stats`` has the JAX package's keys and values (bundling, not
    ported, reads off)."""
    params, _ = _model(4)
    for route, jroute in (("torch", "jnp"), ("cuda+packed", "jnp+packed")):
        plan = _plan(4, route, "linear")
        jplan = ref.engine.compile_plan(params, None, _cfg(ref.get), backend=jroute,
                                        ordering="linear")
        assert set(plan.params) == {"embed", "blocks", "final_norm", "head"}
        assert len(plan.params["blocks"]) == 2
        for bp, jbp in zip(plan.params["blocks"], jplan.params["blocks"]):
            for name, unit in bp.items():
                assert set(unit) == {"w", "nrm"}
                for key in ("w", "nrm"):
                    np.testing.assert_array_equal(unit[key].numpy(), np.asarray(jbp[name][key]))
        got, want = engine.plan_stats(plan), ref.engine.plan_stats(jplan)
        assert set(got) == set(want)
        assert got.pop("backend") == route.split("+")[0]
        want.pop("backend")
        assert got == want
    assert got["lif_dispatches"] == 15 and got["decode_state_bytes"] == 4 * 4 * 16 * 16 * 4 * 2


@pytest.mark.parametrize("route", ["cuda", "cuda+packed", "cuda+packed+sparse"])
def test_lm_plan_routes_attention_through_the_kernel_wrappers(route):
    """A quadratic forward launches, per block, six GEMMs, seven LIFs and one
    SSA through the route's wrappers (their plain versions on the CPU; the
    counts grow on the card only), and the linear ordering no SSA wrapper at
    all: the counters stay put here, so the calls are recorded instead."""
    from repro_torch.kernels.lif_parallel import ops as lops
    from repro_torch.kernels.spike_matmul import ops as mops
    from repro_torch.kernels.spiking_attention import ops as sops

    calls = {}
    wrap = {"K1": (lops, "lif_parallel_fwd"), "K2": (mops, "spike_matmul_fwd"),
            "K3": (sops, "ssa_fwd"), "K4": (lops, "lif_parallel_pack_fwd"),
            "K5": (mops, "packed_spike_matmul_fwd"), "K6": (sops, "packed_ssa_fwd"),
            "K8": (mops, "sparse_packed_spike_matmul_fwd"),
            "K9": (sops, "sparse_packed_ssa_fwd")}
    saved = {k: getattr(m, n) for k, (m, n) in wrap.items()}

    def recorder(key, fn):
        def rec(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return rec

    tokens = _model(4)[1]
    try:
        for k, (m, n) in wrap.items():
            setattr(m, n, recorder(k, saved[k]))
        for ordering in ("quadratic", "linear"):
            plan = _plan(4, route, ordering)     # a sparse plan's train table runs K4 here
            calls.clear()
            engine.apply(plan, tokens)
            path = {"cuda": ("K1", "K2", "K3"), "cuda+packed": ("K4", "K5", "K6"),
                    "cuda+packed+sparse": ("K4", "K8", "K9")}[route]
            want = dict(zip(path, (1 + 7 * 2, 6 * 2, 2 if ordering == "quadratic" else 0)))
            assert calls == {k: n for k, n in want.items() if n}
    finally:
        for k, (m, n) in wrap.items():
            setattr(m, n, saved[k])


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _seeded(t=4):
    cfg = _cfg(get_config, t)
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 40)))
    return cfg, params, tokens


@pytest.mark.cuda
@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
def test_lm_kernel_routes_on_card(card, ordering):
    """The three kernel routes' logits equal one another; against the plain
    plan within atol (the tensor-core GEMM's order); every kernel of each
    route launched as often as the walk says, the others not at all."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, tokens = _seeded()
    plain = engine.apply(engine.compile_plan(params, None, cfg, backend="torch",
                                             ordering=ordering, device=card), tokens)
    got = {}
    paths = {"cuda": ("K1", "K2", "K3"), "cuda+packed": ("K4", "K5", "K6"),
             "cuda+packed+sparse": ("K4", "K8", "K9")}
    for route, path in paths.items():
        plan = engine.compile_plan(params, None, cfg, backend=route, ordering=ordering,
                                   device=card)
        before = {k: f.launches for k, f in COUNTERS.items()}
        got[route] = engine.apply(plan, tokens)
        torch.cuda.synchronize()
        grown = {k: f.launches - before[k] for k, f in COUNTERS.items()}
        want = dict.fromkeys(COUNTERS, 0)
        want.update(zip(path, (1 + 7 * 2, 6 * 2, 2 if ordering == "quadratic" else 0)))
        assert grown == want
    assert torch.equal(got["cuda+packed"], got["cuda"])
    assert torch.equal(got["cuda+packed+sparse"], got["cuda"])
    torch.testing.assert_close(got["cuda"], plain, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_lm_plan_refuses_tf32_on_card(card):
    cfg, params, tokens = _seeded()
    plan = engine.compile_plan(params, None, cfg, backend="cuda", device=card)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            engine.apply(plan, tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
