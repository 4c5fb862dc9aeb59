"""The port's packed deploy plans (``torch+packed``, ``cuda+packed``) held
against the JAX package's (``jnp+packed``, and ``pallas+packed`` with the
packed GEMM kernel in interpret mode) on the tiny config (d=64, L=2, H=4,
T=4, 32x32 images, B=2) with BatchNorm perturbed, and against the port's own
dense plans.

Tolerances: logits atol 1e-4 against JAX (GEMM and conv sums in another
order than XLA's); words equal layer by layer, each port layer fed the
reference's input words; the packed plan ``torch.equal`` to the dense plan of
the same kind (the invariant the reference pins for its own packed plan).
Tests marked ``cuda`` hold the ``cuda+packed`` plan against the plain plans
on the card."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.core import packing as tpk
from repro_torch.core import spikformer as tsf
from repro_torch.engine import backend as tbackend
from repro_torch.engine import execute as texec
from repro_torch.kernels.lif_parallel.ops import lif_parallel_fwd, lif_parallel_pack_fwd
from repro_torch.kernels.spike_matmul.ops import packed_spike_matmul_fwd, spike_matmul_fwd
from repro_torch.kernels.spiking_attention.ops import packed_ssa_fwd, ssa_fwd
from repro_torch.launch.serve import serve_vision

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ATOL = 1e-4
COUNTERS = {"K1": lif_parallel_fwd, "K2": spike_matmul_fwd, "K3": ssa_fwd,
            "K4": lif_parallel_pack_fwd, "K5": packed_spike_matmul_fwd, "K6": packed_ssa_fwd}


def _tiny(pkg, t=4, **kw):
    return pkg.SpikformerConfig(embed_dim=64, num_layers=2, num_heads=4, t=t, **kw)


def _perturb(tree, rng):
    """Non-trivial BN running stats / affine params, as the reference's
    engine tests perturb them, so that folding is exercised."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        a = np.asarray(v)
        noise = {"mean": lambda: a + rng.normal(0, 0.2, a.shape),
                 "var": lambda: a * rng.uniform(0.5, 1.5, a.shape),
                 "scale": lambda: a * rng.uniform(0.7, 1.3, a.shape),
                 "bias": lambda: a + rng.normal(0, 0.2, a.shape)}.get(k)
        out[k] = noise().astype(a.dtype) if noise else a
    return out


@pytest.fixture(scope="module")
def ref():
    """The JAX reference and the tiny model's numpy weights and images
    (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import jax

    from repro import engine as jengine
    from repro.core import spikformer as jsf
    from repro.engine import execute as jexec

    params, state = jsf.init(jax.random.PRNGKey(0), _tiny(jsf))
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), np.random.default_rng(1))
    state = _perturb(jax.tree_util.tree_map(np.asarray, state), np.random.default_rng(2))
    images = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    return SimpleNamespace(engine=jengine, sf=jsf, exec=jexec, params=params,
                           state=state, images=images)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _port_plan(ref, backend, **kw):
    return engine.compile_plan(ref.params, ref.state, _tiny(tsf, **kw), backend=backend,
                               device="cpu")


def _jax_logits(ref, backend):
    plan = ref.engine.compile_plan(ref.params, ref.state, _tiny(ref.sf), backend=backend)
    return np.asarray(ref.engine.apply(plan, ref.images))


@pytest.mark.parametrize("backend", ["torch+packed", "cuda+packed"])
def test_packed_plan_matches_jax_jnp_packed_plan(ref, backend):
    want = _jax_logits(ref, "jnp+packed")
    got = engine.apply(_port_plan(ref, backend), ref.images)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_cuda_packed_plan_matches_jax_pallas_packed_kernel_plan(ref):
    from repro.engine.backend import Backend

    want = _jax_logits(ref, Backend("pallas", interpret=True, matmul_kernel=True, packed=True))
    got = engine.apply(_port_plan(ref, "cuda+packed"), ref.images)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_packed_words_layer_by_layer_vs_jax(ref):
    """Each port layer gets the reference layer's input words; the output
    words must agree exactly (through the uint32 view)."""
    from repro.core.packing import PackedSpikes as JPacked

    jplan = ref.engine.compile_plan(ref.params, ref.state, _tiny(ref.sf), backend="jnp+packed")
    tplan = _port_plan(ref, "torch+packed")
    want = ref.exec._tokenizer_exec_packed(jplan.meta, jplan.params["tokenizer"], ref.images)
    got = texec._tokenizer_exec_packed(tplan.meta, tplan.params["tokenizer"],
                                       torch.from_numpy(ref.images))
    np.testing.assert_array_equal(bridge.words_to_numpy(got.words), np.asarray(want.words))
    for jb, tb in zip(jplan.params["blocks"], tplan.params["blocks"]):
        x = tpk.PackedSpikes(bridge.words_to_torch(np.asarray(want.words)), want.t)
        want = ref.exec._block_exec_packed(jplan.meta, jb, JPacked(want.words, want.t))
        got = texec._block_exec_packed(tplan.meta, tb, x)
        assert got.t == want.t
        np.testing.assert_array_equal(bridge.words_to_numpy(got.words), np.asarray(want.words))


@pytest.mark.parametrize("t", [4, 40])
@pytest.mark.parametrize("packed,dense", [("torch+packed", "torch"), ("cuda+packed", "cuda")])
def test_packed_plan_equals_dense_plan(ref, packed, dense, t):
    """The reference's invariant: packing the spikes changes no logit.  At
    T=40 a train takes two words, so ``cuda+packed`` unpacks before the GEMMs
    (the dense GEMM kernel's route) while LIF and SSA stay packed."""
    want = engine.apply(_port_plan(ref, dense, t=t), ref.images)
    assert torch.equal(engine.apply(_port_plan(ref, packed, t=t), ref.images), want)


def test_cuda_packed_plan_never_unpacks(ref, monkeypatch):
    """On ``cuda+packed`` the words feed the packed GEMM and SSA (their plain
    versions here) directly: nothing unpacks a train tokenizer to head."""
    def boom(*a, **kw):
        raise AssertionError("packing.unpack called on the cuda+packed path")

    want = engine.apply(_port_plan(ref, "cuda"), ref.images)
    monkeypatch.setattr(tpk, "unpack", boom)
    assert torch.equal(engine.apply(_port_plan(ref, "cuda+packed"), ref.images), want)
    with pytest.raises(AssertionError, match="unpack called"):
        engine.apply(_port_plan(ref, "torch+packed"), ref.images)


@pytest.mark.parametrize("backend", ["torch", "torch+packed", "cuda+packed"])
def test_plan_stats_match_jax(ref, backend):
    jbackend = backend.replace("torch", "jnp").replace("cuda", "pallas")
    jplan = ref.engine.compile_plan(ref.params, ref.state, _tiny(ref.sf), backend=jbackend)
    want, got = ref.engine.plan_stats(jplan), engine.plan_stats(_port_plan(ref, backend))
    shared = (set(want) & set(got)) - {"backend"}
    assert shared >= {"packed", "sparse", "bits_per_spike", "lif_dispatches",
                      "fused_lif_iand_dispatches", "weight_reads", "param_count"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["bits_per_spike"] == (8.0 if "packed" in backend else 32)


def test_resolve_specs():
    assert tbackend.resolve("cuda+packed") == engine.Backend("cuda", packed=True)
    assert tbackend.resolve("torch+packed").closes_ssa_boundary is False
    assert tbackend.resolve("cuda+packed").closes_ssa_boundary is True
    assert tbackend.resolve("cuda").closes_ssa_boundary is False
    assert tbackend.resolve("cuda+packed+sparse") == engine.Backend("cuda", packed=True,
                                                                    sparse=True)
    assert tbackend.resolve("cuda+sparse") == engine.Backend("cuda", packed=True, sparse=True)
    with pytest.raises(ValueError, match="requires packed"):
        engine.Backend("cuda", sparse=True)
    for bad in ("cuda+pakced", "cuda+", "+packed", "cuda++packed"):
        with pytest.raises(ValueError):
            tbackend.resolve(bad)
    with pytest.raises(ValueError, match="kind"):
        tbackend.resolve("pallas+packed")
    with pytest.raises(TypeError):
        tbackend.resolve(3)


def test_compile_plan_rejects_packed_add_residual():
    cfg = tsf.SpikformerConfig(embed_dim=16, num_layers=1, num_heads=2, residual="add")
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    for backend in ("torch+packed", "cuda+packed"):
        with pytest.raises(ValueError, match="residual='iand'"):
            engine.compile_plan(params, state, cfg, backend=backend, device="cpu")


@pytest.mark.parametrize("arch", ["spike-iand-former-8-384", "spike-iand-former-8-512",
                                  "spike-iand-former-8-768", "spike-iand-former-cifar10"])
def test_every_iand_config_runs_packed_at_reduced_depth_and_size(arch):
    """Each IAND config's widths and heads through the cuda+packed plan (plain
    versions on the CPU), cut to one layer and 32x32 images, equal to its
    dense plan."""
    from repro_torch.configs.spike_iand_former import get_vision_config

    cfg = dataclasses.replace(get_vision_config(arch), num_layers=1, img_size=32)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    images = torch.rand((1, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    got = engine.apply(engine.compile_plan(params, state, cfg, backend="cuda+packed",
                                           device="cpu"), images)
    want = engine.apply(engine.compile_plan(params, state, cfg, device="cpu"), images)
    assert got.shape == (1, cfg.num_classes) and torch.equal(got, want)


def test_serve_vision_packed_backends(capsys):
    kw = dict(num_requests=4, slots=2, device="cpu")
    plain = serve_vision("spike-iand-former_smoke", backend="torch", verbose=False, **kw)
    for backend in ("torch+packed", "cuda+packed"):
        got = serve_vision("spike-iand-former_smoke", backend=backend, **kw)
        assert got["forwards"] == 3 and torch.equal(got["logits"], plain["logits"])
        assert "packed spikes" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 40])
def test_cuda_packed_plan_on_card(card, t):
    """The packed kernels carry the whole path (K4/K5/K6 and no dense kernel;
    at T=40, two words per train, the GEMMs unpack and take K2), and the
    logits equal the dense CUDA plan's and the torch+packed plan's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tiny(tsf, t=t)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    plain = engine.apply(engine.compile_plan(params, state, cfg, backend="torch+packed"),
                         images)
    dense = engine.apply(engine.compile_plan(params, state, cfg, backend="cuda"), images)
    before = {k: f.launches for k, f in COUNTERS.items()}
    got = engine.apply(engine.compile_plan(params, state, cfg, backend="cuda+packed"), images)
    torch.cuda.synchronize()
    grown = {k: f.launches - before[k] for k, f in COUNTERS.items()}
    gemm = "K5" if t <= 32 else "K2"
    assert grown == {"K1": 0, "K2": 0, "K3": 0, "K4": 4 + 7 * 2, "K5": 0, "K6": 2,
                     gemm: 3 + 6 * 2}
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
    assert torch.equal(got, dense)
