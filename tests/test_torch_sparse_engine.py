"""The port's sparse deploy plans (``torch+packed+sparse``,
``cuda+packed+sparse``) held against the JAX package's (``jnp+packed+sparse``,
and ``pallas+packed+sparse`` with the gated GEMM and SSA kernels in interpret
mode) on the tiny config (d=64, L=2, H=4, T=4, 32x32 images, B=2) with
BatchNorm perturbed, and against the port's own packed plans.

Tolerances: logits atol 1e-4 against JAX (GEMM and conv sums in another
order than XLA's); words and occupancy maps equal layer by layer, each port
layer fed the reference's input words; the sparse plan ``torch.equal`` to
the packed plan of the same kind (every skip is exact).  Tests marked
``cuda`` hold the ``cuda+packed+sparse`` plan against the packed plans on
the card."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.core import packing as tpk
from repro_torch.core import spikformer as tsf
from repro_torch.engine import analysis as tanalysis
from repro_torch.engine import backend as tbackend
from repro_torch.engine import execute as texec
from repro_torch.kernels.lif_parallel.ops import lif_parallel_fwd, lif_parallel_pack_fwd
from repro_torch.kernels.spike_matmul.ops import (
    packed_spike_matmul_fwd, sparse_packed_spike_matmul_fwd, spike_matmul_fwd)
from repro_torch.kernels.spiking_attention.ops import (
    packed_ssa_fwd, sparse_packed_ssa_fwd, ssa_fwd)
from repro_torch.launch.serve import serve_vision

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ATOL = 1e-4
COUNTERS = {"K1": lif_parallel_fwd, "K2": spike_matmul_fwd, "K3": ssa_fwd,
            "K4": lif_parallel_pack_fwd, "K5": packed_spike_matmul_fwd, "K6": packed_ssa_fwd,
            "K8": sparse_packed_spike_matmul_fwd, "K9": sparse_packed_ssa_fwd}


def _tiny(pkg, t=4, **kw):
    return pkg.SpikformerConfig(embed_dim=64, num_layers=2, num_heads=4, t=t, **kw)


def _perturb(tree, rng):
    """Non-trivial BN running stats / affine params, as the reference's
    engine tests perturb them, so that folding is exercised and the blocks
    fire."""
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
    """The JAX reference and the tiny model's numpy weights and images."""
    pytest.importorskip("jax")
    import jax

    from repro import engine as jengine
    from repro.core import spikformer as jsf
    from repro.engine import analysis as janalysis
    from repro.engine import execute as jexec
    from repro.engine.backend import Backend as JBackend

    params, state = jsf.init(jax.random.PRNGKey(0), _tiny(jsf))
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), np.random.default_rng(1))
    state = _perturb(jax.tree_util.tree_map(np.asarray, state), np.random.default_rng(2))
    images = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    return SimpleNamespace(engine=jengine, sf=jsf, exec=jexec, analysis=janalysis,
                           Backend=JBackend, params=params, state=state, images=images)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _port_plan(ref, backend, **kw):
    return engine.compile_plan(ref.params, ref.state, _tiny(tsf, **kw), backend=backend,
                               device="cpu")


def _jax_plan(ref, backend):
    return ref.engine.compile_plan(ref.params, ref.state, _tiny(ref.sf), backend=backend)


@pytest.fixture(scope="module")
def jax_sparse(ref):
    """One pass of the JAX ``jnp+packed+sparse`` plan, layer by layer as its
    ``_execute`` walks it: the packed train after the tokenizer and after
    each block, the logits, and the plan's sparsity report."""
    import functools

    import jax

    plan = _jax_plan(ref, "jnp+packed+sparse")
    tokenizer = jax.jit(functools.partial(ref.exec._tokenizer_exec_packed, plan.meta))
    block = jax.jit(functools.partial(ref.exec._block_exec_packed, plan.meta))
    layers = [tokenizer(plan.params["tokenizer"], ref.images)]
    for bparams in plan.params["blocks"]:
        layers.append(block(bparams, layers[-1]))
    logits = np.asarray(ref.exec._head_packed(plan.meta, plan.params["head"], layers[-1]))
    return SimpleNamespace(plan=plan, layers=layers, logits=logits,
                           report=ref.analysis.sparsity_report(plan, ref.images))


@pytest.mark.parametrize("backend", ["torch+packed+sparse", "cuda+packed+sparse"])
def test_sparse_plan_matches_jax_jnp_sparse_plan(ref, jax_sparse, backend):
    want = jax_sparse.logits
    got = engine.apply(_port_plan(ref, backend), ref.images)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_sparse_plan_matches_jax_pallas_sparse_kernel_plan(ref):
    """Against the JAX plan whose GEMMs and SSA run the gated Pallas kernels
    (interpret mode): the port's plans on both routes."""
    jplan = _jax_plan(ref, ref.Backend("pallas", interpret=True, matmul_kernel=True,
                                       packed=True, sparse=True))
    want = np.asarray(ref.engine.apply(jplan, ref.images))
    for backend in ("cuda+packed+sparse", "torch+packed+sparse"):
        got = engine.apply(_port_plan(ref, backend), ref.images)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["torch+packed+sparse", "cuda+packed+sparse"])
def test_sparse_words_and_maps_layer_by_layer_vs_jax(ref, jax_sparse, backend):
    """Each port layer gets the reference layer's input words (and map); the
    output words and their occupancy maps must agree exactly."""
    tplan = _port_plan(ref, backend)
    got = texec._tokenizer_exec_packed(tplan.meta, tplan.params["tokenizer"],
                                       torch.from_numpy(ref.images))
    outs = [got]
    for tb, x in zip(tplan.params["blocks"], jax_sparse.layers[:-1]):
        x = tpk.PackedSpikes(bridge.words_to_torch(np.asarray(x.words)), x.t,
                             occ=torch.from_numpy(np.asarray(x.occ).astype(np.int32)))
        outs.append(texec._block_exec_packed(tplan.meta, tb, x))
    for got, want in zip(outs, jax_sparse.layers, strict=True):
        assert got.t == want.t and got.occ is not None
        np.testing.assert_array_equal(bridge.words_to_numpy(got.words), np.asarray(want.words))
        np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ).astype(np.int32))


@pytest.mark.parametrize("sparse,packed", [("torch+packed+sparse", "torch+packed"),
                                           ("cuda+packed+sparse", "cuda+packed"),
                                           ("cuda+sparse", "cuda+packed")])
def test_sparse_plan_equals_packed_plan(ref, sparse, packed):
    """Every skip is exact: the sparse plan gives the packed plan's logits."""
    want = engine.apply(_port_plan(ref, packed), ref.images)
    assert torch.equal(engine.apply(_port_plan(ref, sparse), ref.images), want)


def test_sparse_plan_multiword_equals_packed_plan(ref):
    """T=40: two words per train; the GEMMs unpack (the kernel route takes
    the dense GEMM), LIF and SSA stay packed and gated."""
    want = engine.apply(_port_plan(ref, "cuda+packed", t=40), ref.images)
    assert torch.equal(engine.apply(_port_plan(ref, "cuda+packed+sparse", t=40), ref.images),
                       want)


def test_sparsity_report_matches_jax(ref, jax_sparse):
    want = jax_sparse.report
    got = tanalysis.sparsity_report(_port_plan(ref, "torch+packed+sparse"), ref.images)
    assert got["num_taps"] == want["num_taps"] == 4 + 7 * 2
    assert got == want
    assert 0 < got["spike_rate"] < 1 and 0 < got["occ_tile_zero_rate"] < 1
    with pytest.raises(ValueError, match="packed backend"):
        tanalysis.sparsity_report(_port_plan(ref, "torch"), ref.images)


def test_capture_spikes_taps_every_lif(ref):
    """One packed train per LIF dispatch; each carries its map exactly when
    the plan is sparse, and the blocks of the perturbed tiny model fire."""
    for backend, has_map in (("cuda+packed", False), ("cuda+packed+sparse", True)):
        with texec.capture_spikes() as taps:
            engine.apply(_port_plan(ref, backend), ref.images)
        assert len(taps) == 4 + 7 * 2
        assert all((ps.occ is not None) == has_map for ps in taps)
        assert all(tpk.spike_counts(ps).sum() > 0 for ps in taps)
    assert texec._spike_tap is None


@pytest.mark.parametrize("backend", ["torch+packed+sparse", "cuda+packed+sparse"])
def test_sparse_plan_stats_match_jax(ref, backend):
    jbackend = backend.replace("torch", "jnp").replace("cuda", "pallas")
    want = ref.engine.plan_stats(_jax_plan(ref, jbackend))
    got = engine.plan_stats(_port_plan(ref, backend))
    shared = (set(want) & set(got)) - {"backend"}
    assert {"packed", "sparse", "bits_per_spike"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["sparse"] is True and got["packed"] is True


def test_cuda_sparse_plan_never_unpacks(ref, monkeypatch):
    """On ``cuda+packed+sparse`` the words feed the gated GEMM and SSA (their
    plain versions here) directly: nothing unpacks a train tokenizer to head."""
    def boom(*a, **kw):
        raise AssertionError("packing.unpack called on the cuda+packed+sparse path")

    want = engine.apply(_port_plan(ref, "cuda+packed"), ref.images)
    monkeypatch.setattr(tpk, "unpack", boom)
    assert torch.equal(engine.apply(_port_plan(ref, "cuda+packed+sparse"), ref.images), want)


def test_backend_sparse_flag():
    be = tbackend.resolve("torch+packed+sparse")
    assert be.sparse and be.packed and not be.closes_ssa_boundary
    assert tbackend.resolve("cuda+packed+sparse").closes_ssa_boundary
    with pytest.raises(ValueError, match="requires packed"):
        engine.Backend("torch", sparse=True)


def test_serve_vision_sparse_backends(capsys):
    kw = dict(num_requests=4, slots=2, device="cpu", verbose=False)
    plain = serve_vision("spike-iand-former_smoke", backend="torch+packed", **kw)
    for backend in ("torch+packed+sparse", "cuda+packed+sparse"):
        got = serve_vision("spike-iand-former_smoke", backend=backend,
                           **{**kw, "verbose": True})
        assert got["forwards"] == 3 and torch.equal(got["logits"], plain["logits"])
        assert "sparse skipping" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 40])
def test_cuda_sparse_plan_on_card(card, t):
    """The gated kernels carry the whole path (K4/K8/K9 and neither K5 nor K6;
    at T=40, two words per train, the GEMMs unpack and take K2), and the
    logits equal the cuda+packed plan's and, within atol, the
    torch+packed+sparse plan's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tiny(tsf, t=t)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    params, state = (_perturb(bridge.to_numpy(x), rng) for x in (params, state))
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    plans = {b: engine.compile_plan(params, state, cfg, backend=b)
             for b in ("torch+packed+sparse", "cuda+packed", "cuda+packed+sparse")}
    plain = engine.apply(plans["torch+packed+sparse"], images)
    packed = engine.apply(plans["cuda+packed"], images)
    before = {k: f.launches for k, f in COUNTERS.items()}
    got = engine.apply(plans["cuda+packed+sparse"], images)
    torch.cuda.synchronize()
    grown = {k: f.launches - before[k] for k, f in COUNTERS.items()}
    gemm = {"K8": 3 + 6 * 2} if t <= 32 else {"K2": 3 + 6 * 2}
    assert grown == {**dict.fromkeys(COUNTERS, 0), "K4": 4 + 7 * 2, "K9": 2, **gemm}
    assert torch.equal(got, packed)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
