"""The port's deploy engine held against the JAX package's, on the tiny config
(d=64, L=2, H=4, T=4, 32x32 images, B=2) with BatchNorm perturbed so that
folding is exercised.  Weights cross over through ``repro_torch.bridge``.

Logits tolerance atol 1e-4 (the reference's own plan-vs-oracle tolerance):
the GEMM and conv sums run in another order than XLA's.  Layer by layer, each
port layer is fed the reference's input spikes and its output spikes must
equal the reference's.  Tests marked ``cuda`` hold the CUDA plan against the
plain plan on the card."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.core import spikformer as tsf
from repro_torch.engine import execute as texec
from repro_torch.kernels.lif_parallel.ops import lif_parallel_fwd
from repro_torch.kernels.spike_matmul.ops import spike_matmul_fwd
from repro_torch.kernels.spiking_attention.ops import ssa_fwd
from repro_torch.launch.serve import serve_vision

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ATOL = 1e-4


def _tiny(pkg, **kw):
    return pkg.SpikformerConfig(embed_dim=64, num_layers=2, num_heads=4, t=4, **kw)


def _perturb(tree, rng):
    """Non-trivial BN running stats / affine params (fresh init folds to a
    near no-op), as the reference's engine tests perturb them."""
    if isinstance(tree, dict):
        return {k: (_perturb_leaf(k, v, rng) if not isinstance(v, dict)
                    else _perturb(v, rng)) for k, v in tree.items()}
    return tree


def _perturb_leaf(name, a, rng):
    a = np.asarray(a)
    if name == "mean":
        return a + rng.normal(0, 0.2, a.shape).astype(a.dtype)
    if name == "var":
        return a * rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
    if name == "scale":
        return a * rng.uniform(0.7, 1.3, a.shape).astype(a.dtype)
    if name == "bias":
        return a + rng.normal(0, 0.2, a.shape).astype(a.dtype)
    return a


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


def _jax_logits(ref, cfg, backend="jnp"):
    plan = ref.engine.compile_plan(ref.params, ref.state, cfg, backend=backend)
    return np.asarray(ref.engine.apply(plan, ref.images))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("residual", ["iand", "add"])
@pytest.mark.parametrize("chain_len", [1, 2, 4])
def test_plan_matches_jax_jnp_plan(ref, chain_len, residual, backend):
    kw = dict(residual=residual, chain_len=chain_len)
    want = _jax_logits(ref, _tiny(ref.sf, **kw))
    plan = engine.compile_plan(ref.params, ref.state, _tiny(tsf, **kw),
                               backend=backend, device="cpu")
    got = engine.apply(plan, ref.images)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_plan_matches_jax_pallas_kernel_plan(ref):
    from repro.engine.backend import Backend

    want = _jax_logits(ref, _tiny(ref.sf),
                       Backend("pallas", interpret=True, matmul_kernel=True))
    plan = engine.compile_plan(ref.params, ref.state, _tiny(tsf), device="cpu")
    np.testing.assert_allclose(engine.apply(plan, ref.images).numpy(), want,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("residual", ["iand", "add"])
def test_spikes_layer_by_layer_vs_jax(ref, residual):
    """Each port layer gets the reference layer's input spikes; the output
    spikes must agree exactly."""
    jplan = ref.engine.compile_plan(ref.params, ref.state, _tiny(ref.sf, residual=residual))
    tplan = engine.compile_plan(ref.params, ref.state, _tiny(tsf, residual=residual),
                                device="cpu")
    want = np.asarray(ref.exec._tokenizer_exec(jplan.meta, jplan.params["tokenizer"],
                                               ref.images))
    got = texec._tokenizer_exec(tplan.meta, tplan.params["tokenizer"],
                                torch.from_numpy(ref.images))
    np.testing.assert_array_equal(got.numpy(), want)
    for jb, tb in zip(jplan.params["blocks"], tplan.params["blocks"]):
        x = want
        want = np.asarray(ref.exec._block_exec(jplan.meta, jb, x))
        got = texec._block_exec(tplan.meta, tb, torch.tensor(x))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", [{}, {"use_kernel": True}, {"tick_fold": False},
                                     {"lif_schedule": "serial"}],
                         ids=["plain", "kernel", "per-tick", "serial"])
def test_spikformer_apply_matches_jax(ref, variant):
    want, _ = ref.sf.apply(ref.params, ref.state, ref.images, _tiny(ref.sf, **variant),
                           train=False)
    got, _ = tsf.apply(bridge.to_torch(ref.params), bridge.to_torch(ref.state),
                       torch.from_numpy(ref.images), _tiny(tsf, **variant))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_serial_schedule_plan_matches_jax(ref):
    want = _jax_logits(ref, _tiny(ref.sf, lif_schedule="serial"))
    plan = engine.compile_plan(ref.params, ref.state, _tiny(tsf, lif_schedule="serial"),
                               device="cpu")
    np.testing.assert_allclose(engine.apply(plan, ref.images).numpy(), want, atol=ATOL,
                               rtol=0)


def test_plan_matches_own_oracle():
    """The folded, fused plan equals the unfolded eval graph it was compiled
    from (the port's own deploy-vs-oracle check, no JAX involved)."""
    cfg = _tiny(tsf)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    want, _ = tsf.apply(params, state, images, cfg)
    got = engine.apply(engine.compile_plan(params, state, cfg, device="cpu"), images)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("residual", ["iand", "add"])
def test_plan_stats_match_jax(ref, residual):
    jplan = ref.engine.compile_plan(ref.params, ref.state, _tiny(ref.sf, residual=residual))
    tplan = engine.compile_plan(ref.params, ref.state, _tiny(tsf, residual=residual),
                                device="cpu")
    want, got = ref.engine.plan_stats(jplan), engine.plan_stats(tplan)
    shared = (set(want) & set(got)) - {"backend"}
    assert shared >= {"lif_dispatches", "fused_lif_iand_dispatches", "weight_reads",
                      "folded_linear_bn", "param_count"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


def test_bridge_round_trip(ref):
    back = bridge.to_numpy(bridge.to_torch(ref.params))
    assert back.keys() == ref.params.keys()
    np.testing.assert_array_equal(back["block1"]["fc2"]["lin"]["w"],
                                  ref.params["block1"]["fc2"]["lin"]["w"])


@pytest.mark.parametrize("arch", ["spike-iand-former-8-384", "spike-iand-former-8-512",
                                  "spike-iand-former-8-768", "spikformer-8-384",
                                  "spikformer-8-512", "spike-iand-former-cifar10"])
def test_every_vision_config_runs_at_reduced_depth_and_size(arch):
    """Each config's widths, heads and residual through the cuda-route plan
    (plain versions on the CPU), cut to one layer and 32x32 images."""
    from repro_torch.configs.spike_iand_former import get_vision_config

    cfg = dataclasses.replace(get_vision_config(arch), num_layers=1, img_size=32)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    plan = engine.compile_plan(params, state, cfg, device="cpu")
    logits = engine.apply(plan, torch.rand((1, 32, 32, 3)))
    assert logits.shape == (1, cfg.num_classes) and torch.isfinite(logits).all()


def test_serve_vision_cpu_backends_agree():
    kw = dict(num_requests=4, slots=2, device="cpu", verbose=False)
    plain = serve_vision("spike-iand-former_smoke", backend="torch", **kw)
    wrapped = serve_vision("spike-iand-former_smoke", backend="cuda", **kw)
    assert plain["forwards"] == wrapped["forwards"] == 3
    torch.testing.assert_close(wrapped["logits"], plain["logits"], atol=ATOL, rtol=0)


def test_lm_config_is_refused():
    """LM plans cover the spiking LM only, which carries no BN state: a
    non-spiking ``ArchConfig`` and a non-None state are refused with the JAX
    package's ``ValueError``s."""
    from repro_torch.launch.serve import spiking_lm_config
    from repro_torch.models import spiking_lm as tslm

    cfg = spiking_lm_config("llama3.2-1b_smoke")
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="spiking=False"):
        engine.compile_plan(params, None, cfg.replace(spiking=False), device="cpu")
    with pytest.raises(ValueError, match="state=None"):
        engine.compile_plan(params, {"bn": {}}, cfg, device="cpu")
    assert engine.compile_plan(params, None, cfg, device="cpu").meta.family == "lm"


@pytest.mark.cuda
def test_cuda_plan_matches_plain_plan_on_card(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny(tsf)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    plain = engine.apply(engine.compile_plan(params, state, cfg, backend="torch"), images)
    counts = [f.launches for f in (lif_parallel_fwd, spike_matmul_fwd, ssa_fwd)]
    got = engine.apply(engine.compile_plan(params, state, cfg), images)
    torch.cuda.synchronize()
    grown = [f.launches - c for f, c in zip((lif_parallel_fwd, spike_matmul_fwd, ssa_fwd),
                                            counts)]
    assert grown == [4 + 7 * 2, 3 + 6 * 2, 2]
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)


def test_live_model_perturbs_every_bn_leaf():
    """The live model's BatchNorm differs from the fresh seeded model's in
    every leaf, and nothing else of the parameters changes."""
    from repro_torch.configs.spike_iand_former import get_vision_config
    from repro_torch.launch import serve

    cfg = get_vision_config("spike-iand-former_smoke")
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    perturbed = serve._perturb_bn(params, rng), serve._perturb_bn(state, rng)

    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from (leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)])

    changed = 0
    for before, after in zip((params, state), perturbed):
        for (path, a), (_, b) in zip(leaves(before), leaves(after)):
            bn = path[-1] in ("mean", "var", "scale", "bias")
            assert torch.equal(a, b) != bn, path
            changed += bn
    assert changed > 0
    plan, images = serve.live_model("spike-iand-former_smoke", 2, "torch", torch.device("cpu"))
    assert images.shape == (2, cfg.img_size, cfg.img_size, cfg.in_channels)
