"""The graph checks of ``engine/analysis.py`` (the JAX package's
``analysis.py:42-92``): ``op_histogram``, ``op_dims`` (``jaxpr_dims``),
``bn_op_count`` and ``rmsnorm_op_count`` on the graph of one recorded call,
and the structural claims they hold -- no BatchNorm in a folded vision plan,
no RMSNorm layer in a folded LM plan, a decode step and a prefill chunk flat
in the prompt length -- on every route, at the smoke widths, each with a
negative case that must fail: the reference's own versions of these tests
fail on this JAX (``jax.core.ClosedJaxpr`` is gone), so nothing else holds
them.  Prompt lengths 24 and 37 collide with no model dim (the reference's
choice).  Tests marked ``cuda`` also hold the hand-kernel launches the
recorder sees on the card."""

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.core import spikformer as tsf
from repro_torch.engine import analysis
from repro_torch.kernels import _build
from repro_torch.models import spiking_lm as tslm
from repro_torch.models.lm import get_config

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

VISION_ROUTES = ("torch", "cuda", "torch+packed", "cuda+packed", "torch+packed+sparse",
                 "cuda+packed+sparse")
LM_ROUTES = ("torch", "cuda", "torch+packed", "cuda+packed+sparse")
SHORT, LONG, CHUNK = 24, 37, 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _vision(device="cpu"):
    cfg = tsf.SpikformerConfig(embed_dim=64, num_layers=2, num_heads=4, t=4)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg, device=device)
    img = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32, 3), np.float32))
    return cfg, params, state, img.to(device)


def _lm_cfg(layers=2, heads=4, t=4, d_model=64):
    return get_config("llama3.2-1b_smoke").replace(
        spiking=True, spike_t=t, num_heads=heads, head_dim=None, num_layers=layers,
        d_model=d_model, d_ff=2 * d_model, vocab_size=256)


def _tokens(s, seed=0, device="cpu"):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (1, s))).to(device)


def test_recorder_sees_ops_regions_and_reported_launches():
    x = torch.ones((3, 4))
    with analysis.OpRecorder() as rec:
        with torch.profiler.record_function("rmsnorm_apply"):
            torch.rsqrt(x)
        _build.report_launch("ssa_fwd", x, None, torch.zeros((2, 5, 7)))
    names = [n for n, _ in rec.ops]
    assert names[0] == "region.rmsnorm_apply"
    assert "aten.rsqrt.default" in names
    assert rec.ops[-1] == ("kernel.ssa_fwd", ((3, 4), (2, 5, 7)))
    _build.report_launch("ssa_fwd", x)           # no recorder active: nothing happens
    assert analysis.op_dims(lambda a: a.sum(), torch.zeros((11, 13))) >= {11, 13}


@pytest.mark.parametrize("backend", VISION_ROUTES)
def test_no_bn_in_the_folded_vision_graph(backend):
    """A compiled plan computes no BN (0 BN-signature ops); the model's own
    graph in either mode computes one per BN layer (the negative case)."""
    cfg, params, state, img = _vision()
    plan = engine.compile_plan(params, state, cfg, backend=backend, device="cpu")
    assert analysis.bn_op_count(engine.make_apply_fn(plan), plan.params, img) == 0
    n_bn = 4 + 6 * cfg.num_layers
    for train in (True, False):
        assert analysis.bn_op_count(
            lambda p, s, x: tsf.apply(p, s, x, cfg, train=train)[0], params, state, img) == n_bn


@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
@pytest.mark.parametrize("backend", LM_ROUTES)
def test_no_rmsnorm_layer_in_the_lm_plan(backend, ordering):
    """The folded LM plan applies no RMSNorm layer; the oracle forward applies
    6 per block (its blocks run in a Python loop, so each counts, against
    the reference's 6 once under its layer scan) plus embed and final."""
    cfg = _lm_cfg()
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(1), cfg)
    plan = engine.compile_plan(params, None, cfg, backend=backend, ordering=ordering,
                               device="cpu")
    assert analysis.rmsnorm_op_count(engine.make_apply_fn(plan), plan.params, _tokens(8)) == 0
    oracle = lambda p, tk: tslm.forward(p, {"tokens": tk}, cfg, ordering=ordering)
    assert analysis.rmsnorm_op_count(oracle, params, _tokens(8)) == 6 * cfg.num_layers + 2


@pytest.mark.parametrize("layers,heads,t", [(1, 2, 1), (3, 4, 8), (2, 2, 32)])
def test_no_rmsnorm_layer_over_lm_geometry(layers, heads, t):
    """The reference's property test over LM geometry, as a sweep."""
    cfg = _lm_cfg(layers=layers, heads=heads, t=t, d_model=16 * heads)
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(layers), cfg)
    for backend in ("torch", "cuda+packed"):
        plan = engine.compile_plan(params, None, cfg, backend=backend, device="cpu")
        assert analysis.rmsnorm_op_count(engine.make_apply_fn(plan), plan.params,
                                         _tokens(8)) == 0


@pytest.mark.parametrize("backend", LM_ROUTES)
def test_decode_step_flat_in_prefix_length(backend):
    """The decode step's graph (op histogram and axis lengths) is the same
    after prefixes of 8 and 24 tokens, and holds no 24-axis; the full
    re-scoring forward does (the negative case)."""
    cfg = _lm_cfg()
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(2), cfg)
    plan = engine.compile_plan(params, None, cfg, backend=backend, ordering="linear",
                               device="cpu")
    step = engine.make_decode_step_fn(plan)
    tok = _tokens(1, seed=5)[:, 0]
    hists, dims = [], []
    for s in (8, SHORT):
        _, state = engine.prefill(plan, _tokens(s))
        hists.append(analysis.op_histogram(step, plan.params, state, tok))
        dims.append(analysis.op_dims(step, plan.params, state, tok))
    assert hists[0] == hists[1] and dims[0] == dims[1]
    assert SHORT not in dims[1]
    assert SHORT in analysis.op_dims(engine.make_apply_fn(plan), plan.params, _tokens(SHORT))


@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
@pytest.mark.parametrize("backend", LM_ROUTES)
def test_prefill_chunk_flat_in_prompt_length(backend, ordering):
    """A 5-token chunk after a 37-token prefix: its graph holds the chunk's
    axis and none of the prompt's."""
    cfg = _lm_cfg()
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(3), cfg)
    plan = engine.compile_plan(params, None, cfg, backend=backend, ordering=ordering,
                               device="cpu")
    _, state = engine.prefill(plan, _tokens(LONG))
    dims = analysis.op_dims(engine.make_prefill_chunk_fn(plan), plan.params, state,
                            _tokens(CHUNK, seed=6))
    assert CHUNK in dims and LONG not in dims
    assert int(state.pos) == LONG


@pytest.mark.cuda
def test_recorder_sees_the_hand_kernels_on_card(card):
    """On the card the kernels launch through ctypes; the wrappers report each
    launch, so a decode step's graph holds every one of them."""
    from repro_torch.kernels.lif_parallel.ops import lif_parallel_pack_fwd
    from repro_torch.kernels.spike_matmul.ops import packed_spike_matmul_fwd

    cfg = _lm_cfg()
    params = tslm.init_spiking_lm(torch.Generator(card).manual_seed(4), cfg)
    plan = engine.compile_plan(params, None, cfg, backend="cuda+packed", device=card)
    _, state = engine.prefill(plan, _tokens(SHORT, device=card))
    step = engine.make_decode_step_fn(plan)
    tok = _tokens(1, seed=5, device=card)[:, 0]
    before = lif_parallel_pack_fwd.launches, packed_spike_matmul_fwd.launches
    hist = analysis.op_histogram(step, plan.params, state, tok)
    counts = (lif_parallel_pack_fwd.launches - before[0],
              packed_spike_matmul_fwd.launches - before[1])
    assert counts == (1 + 7 * cfg.num_layers, 6 * cfg.num_layers)
    assert (hist["kernel.lif_parallel_pack_fwd"], hist["kernel.packed_spike_matmul_fwd"]) == counts
    assert SHORT not in analysis.op_dims(step, plan.params, state, tok)
    assert analysis.rmsnorm_op_count(engine.make_apply_fn(plan), plan.params,
                                     _tokens(8, device=card)) == 0
