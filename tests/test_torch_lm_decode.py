"""Incremental decode of the port's spiking-LM plans: the causal linear
ordering's running K^T V state, prefill, resumable prefill chunks, the decode
step and synchronous serving, at the smoke width (llama3.2-1b_smoke, d=64,
L=2, H=4, Dh=16).

On binary spikes every attention contraction is exact integer arithmetic in
f32, and everything outside the attention acts per token, so on the CPU the
decode is held bit for bit (``torch.equal``): prefill plus k steps against
the full forward on the extended sequence, chunked prefill against one-shot
prefill, in logits and state (at batch 1 the logits within atol 1e-4: see
``test_prefill_plus_steps_one_sequence``), and the ``DecodeState`` and the
SSA functions against the JAX package's.  Serving against JAX's ``serve_spiking_lm`` with
the same weights and prompts is teacher-forced on JAX's stream: the port's
argmax must agree wherever JAX's top-2 margin exceeds the logits tolerance
(atol 1e-4; the head's f32 sums run in another order than XLA's).  Tests
marked ``cuda`` hold the same on the card."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.core import packing as tpk
from repro_torch.core import spiking_attention as tsa
from repro_torch.data import pipeline as tdata
from repro_torch.engine import execute as texec
from repro_torch.launch import serve as tserve
from repro_torch.models import spiking_lm as tslm
from repro_torch.models.lm import get_config

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ATOL = 1e-4
ROUTES = ("torch", "torch+packed", "torch+packed+sparse", "cuda+packed+sparse")


def _cfg(get, t=4):
    return get("llama3.2-1b_smoke").replace(spiking=True, spike_t=t, num_heads=4,
                                            head_dim=None)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import jax

    from repro import engine as jengine
    from repro.core import spiking_attention as jsa
    from repro.launch import serve as jserve
    from repro.models import spiking_lm as jslm
    from repro.models.lm import get_config as jget

    return SimpleNamespace(jax=jax, engine=jengine, sa=jsa, serve=jserve, slm=jslm, get=jget)


@functools.lru_cache(maxsize=None)
def _params(t=4):
    """Seeded port parameters of the smoke model (no JAX needed)."""
    return tslm.init_spiking_lm(torch.Generator().manual_seed(t), _cfg(get_config, t))


def _plan(backend, ordering="quadratic", t=4, params=None):
    return engine.compile_plan(_params(t) if params is None else params, None,
                               _cfg(get_config, t), backend=backend, ordering=ordering,
                               device="cpu")


def _tokens(b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (b, s)))


def _same_state(a, b):
    assert len(a.kv) == len(b.kv)
    for x, y in zip(a.kv, b.kv):
        assert torch.equal(x, y)
    assert int(a.pos) == int(b.pos)


def _spikes(rng, shape):
    return (rng.random(shape) > 0.5).astype(np.float32)


# -- the SSA functions of decode against JAX's -------------------------------------------

@pytest.mark.parametrize("t", [4, 40])
def test_decode_step_functions_vs_jax(ref, t):
    """``ssa_linear_decode_step`` and its packed and word-gated forms on
    random spikes: state and drive equal to JAX's (T = 40: two words, where
    the gated step can zero a k word plane)."""
    rng = np.random.default_rng(t)
    state = rng.integers(0, 9, (t, 2, 3, 8, 8)).astype(np.float32)
    q, k, v = (_spikes(rng, (t, 2, 3, 1, 8)) for _ in range(3))
    if t > 32:
        v[32:] = 0                    # the second word plane of v is silent
    words = [tpk.pack(torch.from_numpy(x)).words for x in (q, k, v)]
    jwords = [bridge.words_to_numpy(w) for w in words]
    want_s, want_o = ref.sa.ssa_linear_decode_step(state, q, k, v, scale=0.125)
    cases = {
        "dense": tsa.ssa_linear_decode_step(torch.from_numpy(state), *map(torch.from_numpy,
                                                                           (q, k, v))),
        "packed": tsa.ssa_linear_decode_step_packed(torch.from_numpy(state), *words, t=t),
        "sparse": tsa.ssa_linear_decode_step_packed_sparse(torch.from_numpy(state), *words,
                                                           t=t)}
    jsparse = ref.sa.ssa_linear_decode_step_packed_sparse(state, *jwords, t=t)
    for name, (got_s, got_o) in cases.items():
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s), err_msg=name)
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o), err_msg=name)
    np.testing.assert_array_equal(cases["sparse"][0].numpy(), np.asarray(jsparse[0]))
    if t > 32:
        assert not tsa._or_bits(words[2])[1].any()


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_causal_linear_with_state_vs_jax(ref, chunk):
    """The causal scan's drive and final carry (dense and on words, seeded
    with an earlier state), the state read and the prefix state: equal to
    JAX's, at a ragged length (13 tokens)."""
    rng = np.random.default_rng(chunk)
    t, shape = 4, (4, 2, 2, 13, 8)
    q, k, v = (_spikes(rng, shape) for _ in range(3))
    s0 = rng.integers(0, 5, (t, 2, 2, 8, 8)).astype(np.float32)
    jd, js = ref.sa.ssa_causal_linear_with_state(q, k, v, chunk=chunk, state=s0)
    d, s = tsa.ssa_causal_linear_with_state(*map(torch.from_numpy, (q, k, v)), chunk=chunk,
                                            state=torch.from_numpy(s0))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    words = [tpk.pack(torch.from_numpy(x)).words for x in (q, k, v)]
    dp, sp = tsa.ssa_causal_linear_with_state_packed(*words, t=t, chunk=chunk,
                                                     state=torch.from_numpy(s0))
    jdp, jsp = ref.sa.ssa_causal_linear_with_state_packed(
        *map(bridge.words_to_numpy, words), t=t, chunk=chunk, state=s0)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(jdp))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    assert torch.equal(dp, d) and torch.equal(sp, s)
    read = tsa.ssa_state_read_packed(torch.from_numpy(s0), words[0], t=t)
    np.testing.assert_array_equal(read.numpy(), np.asarray(ref.sa.ssa_state_read(s0, q)))
    full = tsa.ssa(*map(torch.from_numpy, (q, k, v)), ordering="linear", causal=True,
                   chunk=chunk)
    np.testing.assert_array_equal(full.numpy(), np.asarray(
        ref.sa.ssa(q, k, v, ordering="linear", causal=True, chunk=chunk)))
    assert torch.equal(full, tsa.ssa(*map(torch.from_numpy, (q, k, v)), causal=True))
    padded, n = tsa._pad_words_s(words[0], 8)
    assert n == 13 and padded.shape[3] == 16 and not padded[:, :, :, 13:].any()


def test_decode_state_vs_jax(ref):
    """The port's prefill on the JAX weights gives JAX's ``DecodeState`` bit
    for bit (both orderings, dense and packed), and one step after it too."""
    jcfg = _cfg(ref.get)
    params = ref.jax.tree_util.tree_map(np.asarray,
                                        ref.slm.init_spiking_lm(ref.jax.random.PRNGKey(3), jcfg))
    tokens = np.asarray(_tokens(2, 7, seed=3)).astype(np.int32)
    nxt = np.array([5, 250], np.int32)
    for route, jroute, ordering in (("torch", "jnp", "quadratic"),
                                    ("torch+packed", "jnp+packed", "linear")):
        jplan = ref.engine.compile_plan(params, None, jcfg, backend=jroute, ordering=ordering)
        _, jstate = ref.jax.jit(ref.engine.make_prefill_fn(jplan))(jplan.params, tokens)
        _, jstate2 = ref.jax.jit(ref.engine.make_decode_step_fn(jplan))(jplan.params, jstate,
                                                                        nxt)
        plan = _plan(route, ordering, params=params)
        _, state = engine.prefill(plan, tokens)
        _, state2 = engine.decode_step(plan, state, nxt)
        for got, want in ((state, jstate), (state2, jstate2)):
            assert len(got.kv) == len(want.kv) == 2
            for x, y in zip(got.kv, want.kv):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert int(got.pos) == int(want.pos)
        assert state.kv[0].shape == plan.meta.decode.state_shapes(2)[0] == (4, 2, 4, 16, 16)


# -- exactness of incremental decode ---------------------------------------------------

@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
@pytest.mark.parametrize("route", ROUTES)
def test_prefill_plus_steps_equals_full_forward(route, ordering):
    """Prefill on 9 tokens plus 4 decode steps: each step's logits and the
    final state equal the full forward and the prefill on all 13 tokens."""
    plan = _plan(route, ordering)
    seq = _tokens(2, 13, seed=1)
    full = engine.apply(plan, seq)
    logits, state = engine.prefill(plan, seq[:, :9])
    assert torch.equal(logits, full[:, :9])
    for i in range(9, 13):
        step_logits, state = engine.decode_step(plan, state, seq[:, i])
        assert torch.equal(step_logits, full[:, i])
    _, whole = engine.prefill(plan, seq)
    _same_state(state, whole)


@pytest.mark.parametrize("t", [1, 40])
def test_prefill_plus_steps_at_other_time_steps(t):
    plan = _plan("torch+packed", "linear", t=t)
    seq = _tokens(2, 6, seed=t)
    full = engine.apply(plan, seq)
    _, state = engine.prefill(plan, seq[:, :3])
    for i in range(3, 6):
        step_logits, state = engine.decode_step(plan, state, seq[:, i])
        assert torch.equal(step_logits, full[:, i])


@pytest.mark.parametrize("t", [1, 4, 40])
def test_prefill_plus_steps_one_sequence(t):
    """At batch 1 the spikes and the state are still exact, but the CPU's
    BLAS runs the decode step's one-row head product as a matrix-vector
    product, whose f32 sums run in another order than the full forward's
    matrix product: the step's logits differ from the full forward's by a
    few ulps (read: 2-5e-7), within atol 1e-4."""
    plan = _plan("torch+packed", "linear", t=t)
    seq = _tokens(1, 6, seed=t)
    full = engine.apply(plan, seq)
    _, state = engine.prefill(plan, seq[:, :3])
    for i in range(3, 6):
        step_logits, state = engine.decode_step(plan, state, seq[:, i])
        torch.testing.assert_close(step_logits, full[:, i], rtol=0, atol=ATOL)
    _, whole = engine.prefill(plan, seq)
    _same_state(state, whole)


@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("chunks", [(1,) * 11, (3, 3, 3, 2), (5, 1, 4, 1)])
def test_chunked_prefill_equals_one_shot(route, ordering, chunks):
    """Chunks of 1, of 3 and ragged: the chunks' logits concatenate to the
    one-shot prefill's and the final state equals its state."""
    plan = _plan(route, ordering)
    seq = _tokens(2, 11, seed=2)
    want, want_state = engine.prefill(plan, seq)
    state, got, start = texec.decode_state_init(plan.meta, 2), [], 0
    for c in chunks:
        logits, state = engine.prefill_chunk(plan, state, seq[:, start:start + c])
        got.append(logits)
        start += c
    assert torch.equal(torch.cat(got, dim=1), want)
    _same_state(state, want_state)


def test_decode_entry_and_validation():
    plan = _plan("torch")
    entry = plan.meta.decode
    assert entry.state_bytes(3) == 3 * 2 * 4 * 4 * 16 * 16 * 4
    assert entry.max_slots(entry.state_bytes(5) + 1) == 5
    full = tserve.spiking_lm_config("llama3.2-1b")
    assert engine.DecodeEntry(full.num_layers, 4, 4, 512).state_bytes(1) == 268_435_456
    state = texec.decode_state_init(plan.meta, 2)
    short = engine.DecodeState(kv=state.kv[:1], pos=state.pos)
    with pytest.raises(ValueError, match="layer states"):
        engine.decode_step(plan, short, torch.tensor([1, 2]))
    from repro_torch.configs.spike_iand_former import get_vision_config
    from repro_torch.core import spikformer as tsf

    vcfg = get_vision_config("spike-iand-former_smoke")
    vplan = engine.compile_plan(*tsf.init(torch.Generator().manual_seed(0), vcfg), vcfg,
                                device="cpu")
    assert vplan.meta.decode is None
    with pytest.raises(ValueError, match="LM-plan mode"):
        engine.make_decode_step_fn(vplan)


def test_decode_does_not_change_its_input_state():
    plan = _plan("torch+packed")
    _, state = engine.prefill(plan, _tokens(1, 5))
    before = [x.clone() for x in state.kv]
    engine.decode_step(plan, state, torch.tensor([7]))
    assert all(torch.equal(a, b) for a, b in zip(before, state.kv))


# -- serving ---------------------------------------------------------------------------

def test_serve_spiking_lm_plain_routes_agree():
    """``serve_spiking_lm`` on the three plain routes: the same weights (one
    seed), the same prompts, equal greedy streams and logits."""
    runs = {b: tserve.serve_spiking_lm("llama3.2-1b_smoke", num_requests=3, prompt_len=6,
                                       max_new=4, slots=2, backend=b, device="cpu",
                                       verbose=False)
            for b in ("torch", "torch+packed", "torch+packed+sparse")}
    base = runs["torch"]
    assert [i for i, _ in base["done"]] == [0, 1, 2]
    assert base["tokens"].shape == (3, 4) and base["logits"].shape == (3, 4, 256)
    assert base["prefills"] == 2 + 2 and base["steps"] == 2 + 2 * 3
    for r in runs.values():
        assert torch.equal(r["tokens"], base["tokens"])
        assert torch.equal(r["logits"], base["logits"])
        for (i, a), (j, b) in zip(r["done"], base["done"]):
            assert i == j and np.array_equal(a, b)
    assert torch.equal(base["tokens"], base["logits"].argmax(-1))


def test_serve_spiking_lm_teacher_forced_vs_jax(ref):
    """JAX's ``serve_spiking_lm`` (its weights from its seed) against the port
    plan on the same weights and prompts, teacher-forced on JAX's stream: at
    every position where JAX's top-2 margin exceeds the tolerance, the
    port's argmax is JAX's token."""
    n, s, new, seed = 3, 6, 5, 0
    done = ref.serve.serve_spiking_lm("llama3.2-1b_smoke", num_requests=n, prompt_len=s,
                                      max_new=new, slots=2, backend="jnp", seed=seed,
                                      verbose=False)
    jstream = np.stack([g for _, g in done])
    jcfg = ref.serve.spiking_lm_config("llama3.2-1b_smoke")
    params = ref.jax.tree_util.tree_map(
        np.asarray, ref.slm.init_spiking_lm(ref.jax.random.PRNGKey(seed), jcfg))
    prompts = tdata.make_batch(tdata.DataConfig(seed=seed, vocab_size=256, seq_len=s,
                                                global_batch=n), 0)["tokens"]
    seq = np.concatenate([prompts, jstream], axis=1)
    jplan = ref.engine.compile_plan(params, None, jcfg, backend="jnp")
    jlogits = np.asarray(ref.jax.jit(ref.engine.make_apply_fn(jplan))(jplan.params, seq))
    jlogits = jlogits[:, s - 1:s - 1 + new]
    plan = engine.compile_plan(params, None, tserve.spiking_lm_config("llama3.2-1b_smoke"),
                               backend="torch", device="cpu")
    logits, state = engine.prefill(plan, prompts)
    got = [logits[:, -1]]
    for i in range(new - 1):
        step_logits, state = engine.decode_step(plan, state, torch.from_numpy(jstream[:, i]))
        got.append(step_logits)
    got = torch.stack(got, dim=1).numpy()
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > ATOL
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[decided], jstream[decided])
    np.testing.assert_allclose(got, jlogits, rtol=0, atol=ATOL)


def test_serve_helpers_vs_jax(ref):
    assert tserve._warm_sizes(4, 8) == ref.serve._warm_sizes(4, 8) == {4}
    assert tserve._warm_sizes(4, 10) == ref.serve._warm_sizes(4, 10) == {4, 2}
    assert tserve._warm_sizes(4, 3) == ref.serve._warm_sizes(4, 3) == {3}
    x = np.arange(10).reshape(5, 2)
    got, b = tserve._pad_batch(torch.from_numpy(x), 4)
    want, jb = ref.serve._pad_batch(x, 4)
    assert b == jb == 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = np.random.default_rng(0).normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_array_equal(tserve.greedy_sample(torch.from_numpy(logits)).numpy(),
                                  np.asarray(ref.serve.greedy_sample(logits)))


def test_mesh_serve_helpers_vs_jax(ref):
    """``parse_mesh``, the padded warm shapes and the elastic mesh of a
    one-process fleet, as the JAX package's on one device."""
    for spec in ("2x1", "1X2", (2, 2), None):
        assert tserve.parse_mesh(spec) == ref.serve.parse_mesh(spec)
    for slots, n, d in ((4, 7, 2), (4, 3, 2), (3, 7, 2), (4, 8, 1)):
        assert tserve._warm_padded_sizes(slots, n, d) == ref.serve._warm_padded_sizes(slots, n, d)
    assert tserve._elastic_mesh((2, 2), 8, verbose=False) == ((1, 1), 8)
    assert tserve._elastic_mesh((1, 1), 8, verbose=False) == ((1, 1), 8)


def test_serve_spiking_lm_refuses_a_mesh_and_a_missing_card(monkeypatch):
    """A malformed mesh spec is refused (a well-formed one serves: see
    ``test_serve_spiking_lm_on_a_mesh``), and so is a missing card."""
    with pytest.raises(ValueError):
        tserve.serve_spiking_lm("llama3.2-1b_smoke", num_requests=1, prompt_len=2,
                                max_new=1, mesh="2by1", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.serve_spiking_lm("llama3.2-1b_smoke", num_requests=1, prompt_len=2,
                                max_new=1)


def _serve_on_mesh(rank):
    """One rank of the 2-rank world: ``serve_spiking_lm`` on meshes 2x1 (7
    requests in slots of 4: the ragged batch padded to the data degree) and
    1x2 beside the same call with ``mesh=None``, and the head-sharded
    prefill + steps of a 1x2 plan against the single-device plan."""
    kw = dict(num_requests=7, prompt_len=4, max_new=3, slots=4, backend="torch+packed",
              ordering="linear", device="cpu", verbose=False)
    with torch.inference_mode():
        single = tserve.serve_spiking_lm("llama3.2-1b_smoke", **kw)
        out = {"single": single["tokens"], "single_logits": single["logits"]}
        for mesh in ("2x1", "1x2"):
            got = tserve.serve_spiking_lm("llama3.2-1b_smoke", mesh=mesh, **kw)
            out[mesh] = (got["tokens"], got["logits"], [rid for rid, _ in got["done"]])
        seq = _tokens(2, 9, seed=5)
        states = []
        for mesh in (None, (1, 2)):
            plan = engine.compile_plan(_params(), None, _cfg(get_config), backend="torch",
                                       device="cpu", mesh=mesh)
            logits, state = engine.prefill(plan, seq[:, :6])
            steps = [engine.decode_step(plan, state, seq[:, i]) for i in range(6, 9)]
            states.append((logits, [s[0] for s in steps], engine.decode_state_full(state),
                           state.kv[0].shape))
        out["steps"] = states
    return out


@pytest.fixture(scope="module")
def mesh_world():
    from repro_torch.launch.mesh import spawn_world

    return spawn_world(_serve_on_mesh, 2, timeout=240.0)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_serve_spiking_lm_on_a_mesh(mesh_world, mesh):
    """``serve_spiking_lm(mesh=)`` on every rank of a 2-rank world gives the
    single-device streams and logits bit for bit, every request once."""
    for r in mesh_world:
        tokens, logits, rids = r[mesh]
        assert torch.equal(tokens, r["single"]) and torch.equal(logits, r["single_logits"])
        assert rids == list(range(7))


def test_head_sharded_prefill_and_steps(mesh_world):
    """A 1x2 plan's prefill and steps equal the single-device plan's; each
    rank holds half the heads of the state, which gathers to the whole."""
    for r in mesh_world:
        (l0, s0, full0, shape0), (l1, s1, full1, shape1) = r["steps"]
        assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(s0, s1))
        assert all(torch.equal(a, b) for a, b in zip(full0.kv, full1.kv))
        assert shape1[2] * 2 == shape0[2]


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["cuda", "cuda+packed", "cuda+packed+sparse"])
def test_decode_exact_on_card(card, route):
    """On the card, prefill plus steps against the full forward: the state
    equal to the prefill's on the whole sequence, the logits within atol (the
    head's cuBLAS order may differ between B and B*S rows); chunked prefill's
    state equal to one-shot's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(get_config)
    params = tslm.init_spiking_lm(torch.Generator(card).manual_seed(0), cfg)
    plan = engine.compile_plan(params, None, cfg, backend=route, device=card)
    seq = _tokens(2, 21, seed=4).to(card)
    full = engine.apply(plan, seq)
    _, state = engine.prefill(plan, seq[:, :17])
    for i in range(17, 21):
        step_logits, state = engine.decode_step(plan, state, seq[:, i])
        torch.testing.assert_close(step_logits, full[:, i], rtol=0, atol=ATOL)
    _, whole = engine.prefill(plan, seq)
    _same_state(state, whole)
    chunked = texec.decode_state_init(plan.meta, 2)
    for start in range(0, 21, 8):
        _, chunked = engine.prefill_chunk(plan, chunked, seq[:, start:start + 8])
    _same_state(chunked, whole)
