"""The port's mesh-sharded engine on gloo worlds of 4 and 2 CPU ranks,
mirroring the JAX package's ``tests/test_sharded_engine.py``:

* packed-word collective round trips (``spike_shard`` / ``word_allgather`` /
  ``word_psum`` / ``word_reduce_scatter``) at T in {1, 8, 32, 40}, the
  occupancy maps consistent with the moved words on both the tile-aligned
  and the recompute path;
* sharded against single-device BIT-EXACTNESS (``torch.equal``) of logits on
  meshes 1x1, 2x1, 1x2 and 2x2, for the tiny vision model (embed 64, 2
  layers, 4 heads, T=4, BN perturbed so every block fires) and the smoke
  spiking LM (both orderings), on ``torch``, ``torch+packed``,
  ``torch+packed+sparse`` and ``cuda+packed+sparse`` (the kernel route,
  whose wrappers take their plain versions on CPU tensors); greedy decode
  token for token through prefill + decode_step, the gathered state equal;
  paging a row into a slot another data shard owns;
* the int32-wire contract: under a packed backend every recorded spike-edge
  collective is int32 (the dense backend's float32, the same edges, T/ceil(
  T/32) times the bytes), and the recorded wire bytes equal the ``mesh=``
  pricing;
* ``ShardingCfg`` resolution and validation, the shrink warnings;
* the single-device port plans held against the JAX single-device plans on
  the same weights (logits atol 1e-4, as ``test_torch_engine.py``); the JAX
  package's own tests hold its sharded plans equal to its single-device
  ones.

Each world is spawned once per module (``launch.mesh.spawn_world``: a
FileStore in a fresh temporary directory, one thread per rank, a timeout)
and runs every case; each test reads its case's result from every rank.
"""

import traceback
import warnings

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.core import packing
from repro_torch.core import spikformer as tsf
from repro_torch.engine import analysis
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import _perturb_bn
from repro_torch.models import spiking_lm as tslm
from repro_torch.models.lm import get_config

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

BATCH, SEQ = 2, 8
ATOL = 1e-4
WORLD_TIMEOUT = 240.0
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
MESH_IDS = ["1x1", "2x1", "1x2", "2x2"]
BACKENDS = ["torch", "torch+packed", "torch+packed+sparse", "cuda+packed+sparse"]
ORDERINGS = ["quadratic", "linear"]
TS = [1, 8, 32, 40]


def _vcfg(**kw):
    return tsf.SpikformerConfig(embed_dim=64, num_layers=2, num_heads=4, t=4, **kw)


def _lcfg(t=8):
    return get_config("llama3.2-1b_smoke").replace(spiking=True, spike_t=t, num_heads=4,
                                                  head_dim=None)


def _models():
    """Numpy weights and inputs of both models, made by the port from seeds
    (the vision BN perturbed so that the blocks fire), handed to the ranks
    and to the JAX comparison alike."""
    params, state = tsf.init(torch.Generator().manual_seed(0), _vcfg())
    rng = np.random.default_rng(1)
    vision = (bridge.to_numpy(_perturb_bn(params, rng)), bridge.to_numpy(_perturb_bn(state, rng)),
              np.random.default_rng(3).random((BATCH, 32, 32, 3)).astype(np.float32))
    lm = bridge.to_numpy(tslm.init_spiking_lm(torch.Generator().manual_seed(0), _lcfg()))
    tokens = np.random.default_rng(1).integers(0, _lcfg().vocab_size, (BATCH, SEQ))
    return vision, lm, tokens


def _spikes(rng, shape):
    return torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))


def _occ_ok(xp) -> bool:
    return xp.occ is not None and torch.equal(xp.occ, packing.occupancy_map(xp.words))


# -- the ranks' cases ---------------------------------------------------------------


def _collective_cases(out, axis):
    """Round trips on the model axis ``axis`` (2 ranks)."""
    rng = np.random.default_rng(0)
    for t in TS:
        for label, feat in (("occ-aligned", 256), ("occ-ragged", 48)):
            xp = packing.pack(_spikes(rng, (t, 3, feat)), occupancy=True)
            got = engine.word_allgather(engine.spike_shard(xp, axis), axis)
            out[("allgather", t, label)] = (torch.equal(got.words, xp.words) and got.t == t
                                            and _occ_ok(got))
        full = _spikes(rng, (t, 2, 64))
        parity = torch.arange(64) % 2
        mine = full * (parity == axis.rank)
        got = engine.word_psum(packing.pack(mine, occupancy=True), axis)
        want = packing.pack(full, occupancy=True)
        out[("psum", t)] = torch.equal(got.words, want.words) and torch.equal(got.occ, want.occ)
        for label, feat in (("occ-aligned", 512), ("occ-ragged", 96)):
            full = _spikes(rng, (t, 2, feat))
            mine = full * ((torch.arange(feat) % 2) == axis.rank)
            scattered = engine.word_reduce_scatter(packing.pack(mine, occupancy=True), axis)
            got = engine.word_allgather(scattered, axis)
            want = packing.pack(full, occupancy=True)
            out[("reduce_scatter", t, label)] = (_occ_ok(scattered)
                                                 and torch.equal(got.words, want.words)
                                                 and _occ_ok(got))
    x = _spikes(rng, (8, 2, 96))
    xp = packing.pack(x, occupancy=True)
    dense = engine.spike_allgather(engine.spike_shard(x, axis), axis)
    words = engine.spike_allgather(engine.spike_shard(xp, axis), axis)
    out[("spike_allgather",)] = torch.equal(dense, x) and torch.equal(packing.unpack(words), x)


def _vision_plan(vision, backend, mesh=None, **kw):
    params, state, _ = vision
    return engine.compile_plan(params, state, _vcfg(**kw), backend=backend, device="cpu",
                               mesh=mesh)


def _lm_plan(lm, backend, ordering, mesh=None):
    return engine.compile_plan(lm, None, _lcfg(), backend=backend, ordering=ordering,
                               device="cpu", mesh=mesh)


def _greedy(plan, tokens, steps=4):
    logits, state = engine.prefill(plan, tokens)
    tok = logits[:, -1].argmax(-1)
    toks, outs = [tok], [logits[:, -1]]
    for _ in range(steps):
        step_logits, state = engine.decode_step(plan, state, tok)
        tok = step_logits.argmax(-1)
        toks.append(tok)
        outs.append(step_logits)
    return torch.stack(toks), torch.stack(outs), engine.decode_state_full(state)


def _same_state(a, b) -> bool:
    return (len(a.kv) == len(b.kv) and torch.equal(a.pos, b.pos)
            and all(torch.equal(x, y) for x, y in zip(a.kv, b.kv)))


def _wire_cases(out, vision, lm, tokens):
    """The int32-wire contract and the recorded bytes against the pricing."""
    images = torch.from_numpy(vision[2])
    toks = torch.from_numpy(tokens)
    for mesh in ((1, 2), (2, 2)):
        reps = {}
        for backend in ("torch", "torch+packed", "cuda+packed"):
            plan = _vision_plan(vision, backend, mesh)
            rep = analysis.collective_report(engine.make_apply_fn(plan), plan.params, images)
            priced = analysis.spike_traffic(_vcfg(), batch=BATCH, backend=backend, mesh=mesh)
            key = "cross_device_dense_bytes" if backend == "torch" else "cross_device_packed_bytes"
            reps[backend] = rep
            out[("wire_bytes", "vision", mesh, backend)] = (
                rep["num_collectives"] > 0 and mesh[0] * rep["wire_bytes"] == priced[key])
        out[("wire_dtypes", "vision", mesh)] = (
            reps["torch+packed"]["dtypes"], reps["cuda+packed"]["dtypes"],
            reps["torch"]["dtypes"], reps["torch"]["num_collectives"],
            reps["torch+packed"]["num_collectives"],
            reps["torch"]["wire_bytes"], reps["torch+packed"]["wire_bytes"])
        reps = {}
        for backend in ("torch", "torch+packed", "cuda+packed"):
            plan = _lm_plan(lm, backend, "linear", mesh)
            rep = analysis.collective_report(engine.make_apply_fn(plan), plan.params, toks)
            priced = analysis.lm_spike_traffic(_lcfg(), seq_len=SEQ, batch=BATCH,
                                               backend=backend, ordering="linear", mesh=mesh)
            key = "cross_device_dense_bytes" if backend == "torch" else "cross_device_packed_bytes"
            reps[backend] = rep
            out[("wire_bytes", "lm", mesh, backend)] = (
                rep["num_collectives"] > 0 and mesh[0] * rep["wire_bytes"] == priced[key])
        out[("wire_dtypes", "lm", mesh)] = (
            reps["torch+packed"]["dtypes"], reps["cuda+packed"]["dtypes"],
            reps["torch"]["dtypes"], reps["torch"]["num_collectives"],
            reps["torch+packed"]["num_collectives"],
            reps["torch"]["wire_bytes"], reps["torch+packed"]["wire_bytes"])
        plan = _lm_plan(lm, "torch+packed", "linear", mesh)
        logits, state = engine.prefill(plan, toks[:, :4])
        tok = logits[:, -1].argmax(-1)
        rep = analysis.collective_report(engine.make_decode_step_fn(plan), plan.params, state, tok)
        priced = analysis.lm_decode_traffic(_lcfg(), batch=BATCH, backend="torch+packed",
                                            mesh=mesh)
        out[("wire_decode", mesh)] = (rep["dtypes"], rep["num_collectives"],
                                      mesh[0] * rep["wire_bytes"]
                                      == priced["cross_device_packed_bytes"])


def _run_case(out, key, fn):
    try:
        out[key] = fn()
    except Exception:
        out[key] = ("error", traceback.format_exc())


def _world4(rank, vision, lm, tokens):
    """Every case of the 4-rank world; returns {case: result}."""
    out = {}
    images, toks = torch.from_numpy(vision[2]), torch.from_numpy(tokens)
    with torch.inference_mode():
        _run_case(out, ("collectives",),
                  lambda: _collective_cases(out, tmesh.make_host_mesh((1, 2)).axis("model")))
        for backend in BACKENDS:
            want = engine.apply(_vision_plan(vision, backend), images)
            for mesh in MESHES:
                _run_case(out, ("vision", backend, mesh), lambda: torch.equal(
                    engine.apply(_vision_plan(vision, backend, mesh), images), want))
        want = engine.apply(_vision_plan(vision, "torch+packed", attn_ordering="linear"), images)
        for mesh in ((1, 2), (2, 2)):
            _run_case(out, ("vision-linear", mesh), lambda: torch.equal(engine.apply(
                _vision_plan(vision, "torch+packed", mesh, attn_ordering="linear"), images), want))
        for backend in BACKENDS:
            for ordering in ORDERINGS:
                want = engine.apply(_lm_plan(lm, backend, ordering), toks)
                for mesh in MESHES:
                    _run_case(out, ("lm", backend, ordering, mesh), lambda: torch.equal(
                        engine.apply(_lm_plan(lm, backend, ordering, mesh), toks), want))
        want = _greedy(_lm_plan(lm, "torch+packed", "linear"), toks[:, :5])
        for mesh in MESHES:
            _run_case(out, ("greedy", mesh), lambda: _greedy_case(lm, toks, mesh, want))
        _run_case(out, ("paging",), lambda: _paging_case(lm, toks))
        _run_case(out, ("wire",), lambda: _wire_cases(out, vision, lm, tokens))
        _run_case(out, ("fires",), lambda: _fires(vision, lm, images, toks))
        _run_case(out, ("shrink",), lambda: _shrink_case(4))
    return out


def _greedy_case(lm, toks, mesh, want):
    got = _greedy(_lm_plan(lm, "torch+packed", "linear", mesh), toks[:, :5])
    return (torch.equal(got[0], want[0]), torch.equal(got[1], want[1]),
            _same_state(got[2], want[2]))


def _paging_case(lm, toks):
    """A 2x2 plan's 4-slot state: a sharded prefill's row 0 (held by data
    shard 0) paged into slot 3 (owned by data shard 1) and a single-device
    row into slot 0, gathered, equal the single-device paging; the step
    from it equal the single-device step; decode_state_gather round-trips."""
    results = []
    for mesh in (None, (2, 2)):
        plan = _lm_plan(lm, "torch+packed", "linear", mesh)
        base = _lm_plan(lm, "torch+packed", "linear")
        _, seq = engine.prefill(plan, toks[:2, :5])
        _, single = engine.prefill(base, toks[1:2, :3])
        state = engine.decode_state_batch_init(plan.meta, 4)
        state = engine.decode_state_scatter(state, 3, seq, 0)
        state = engine.decode_state_scatter(state, 0, single, 0)
        logits, stepped = engine.decode_step(plan, state, toks[:, 5:7].reshape(-1))
        row = engine.decode_state_gather(stepped, 3)
        results.append((engine.decode_state_full(state), logits, engine.decode_state_full(stepped),
                        row))
    (s0, l0, t0, r0), (s1, l1, t1, r1) = results
    return (_same_state(s0, s1) and torch.equal(l0, l1) and _same_state(t0, t1)
            and _same_state(r0, r1) and r1.mesh is None)


def _fires(vision, lm, images, toks):
    """The smallest spike rate of any LIF tap of the single-device plans (a
    case on silent blocks would hold nothing)."""
    rates = [analysis.sparsity_report(_vision_plan(vision, "torch+packed"), images),
             analysis.sparsity_report(_lm_plan(lm, "torch+packed", "linear"), toks)]
    return min(tap["spike_rate"] for r in rates for tap in r["taps"])


def _shrink_case(world_size):
    """The warnings and shapes of meshes larger than, or not tiling, the
    world; a mesh that fits is laid out as asked."""
    got = {}
    for shape in ((2 * world_size, 1), (3, 1), (1, 2)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = tmesh.make_host_mesh(shape)
        got[shape] = (m.shape, m.axis_names, [str(w.message) for w in caught
                                              if issubclass(w.category, UserWarning)])
    return got


def _world2(rank, vision, lm, tokens):
    """The 2-rank world: a 2x2 plan shrinks to 1x2 with a warning and still
    equals the single-device plan; the collectives on 2 ranks."""
    out = {}
    images, toks = torch.from_numpy(vision[2]), torch.from_numpy(tokens)
    with torch.inference_mode():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vplan = _vision_plan(vision, "torch+packed", (2, 2))
        out["shrunk"] = (vplan.meta.mesh.shape, vplan.meta.sharding.mesh_shape,
                         any("shrinking" in str(w.message) for w in caught))
        out["vision"] = torch.equal(engine.apply(vplan, images),
                                    engine.apply(_vision_plan(vision, "torch+packed"), images))
        out["lm"] = torch.equal(
            engine.apply(_lm_plan(lm, "torch+packed", "quadratic", (2, 2)), toks),
            engine.apply(_lm_plan(lm, "torch+packed", "quadratic"), toks))
        coll = {}
        _collective_cases(coll, tmesh.make_host_mesh((1, 2)).axis("model"))
        out["collectives"] = all(v is True for v in coll.values())
    return out


# -- the worlds ---------------------------------------------------------------------

_CACHE: dict = {}


def _world(n):
    if n not in _CACHE:
        fn = _world4 if n == 4 else _world2
        _CACHE[n] = tmesh.spawn_world(fn, n, _models(), timeout=WORLD_TIMEOUT)
    return _CACHE[n]


@pytest.fixture(scope="module")
def world4():
    return _world(4)


@pytest.fixture(scope="module")
def world2():
    return _world(2)


def _case(world, key):
    """The case's result, the same on every rank (or the first rank's error)."""
    values = [r.get(key, ("error", f"case {key} did not run")) for r in world]
    for v in values:
        if isinstance(v, tuple) and v and v[0] == "error":
            pytest.fail(f"case {key} raised on a rank:\n{v[1]}")
    return values


def _all_true(world, key):
    values = _case(world, key)
    assert all(v is True for v in values), (key, values)


# -- feasible shapes, meshes, ShardingCfg (one process) -----------------------------

@pytest.mark.parametrize("shape,n,want", [
    ((2, 2), 2, (1, 2)),      # the model axis survives, data shrinks first
    ((4, 1), 2, (2, 1)),
    ((3, 2), 4, (2, 2)),
    ((2, 2), 4, (2, 2)),      # already feasible: unchanged
    ((2, 4), 1, (1, 1)),
    ((8,), 2, (2,)),
])
def test_feasible_mesh_shape(shape, n, want):
    assert tmesh.feasible_mesh_shape(shape, n) == want


def test_make_host_mesh_shrinks_with_warning():
    """One process is a world of one: any larger mesh shrinks to the trivial
    one with a warning, and its axes are the identity."""
    with pytest.warns(UserWarning, match="shrink"):
        m = tmesh.make_host_mesh((2, 1), axes=("data", "model"))
    assert m.shape == (1, 1) and m.axis_names == ("data", "model")
    x = torch.arange(6.0).reshape(2, 3)
    assert m.axis("model").all_gather(x) is x and m.axis("data").size == 1


def test_shrink_on_worlds(world4):
    got = _case(world4, ("shrink",))[0]
    assert got[(8, 1)][0] == (4, 1) and any("shrinking" in w for w in got[(8, 1)][2])
    assert got[(3, 1)][0] == (2, 1) and any("tile" in w for w in got[(3, 1)][2])
    assert got[(1, 2)] == ((1, 2), ("data", "model"), [])


def test_plan_meta_carries_sharding():
    (params, state, _), _, _ = _models()
    with pytest.warns(UserWarning, match="shrink"):
        plan = engine.compile_plan(params, state, _vcfg(), backend="torch", device="cpu",
                                   mesh="2x2")
    scfg = plan.meta.sharding
    assert isinstance(scfg, engine.ShardingCfg)
    assert scfg.mesh_shape == (2, 2) and scfg.mesh_axes == ("data", "model")
    assert scfg.rules_dict["heads"] == "model" and scfg.rules_dict["embed"] == "model"
    assert plan.meta.mesh.shape == (1, 1)
    single = engine.compile_plan(params, state, _vcfg(), backend="torch", device="cpu")
    assert single.meta.sharding is None and single.meta.mesh is None


def test_sharding_validation_rejects_indivisible():
    (params, state, _), lm, _ = _models()
    with pytest.raises(ValueError, match="num_heads"):
        engine.compile_plan(params, state, _vcfg(), device="cpu", mesh=(1, 3))
    with pytest.raises(ValueError, match="num_heads"):
        engine.compile_plan(lm, None, _lcfg(), device="cpu", mesh=(1, 8))
    with pytest.raises(ValueError, match="dxm"):
        engine.compile_plan(lm, None, _lcfg(), device="cpu", mesh="2by2")


def test_mesh_string_and_tuple_forms_agree():
    _, lm, _ = _models()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = engine.compile_plan(lm, None, _lcfg(), device="cpu", mesh="1x2").meta.sharding
        b = engine.compile_plan(lm, None, _lcfg(), device="cpu", mesh=(1, 2)).meta.sharding
    assert a == b and a.rules_dict["embed"] is None and a.rules_dict["heads"] == "model"


# -- collectives on a 2-rank model axis ---------------------------------------------

@pytest.mark.parametrize("t", TS, ids=lambda t: f"T{t}")
@pytest.mark.parametrize("occ", ["occ-aligned", "occ-ragged"])
def test_word_allgather_shard_roundtrip(world4, t, occ):
    """spike_shard then word_allgather is the identity on words and keeps the
    occupancy map consistent, on the tile-aligned path (256/2 = 128) and the
    recompute path (48/2 = 24)."""
    _case(world4, ("collectives",))
    _all_true(world4, ("allgather", t, occ))


@pytest.mark.parametrize("t", TS, ids=lambda t: f"T{t}")
def test_word_psum_is_disjoint_or(world4, t):
    """Shards holding disjoint spike sets psum to the union train, and the
    occupancy popcounts add to the union's map."""
    _all_true(world4, ("psum", t))


@pytest.mark.parametrize("t", TS, ids=lambda t: f"T{t}")
@pytest.mark.parametrize("occ", ["occ-aligned", "occ-ragged"])
def test_word_reduce_scatter_allgather_is_psum(world4, t, occ):
    """reduce_scatter then all_gather is word_psum, the map consistent after
    every hop (512/2 = 256 keeps the tiled map; 96/2 = 48 recomputes it)."""
    _all_true(world4, ("reduce_scatter", t, occ))


def test_spike_allgather_dense_matches_packed(world4):
    _all_true(world4, ("spike_allgather",))


def test_collectives_on_two_ranks(world2):
    assert all(r["collectives"] is True for r in world2)


# -- sharded against single-device ----------------------------------------------------

def test_world_models_fire(world4):
    """Every LIF tap of the single-device plans the cases run fires."""
    assert min(_case(world4, ("fires",))) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_vision_sharded_bit_exact(world4, backend, mesh):
    """Vision logits on every mesh torch.equal the single-device plan's
    (column-parallel units split no contraction)."""
    _all_true(world4, ("vision", backend, mesh))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_vision_sharded_linear_ordering(world4, mesh):
    _all_true(world4, ("vision-linear", mesh))


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_sharded_bit_exact(world4, backend, mesh, ordering):
    """LM logits on every mesh torch.equal the single-device plan's, both
    orderings (head-local SSA is exact integer arithmetic)."""
    _all_true(world4, ("lm", backend, ordering, mesh))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_lm_sharded_greedy_decode(world4, mesh):
    """Greedy decode through the sharded prefill and decode_step is token
    for token and logit for logit the single-device decode, and the
    gathered state equals the single-device state."""
    for toks_eq, logits_eq, state_eq in _case(world4, ("greedy", mesh)):
        assert toks_eq and logits_eq and state_eq


def test_sharded_paging_equals_single_device(world4):
    _all_true(world4, ("paging",))


def test_shrunk_mesh_equals_single_device(world2):
    """On 2 ranks a 2x2 plan runs on 1x2, warned, and equals single device."""
    for r in world2:
        assert r["shrunk"] == ((1, 2), (2, 2), True)
        assert r["vision"] is True and r["lm"] is True


# -- the int32 wire, against the pricing ---------------------------------------------

@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("family", ["vision", "lm"])
def test_packed_collectives_are_int32_only(world4, family, mesh):
    """Under a packed backend every spike-edge collective is int32 (no
    unpacked spikes cross ranks); the dense backend moves the same edges in
    float32, T / ceil(T/32) times the bytes."""
    _case(world4, ("wire",))
    for packed, kernel, dense, n_dense, n_packed, b_dense, b_packed in _case(
            world4, ("wire_dtypes", family, mesh)):
        assert packed == kernel == ["int32"] and dense == ["float32"]
        assert n_dense == n_packed > 0
        t = 4 if family == "vision" else 8
        assert b_dense == b_packed * (t // packing.num_words(t))


@pytest.mark.parametrize("backend", ["torch", "torch+packed", "cuda+packed"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("family", ["vision", "lm"])
def test_recorded_wire_bytes_equal_pricing(world4, family, mesh, backend):
    """The recorded ring bytes of one forward, summed over the data shards,
    equal ``spike_traffic`` / ``lm_spike_traffic``'s ``mesh=`` pricing."""
    _all_true(world4, ("wire_bytes", family, mesh, backend))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_lm_decode_collectives_int32_only(world4, mesh):
    for dtypes, n, priced in _case(world4, ("wire_decode", mesh)):
        assert dtypes == ["int32"] and n > 0 and priced


# -- the single-device port plans against JAX -----------------------------------------

def test_single_device_vision_vs_jax():
    jax = pytest.importorskip("jax")
    from repro import engine as jengine
    from repro.core import spikformer as jsf

    (params, state, images), _, _ = _models()
    jcfg = jsf.SpikformerConfig(embed_dim=64, num_layers=2, num_heads=4, t=4)
    want = np.asarray(jax.jit(jengine.make_apply_fn(
        jengine.compile_plan(params, state, jcfg, backend="jnp")))(
            jengine.compile_plan(params, state, jcfg, backend="jnp").params, images))
    for backend in ("torch", "torch+packed"):
        got = engine.apply(_vision_plan((params, state, images), backend), images)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_single_device_lm_vs_jax(ordering):
    pytest.importorskip("jax")
    from repro import engine as jengine
    from repro.models.lm import get_config as jget

    _, lm, tokens = _models()
    jcfg = jget("llama3.2-1b_smoke").replace(spiking=True, spike_t=8, num_heads=4,
                                             head_dim=None)
    jplan = jengine.compile_plan(lm, None, jcfg, backend="jnp+packed", ordering=ordering)
    want = np.asarray(jengine.apply(jplan, tokens.astype(np.int32)))
    got = engine.apply(_lm_plan(lm, "torch+packed", ordering), tokens)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_world_timeout_kills_a_hung_rank():
    """A world that does not end within its timeout is killed and raises."""
    with pytest.raises(TimeoutError, match="still ran"):
        tmesh.spawn_world(_sleeps, 2, timeout=3.0)


def _sleeps(rank):
    import time

    time.sleep(60 if rank == 1 else 0)
    return rank
