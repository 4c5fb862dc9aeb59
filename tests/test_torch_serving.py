"""Continuous spiking-LM serving in the port: decode-state paging, the
continuous-batching scheduler, the continuous serve entry point and the LM
serving pricers, at a tiny width (1 layer, d 32, 2 heads, vocab 64) and the
smoke width (llama3.2-1b_smoke).

The port's own half mirrors the JAX package's ``tests/test_serving.py`` (its
non-mesh, non-jaxpr tests) on the port's API: scattering batch-1 prefills
equals a batched prefill bit for bit, the scheduler's greedy streams equal the
single-stream decode per request under mixed prompt lengths, ragged
``max_new``, EOS eviction, backpressure and chunked admission.  On the CPU
the head's f32 product gives the same argmax at 1 and at ``slots`` rows at
these widths, so the streams are held equal.  The cross-package half holds
the port against the JAX package on the same weights (numpy through
``repro_torch.bridge``): paging states equal, continuous streams equal JAX's
``ContinuousScheduler``'s teacher-forced (the port's argmax is JAX's token
wherever JAX's top-2 margin exceeds ATOL 1e-4, the logits within ATOL), and
the pricers' dicts equal.  Tests marked ``cuda`` hold the same on the card."""

import collections
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.engine import analysis
from repro_torch.launch import serve as tserve
from repro_torch.launch.scheduler import (
    AdmissionQueue, ContinuousScheduler, Request, _chunk_buckets, greedy)
from repro_torch.models import spiking_lm as tslm
from repro_torch.models.lm import get_config

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

VOCAB = 64
ATOL = 1e-4


def _small_cfg(get, t=4):
    return get("llama3.2-1b_smoke").replace(
        spiking=True, spike_t=t, num_layers=1, d_model=32, num_heads=2, head_dim=None,
        d_ff=64, vocab_size=VOCAB)


@functools.lru_cache(maxsize=None)
def _small_plan(t=4, ordering="linear", backend="torch"):
    cfg = _small_cfg(get_config, t)
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(0), cfg)
    return engine.compile_plan(params, None, cfg, backend=backend, ordering=ordering,
                               device="cpu")


def _prompt(rid, s):
    return np.random.default_rng(1000 + rid).integers(0, VOCAB, s)


_REF_CACHE: dict = {}


def _reference_decode(plan, prompt, max_new, eos_id=None) -> list[int]:
    """The single-stream oracle: batch-1 prefill and a greedy step chain with
    the scheduler's completion rule."""
    key = (id(plan), bytes(np.asarray(prompt, np.int64)), max_new, eos_id)
    if key in _REF_CACHE:
        return _REF_CACHE[key]
    logits, state = engine.prefill(plan, np.asarray(prompt)[None])
    toks = [int(greedy(logits[0, -1]))]
    while len(toks) < max_new and (eos_id is None or toks[-1] != eos_id):
        logits, state = engine.decode_step(plan, state, torch.tensor([toks[-1]]))
        toks.append(int(greedy(logits[0])))
    _REF_CACHE[key] = toks
    return toks


def _same_state(a, b):
    assert len(a.kv) == len(b.kv)
    for x, y in zip(a.kv, b.kv):
        assert torch.equal(x, y)
    assert torch.equal(a.pos.to(torch.int32), b.pos.to(torch.int32))


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import jax

    from repro import engine as jengine
    from repro.engine import analysis as janalysis
    from repro.engine.backend import Backend as JBackend
    from repro.launch import scheduler as jsched
    from repro.launch import serve as jserve
    from repro.models import spiking_lm as jslm
    from repro.models.lm import get_config as jget

    return SimpleNamespace(jax=jax, engine=jengine, analysis=janalysis, Backend=JBackend,
                           sched=jsched, serve=jserve, slm=jslm, get=jget)


def _jax_params(ref, cfg, seed=0):
    return ref.jax.tree_util.tree_map(np.asarray,
                                      ref.slm.init_spiking_lm(ref.jax.random.PRNGKey(seed), cfg))


# -- paging: batch init, scatter, gather ----------------------------------------------

def test_decode_state_batch_init_geometry():
    plan = _small_plan()
    st = engine.decode_state_batch_init(plan.meta, 3)
    assert st.pos.shape == (3,) and st.pos.dtype == torch.int32
    assert tuple(tuple(kv.shape) for kv in st.kv) == plan.meta.decode.state_shapes(3)
    assert all(kv.device.type == "cpu" and not kv.any() for kv in st.kv)


@pytest.mark.parametrize("backend", ["torch", "torch+packed", "cuda+packed+sparse"])
@pytest.mark.parametrize("ordering", ["linear", "quadratic"])
def test_scatter_equals_batched_prefill(backend, ordering):
    """Rows prefilled one at a time and scattered into their slots (out of
    order) build the batched prefill's state bit for bit, kv and pos; one
    decode step from either gives equal logits; the inputs stay as they were."""
    plan = _small_plan(4, ordering, backend)
    seq = np.stack([_prompt(i, 6) for i in range(3)])
    _, want = engine.prefill(plan, seq)
    st = engine.decode_state_batch_init(plan.meta, 3)
    for slot in (2, 0, 1):
        _, row = engine.prefill(plan, seq[slot][None])
        before = [x.clone() for x in st.kv] + [st.pos.clone()]
        new = engine.decode_state_scatter(st, slot, row, 0)
        assert all(torch.equal(a, b) for a, b in zip(before, [*st.kv, st.pos]))
        st = new
    for got, w in zip(st.kv, want.kv):
        assert torch.equal(got, w)
    assert st.pos.tolist() == [6, 6, 6]
    tok = torch.zeros((3,), dtype=torch.long)
    got_logits, got_next = engine.decode_step(plan, st, tok)
    want_logits, _ = engine.decode_step(plan, want, tok)
    assert torch.equal(got_logits, want_logits)
    assert got_next.pos.tolist() == [7, 7, 7]


def test_scatter_gather_roundtrip_mixed_lengths():
    """Sequences prefilled at different prompt lengths page into one batch
    (the state has no context-length axis) and gather back bit for bit,
    each slot carrying its own position."""
    plan = _small_plan()
    st = engine.decode_state_batch_init(plan.meta, 2)
    rows = []
    for slot, s in enumerate((4, 9)):
        _, row = engine.prefill(plan, _prompt(slot, s)[None])
        rows.append(row)
        st = engine.decode_state_scatter(st, slot, row, 0)
    assert st.pos.tolist() == [4, 9]
    for slot, row in enumerate(rows):
        back = engine.decode_state_gather(st, slot)
        assert int(back.pos) == int(row.pos)
        for got, want in zip(back.kv, row.kv):
            assert torch.equal(got, want)
        again = engine.decode_state_scatter(st, slot, back, 0)
        _same_state(again, st)


def test_scatter_src_row_selection():
    """``src`` picks which row of a multi-row prefill pages in, and a vector
    ``pos`` source is read at ``src``."""
    plan = _small_plan()
    seq = np.stack([_prompt(7, 5), _prompt(8, 5)])
    _, both = engine.prefill(plan, seq)
    _, solo = engine.prefill(plan, seq[1][None])
    st = engine.decode_state_scatter(engine.decode_state_batch_init(plan.meta, 1), 0, both, 1)
    for got, want in zip(st.kv, solo.kv):
        assert torch.equal(got, want)
    batch = engine.decode_state_batch_init(plan.meta, 2)
    batch = engine.decode_state_scatter(batch, 1, solo, 0)
    moved = engine.decode_state_scatter(engine.decode_state_batch_init(plan.meta, 3), 2,
                                        batch, 1)
    assert moved.pos.tolist() == [0, 0, 5]
    for got, want in zip(moved.kv, solo.kv):
        assert torch.equal(got[:, 2:], want)


def test_scatter_requires_pos_vector():
    plan = _small_plan()
    _, row = engine.prefill(plan, _prompt(0, 4)[None])
    scalar_target = engine.decode_state_init(plan.meta, 1)
    with pytest.raises(ValueError, match="per-slot pos"):
        engine.decode_state_scatter(scalar_target, 0, row, 0)


def test_paging_states_vs_jax(ref):
    """The port's batch init, scatter and gather on the JAX weights give
    JAX's states (kv and pos) bit for bit, rows prefilled at mixed lengths."""
    cfg = _small_cfg(ref.get)
    params = _jax_params(ref, cfg)
    jplan = ref.engine.compile_plan(params, None, cfg, backend="jnp", ordering="linear")
    plan = engine.compile_plan(params, None, _small_cfg(get_config), backend="torch",
                               ordering="linear", device="cpu")
    jst = ref.engine.decode_state_batch_init(jplan.meta, 3)
    st = engine.decode_state_batch_init(plan.meta, 3)
    for slot, s in ((2, 4), (0, 7), (1, 5)):
        prompt = _prompt(slot, s).astype(np.int32)[None]
        _, jrow = ref.engine.prefill(jplan, prompt)
        _, row = engine.prefill(plan, prompt)
        jst = ref.engine.decode_state_scatter(jst, slot, jrow, 0)
        st = engine.decode_state_scatter(st, slot, row, 0)
    for got, want in zip(st.kv, jst.kv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
    for slot in range(3):
        jback, back = ref.engine.decode_state_gather(jst, slot), engine.decode_state_gather(
            st, slot)
        for got, want in zip(back.kv, jback.kv):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(back.pos) == int(jback.pos)


# -- the scheduler: exactness, eviction, slot reuse -----------------------------------

@pytest.mark.parametrize("backend", ["torch", "torch+packed+sparse"])
def test_scheduler_bit_exact_ragged_mixed_lengths(backend):
    """Mixed prompt lengths and ragged max_new at 2 slots over 5 requests: every
    request completes with its single-stream reference's tokens, none lost or
    duplicated, every slot free at the end."""
    plan = _small_plan(4, "linear", backend)
    reqs = [Request(rid=i, prompt=_prompt(i, (4, 7)[i % 2]), max_new=(5, 3, 1, 4, 2)[i])
            for i in range(5)]
    sched = ContinuousScheduler(plan, slots=2, max_pending=8)
    done = sched.run(reqs)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    for r in done:
        assert r.tokens == _reference_decode(plan, r.prompt, r.max_new), r.rid
        assert len(r.tokens) == r.max_new
        assert all(type(t) is int for t in r.tokens)
    stats = sched.stats()
    assert stats["completed"] == stats["admitted"] == 5
    assert stats["rejected"] == 0
    assert len(sched._free) == sched.slots
    assert stats["new_tokens"] == sum(r.max_new for r in reqs)
    assert 0.0 < stats["slot_occupancy"] <= 1.0


def test_scheduler_eos_mid_flight_eviction():
    """EOS retires a sequence mid-flight: its slot refills with a later request
    while earlier admissions keep decoding, and the stopped request's tokens end
    at (and include) the EOS."""
    plan = _small_plan()
    base = _reference_decode(plan, _prompt(0, 5), 8)
    eos = base[1]                                # stops request 0 at token 2
    reqs = [Request(rid=0, prompt=_prompt(0, 5), max_new=8, eos_id=eos),
            Request(rid=1, prompt=_prompt(1, 5), max_new=8),
            Request(rid=2, prompt=_prompt(2, 5), max_new=4)]
    sched = ContinuousScheduler(plan, slots=2, max_pending=8)
    done = {r.rid: r for r in sched.run(reqs)}
    assert sorted(done) == [0, 1, 2]
    assert done[0].tokens == base[:2] and done[0].tokens[-1] == eos
    assert done[1].tokens == _reference_decode(plan, reqs[1].prompt, 8)
    assert done[2].tokens == _reference_decode(plan, reqs[2].prompt, 4)
    # request 2 could only run because request 0's slot freed mid-flight
    assert sched.stats()["steps"] < 8 + 4


def test_scheduler_max_new_one_never_occupies_slot():
    """max_new=1 finishes at prefill: no decode step, no slot taken."""
    plan = _small_plan()
    reqs = [Request(rid=i, prompt=_prompt(i, 4), max_new=1) for i in range(3)]
    sched = ContinuousScheduler(plan, slots=2, max_pending=8)
    done = sched.run(reqs)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert sched.stats()["steps"] == 0
    for r in done:
        assert r.tokens == _reference_decode(plan, r.prompt, 1)
        assert r.finish_s == r.first_token_s


def test_scheduler_warm_dedupes_prompt_buckets():
    plan = _small_plan()
    sched = ContinuousScheduler(plan, slots=2)
    assert sched.warm([5, 7, 5, 7, 7]) == 2
    assert not any(kv.any() for kv in sched.state.kv)   # warming leaves the state alone


def test_scheduler_validation():
    plan = _small_plan()
    with pytest.raises(ValueError, match="positive multiple"):
        ContinuousScheduler(plan, slots=0)
    with pytest.raises(ValueError, match="max_pending"):
        AdmissionQueue(max_pending=0)
    with pytest.raises(ValueError, match="admission policy"):
        AdmissionQueue(policy="drop-newest")
    from repro_torch.core import spikformer as tsf

    vcfg = tsf.SpikformerConfig(embed_dim=32, num_layers=1, num_heads=2, t=2)
    vplan = engine.compile_plan(*tsf.init(torch.Generator().manual_seed(0), vcfg), vcfg,
                                device="cpu")
    with pytest.raises(ValueError, match="LM-plan"):
        ContinuousScheduler(vplan, slots=2)


# -- admission backpressure -------------------------------------------------------------

def test_backpressure_reject_drops_and_counts():
    """``reject``: once ``max_pending`` wait, further arrivals are dropped and
    counted -- never silently lost, never served."""
    plan = _small_plan()
    reqs = [Request(rid=i, prompt=_prompt(i, 4), max_new=2) for i in range(5)]
    sched = ContinuousScheduler(plan, slots=1, max_pending=1, admission="reject")
    done = sched.run(reqs)
    stats = sched.stats()
    assert stats["completed"] + stats["rejected"] == 5
    assert stats["rejected"] == stats["queue_refused"] > 0
    done_rids = {r.rid for r in done}
    rej_rids = {r.rid for r in sched.rejected}
    assert done_rids | rej_rids == set(range(5))
    assert not (done_rids & rej_rids)
    assert all(r.rejected for r in sched.rejected)
    for r in done:
        assert r.tokens == _reference_decode(plan, r.prompt, r.max_new)


def test_backpressure_defer_retries_to_completion():
    """``defer``: refused arrivals retry after the tick; everything completes,
    and the refusal count shows the bound bit."""
    plan = _small_plan()
    reqs = [Request(rid=i, prompt=_prompt(i, 4), max_new=2) for i in range(4)]
    sched = ContinuousScheduler(plan, slots=1, max_pending=1, admission="defer")
    done = sched.run(reqs)
    stats = sched.stats()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert stats["rejected"] == 0
    assert stats["queue_refused"] > 0
    assert stats["queue_high_water"] == 1


def test_scheduler_property_no_loss_no_dup_bit_exact():
    """Property: under random admission orders, slot counts, prompt-length
    mixes, ragged decode lengths and chunk sizes, the scheduler completes every
    request once, ends with every slot free, and every request's tokens equal
    its single-stream reference -- so no request's tokens depend on what
    another slot held, retired slots that keep stepping included."""
    pytest.importorskip("hypothesis")
    import hypothesis.strategies as st
    from hypothesis import given, settings

    plan = _small_plan()

    @settings(deadline=None, max_examples=10)
    @given(
        slots=st.integers(1, 3),
        n=st.integers(1, 6),
        lens=st.lists(st.sampled_from([2, 3, 5]), min_size=1, max_size=3),
        max_news=st.lists(st.integers(1, 5), min_size=6, max_size=6),
        order=st.permutations(list(range(6))),
        max_pending=st.integers(1, 6),
        chunk=st.one_of(st.none(), st.integers(1, 6)),
    )
    def check(slots, n, lens, max_news, order, max_pending, chunk):
        reqs = [Request(rid=i, prompt=_prompt(i, lens[i % len(lens)]), max_new=max_news[i],
                        arrival_s=float(order[i]))
                for i in range(n)]
        sched = ContinuousScheduler(plan, slots=slots, max_pending=max_pending,
                                    admission="defer", prefill_chunk=chunk)
        done = sched.run(reqs)
        assert sorted(r.rid for r in done) == list(range(n))
        assert len(sched._free) == slots
        assert all(s is None for s in sched._active)
        for r in done:
            assert r.tokens == _reference_decode(plan, r.prompt, r.max_new)

    check()


# -- chunked admission -----------------------------------------------------------------

def test_chunk_buckets():
    assert _chunk_buckets(77, 16) == {16, 13}
    assert _chunk_buckets(32, 16) == {16}
    assert _chunk_buckets(8, 16) == {8}


def test_scheduler_chunked_interleaves_with_decode():
    """With a decode in flight, a long-prompt admission advances at most one
    prefill chunk per scheduler tick, and every request's tokens still equal the
    single-stream reference."""
    plan = _small_plan()
    reqs = [Request(rid=0, prompt=_prompt(0, 3), max_new=12),
            Request(rid=1, prompt=_prompt(1, 11), max_new=4)]   # 3+3+3+2 chunks
    sched = ContinuousScheduler(plan, slots=2, max_pending=8, prefill_chunk=3)
    chunk_steps = []
    orig = sched._prefill_chunk

    def counting(params, st, tokens):
        chunk_steps.append(sched.steps)
        return orig(params, st, tokens)

    sched._prefill_chunk = counting
    done = {r.rid: r for r in sched.run(reqs)}
    assert sorted(done) == [0, 1]
    for rid, r in done.items():
        assert r.tokens == _reference_decode(plan, r.prompt, r.max_new), rid
    assert len(chunk_steps) == 5
    assert chunk_steps == sorted(set(chunk_steps))
    assert sched.stats()["prefill_chunks"] == 5
    assert len(sched.stall_s) == 5
    assert done[0].first_token_s < done[1].first_token_s


def test_scheduler_chunked_warm_buckets():
    """Chunked warming bills one shape per chunk bucket (C plus each ragged
    tail), not per prompt length."""
    plan = _small_plan()
    sched = ContinuousScheduler(plan, slots=2, prefill_chunk=3)
    assert sched.warm([5, 7, 5]) == 3            # shapes {3, 2, 1}
    sched2 = ContinuousScheduler(plan, slots=2, prefill_chunk=4)
    assert sched2.warm([8, 12]) == 1             # all chunks full: {4}
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousScheduler(plan, slots=2, prefill_chunk=0)


def test_admit_ttft_monotone_across_drain():
    """Requests admitted in one drain each read a fresh clock: ``admit_s`` and
    ``first_token_s`` strictly increase across the drain, and TTFT includes
    the preceding prefills' time."""
    plan = _small_plan()
    ticks = [0.0]

    def clock():
        ticks[0] += 1.0
        return ticks[0]

    reqs = [Request(rid=i, prompt=_prompt(i, 4), max_new=2) for i in range(3)]
    sched = ContinuousScheduler(plan, slots=4, max_pending=8, clock=clock)
    done = sorted(sched.run(reqs), key=lambda r: r.rid)
    admits = [r.admit_s for r in done]
    firsts = [r.first_token_s for r in done]
    assert admits == sorted(admits) and len(set(admits)) == 3
    assert firsts == sorted(firsts) and len(set(firsts)) == 3
    for r in done:
        assert r.first_token_s > r.admit_s


# -- the serve entry points ---------------------------------------------------------------

_SMOKE = dict(backend="torch", ordering="linear", device="cpu", verbose=False)


def test_continuous_matches_sync_serve():
    """``serve_spiking_lm_continuous`` gives ``serve_spiking_lm``'s tokens per
    request at equal slot count: scheduling is the only difference."""
    kw = dict(num_requests=5, prompt_len=6, max_new=4, slots=2, **_SMOKE)
    sync = dict(tserve.serve_spiking_lm("llama3.2-1b_smoke", **kw)["done"])
    cont, stats = tserve.serve_spiking_lm_continuous("llama3.2-1b_smoke", return_stats=True,
                                                     **kw)
    cont = dict(cont)
    assert sorted(cont) == sorted(sync) == [0, 1, 2, 3, 4]
    for rid in sync:
        np.testing.assert_array_equal(cont[rid], sync[rid], err_msg=f"rid={rid}")
    assert stats["completed"] == 5
    assert stats["warm_step_shapes"] == 1
    assert stats["warm_prefill_shapes"] == 1


def test_continuous_ragged_matches_reference():
    """Mixed prompt lengths and staggered max_new through the entry point: the
    same plan and workload rebuilt (both seed-deterministic), every request
    against its single-stream reference."""
    from repro_torch.data.pipeline import DataConfig, make_batch

    lens, max_new, spread, n = [4, 7], 5, 2, 5
    cont, stats = tserve.serve_spiking_lm_continuous(
        "llama3.2-1b_smoke", num_requests=n, prompt_len=max(lens), max_new=max_new, slots=2,
        prompt_lens=lens, max_new_spread=spread, return_stats=True, **_SMOKE)
    cont = dict(cont)
    assert sorted(cont) == list(range(n))
    assert stats["warm_prefill_shapes"] == 2
    cfg, plan = tserve._compile_lm_serving("llama3.2-1b_smoke", backend="torch",
                                           ordering="linear", mesh=None, seed=0, device="cpu")
    prompts = make_batch(DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=max(lens),
                                    global_batch=n), 0)["tokens"]
    for req in tserve.serving_requests(prompts, prompt_lens=sorted(lens), max_new=max_new,
                                       max_new_spread=spread):
        assert list(cont[req.rid]) == _reference_decode(plan, req.prompt, req.max_new)


def test_continuous_prompt_lens_multiset_preserved(monkeypatch):
    """``prompt_lens=[4, 4, 7]`` is a 2:1 mixture and reaches
    ``serving_requests`` as the full multiset; only warming dedupes."""
    seen = {}
    orig = tserve.serving_requests

    def spy(prompts, *, prompt_lens, **kw):
        seen["lens"] = list(prompt_lens)
        reqs = orig(prompts, prompt_lens=prompt_lens, **kw)
        seen["hist"] = collections.Counter(r.prompt_len for r in reqs)
        return reqs

    monkeypatch.setattr(tserve, "serving_requests", spy)
    done, stats = tserve.serve_spiking_lm_continuous(
        "llama3.2-1b_smoke", num_requests=6, prompt_len=8, prompt_lens=[4, 4, 7], max_new=2,
        slots=2, return_stats=True, **_SMOKE)
    assert seen["lens"] == [4, 4, 7]
    assert seen["hist"] == {4: 4, 7: 2}
    assert stats["warm_prefill_shapes"] == 2
    assert len(done) == 6


def test_serve_continuous_chunked_matches_oneshot():
    """``prefill_chunk`` changes scheduling only: the streams equal one-shot
    admission's, and the warm bill is the chunk buckets."""
    kw = dict(num_requests=5, prompt_len=8, prompt_lens=[4, 8], max_new=3, slots=2, **_SMOKE)
    base = dict(tserve.serve_spiking_lm_continuous("llama3.2-1b_smoke", **kw))
    chunked, stats = tserve.serve_spiking_lm_continuous("llama3.2-1b_smoke", prefill_chunk=3,
                                                        return_stats=True, **kw)
    chunked = dict(chunked)
    assert sorted(chunked) == sorted(base)
    for rid in base:
        np.testing.assert_array_equal(chunked[rid], base[rid], err_msg=f"rid={rid}")
    assert stats["prefill_chunk"] == 3
    assert stats["prefill_chunks"] > 0
    assert stats["warm_prefill_shapes"] == 3     # buckets {3, 2, 1}


def test_serve_continuous_refuses_a_mesh_and_a_missing_card(monkeypatch):
    """A malformed mesh spec is refused (a well-formed one serves: see
    ``test_continuous_mesh_matches_single_device``), and so is a missing
    card."""
    with pytest.raises(ValueError):
        tserve.serve_spiking_lm_continuous("llama3.2-1b_smoke", num_requests=1, prompt_len=2,
                                           max_new=1, mesh="2by1", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.serve_spiking_lm_continuous("llama3.2-1b_smoke", num_requests=1, prompt_len=2,
                                           max_new=1)


def _continuous_on_mesh(rank):
    """One rank of the 2-rank world: continuous serving, one-shot and
    chunked, on a 2x1 mesh beside the single-device run; the scheduler's
    slot check; ``serve_vision`` on 2x1 beside single device."""
    kw = dict(num_requests=5, prompt_len=6, prompt_lens=[3, 6], max_new=3, max_new_spread=1,
              slots=2, **_SMOKE)
    with torch.inference_mode():
        out = {"single": dict(tserve.serve_spiking_lm_continuous("llama3.2-1b_smoke", **kw)),
               "mesh": dict(tserve.serve_spiking_lm_continuous("llama3.2-1b_smoke",
                                                               mesh="2x1", **kw)),
               "chunked": dict(tserve.serve_spiking_lm_continuous(
                   "llama3.2-1b_smoke", mesh="2x1", prefill_chunk=2, **kw))}
        _, plan = tserve._compile_lm_serving("llama3.2-1b_smoke", backend="torch",
                                             ordering="linear", mesh=(2, 1), seed=0,
                                             device="cpu")
        try:
            ContinuousScheduler(plan, slots=3)
            out["slots3"] = None
        except ValueError as e:
            out["slots3"] = str(e)
        vkw = dict(num_requests=6, slots=4, backend="torch+packed", device="cpu",
                   verbose=False)
        out["vision"] = [tserve.serve_vision("spike-iand-former_smoke", mesh=m, **vkw)["logits"]
                         for m in (None, "2x1")]
    return out


@pytest.fixture(scope="module")
def mesh_world():
    from repro_torch.launch.mesh import spawn_world

    return spawn_world(_continuous_on_mesh, 2, timeout=240.0)


def test_continuous_mesh_matches_single_device(mesh_world):
    """Continuous serving on a 2x1 mesh: the same tokens per request as the
    single-device continuous path, on every rank; the slot count must be a
    multiple of the data degree."""
    for r in mesh_world:
        assert sorted(r["mesh"]) == sorted(r["single"]) == list(range(5))
        for rid, toks in r["single"].items():
            np.testing.assert_array_equal(r["mesh"][rid], toks, err_msg=f"rid={rid}")
        assert r["slots3"] is not None and "positive multiple" in r["slots3"]


def test_continuous_mesh_chunked_matches_single_device(mesh_world):
    """Chunked admission composes with a 2x1 mesh: the single-device one-shot
    streams."""
    for r in mesh_world:
        assert sorted(r["chunked"]) == sorted(r["single"])
        for rid, toks in r["single"].items():
            np.testing.assert_array_equal(r["chunked"][rid], toks, err_msg=f"rid={rid}")


def test_serve_vision_on_a_mesh(mesh_world):
    """``serve_vision(mesh="2x1")``: 6 images in slot batches of 4 (the ragged
    batch padded to the data degree) give the single-device logits."""
    for r in mesh_world:
        single, meshed = r["vision"]
        assert single.shape == (6, 10) and torch.equal(meshed, single)


def test_serve_cli_continuous(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--spiking-lm", "--continuous", "--arch", "llama3.2-1b_smoke", "--device",
        "cpu", "--requests", "5", "--prompt-lens", "4,6,9", "--max-new", "4",
        "--max-new-spread", "2", "--slots", "2", "--prefill-chunk", "4", "--backend",
        "torch+packed"])
    tserve.main()
    out = capsys.readouterr().out
    assert "[serve] continuous: 5/5 requests" in out
    assert "3 prefill shape(s) + 1 step shape" in out      # chunk buckets {4, 2, 1}


def test_continuous_streams_vs_jax_teacher_forced(ref):
    """JAX's ``ContinuousScheduler`` and the port's on the same weights and
    workload (mixed lengths, ragged max_new, 2 slots): JAX's logits along its
    stream against the port's single-stream decode teacher-forced on it -- the
    port's argmax is JAX's token wherever JAX's top-2 margin exceeds ATOL, the
    logits within ATOL -- and the port's continuous stream equals JAX's up to
    the first position JAX's margin leaves undecided."""
    cfg = _small_cfg(ref.get)
    params = _jax_params(ref, cfg, seed=1)
    jplan = ref.engine.compile_plan(params, None, cfg, backend="jnp")
    plan = engine.compile_plan(params, None, _small_cfg(get_config), backend="torch",
                               device="cpu")
    spec = [(i, _prompt(i, (4, 7, 5)[i % 3]), (6, 4, 5, 3, 6)[i]) for i in range(5)]
    jdone = {r.rid: r.tokens for r in ref.sched.ContinuousScheduler(jplan, slots=2).run(
        [ref.sched.Request(rid=i, prompt=p.astype(np.int32), max_new=m) for i, p, m in spec])}
    done = {r.rid: r.tokens for r in ContinuousScheduler(plan, slots=2).run(
        [Request(rid=i, prompt=p, max_new=m) for i, p, m in spec])}
    assert sorted(done) == sorted(jdone) == list(range(5))
    apply = ref.jax.jit(ref.engine.make_apply_fn(jplan))
    decided_total = 0
    for rid, prompt, max_new in spec:
        jstream = np.asarray(jdone[rid])
        seq = np.concatenate([prompt, jstream]).astype(np.int32)[None]
        s = prompt.shape[0]
        jlogits = np.asarray(apply(jplan.params, seq))[0, s - 1:s - 1 + max_new]
        logits, state = engine.prefill(plan, prompt[None])
        got = [logits[0, -1]]
        for tok in jstream[:-1]:
            step, state = engine.decode_step(plan, state, torch.tensor([int(tok)]))
            got.append(step[0])
        got = torch.stack(got).numpy()
        top2 = np.sort(jlogits, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > ATOL
        decided_total += int(decided.sum())
        np.testing.assert_array_equal(got.argmax(-1)[decided], jstream[decided])
        np.testing.assert_allclose(got, jlogits, rtol=0, atol=ATOL)
        first_open = int(np.argmin(decided)) if not decided.all() else max_new
        assert done[rid][:first_open] == jdone[rid][:first_open], rid
    assert decided_total > 0.5 * sum(m for _, _, m in spec)


# -- pricers ------------------------------------------------------------------------------

def test_decode_slot_report():
    plan = _small_plan()
    entry = plan.meta.decode
    rep = analysis.decode_slot_report(plan, slots=4, prompt_lens=(4, 7, 4))
    assert rep["slots"] == 4
    assert rep["state_bytes_per_slot"] == entry.state_bytes(1)
    assert rep["state_bytes_batch"] == entry.state_bytes(4) == 4 * rep["state_bytes_per_slot"]
    assert rep["warm_step_shapes"] == 1
    assert rep["warm_prefill_shapes"] == 2
    assert rep["prompt_len_buckets"] == (4, 7)
    assert rep["bytes_per_step_dense"] > 0
    budget = 10 * entry.state_bytes(1) + 3
    rep2 = analysis.decode_slot_report(plan, slots=4, budget_bytes=budget)
    assert rep2["max_slots"] == entry.max_slots(budget) == 10
    from repro_torch.core import spikformer as tsf

    vcfg = tsf.SpikformerConfig(embed_dim=32, num_layers=1, num_heads=2, t=2)
    vplan = engine.compile_plan(*tsf.init(torch.Generator().manual_seed(0), vcfg), vcfg,
                                device="cpu")
    with pytest.raises(ValueError, match="LM-plan"):
        analysis.decode_slot_report(vplan, slots=2)
    with pytest.raises(ValueError, match="LM-plan"):
        analysis.prefill_chunk_report(vplan, seq_len=8, chunk=4)


def test_decode_slot_report_full_width():
    """llama3.2-1b's spiking plan geometry: 268,435,456 B of state per slot
    (16 layers x T 4 x 4 heads x 512^2 x f32), priced without weights."""
    full = tserve.spiking_lm_config("llama3.2-1b")
    entry = engine.DecodeEntry(full.num_layers, 4, 4, 512)
    plan = SimpleNamespace(meta=SimpleNamespace(
        decode=entry, family="lm", backend=engine.Backend("cuda"),
        cfg=engine.LMDeployCfg(arch=full)))
    rep = analysis.decode_slot_report(plan, slots=4, budget_bytes=80 * 2 ** 30)
    assert rep["state_bytes_per_slot"] == 268_435_456
    assert rep["max_slots"] == 320


def test_max_slots_exact():
    entry = _small_plan().meta.decode
    per = entry.state_bytes(1)
    assert entry.max_slots(0) == 0
    assert entry.max_slots(per - 1) == 0
    assert entry.max_slots(per) == 1
    assert entry.max_slots(7 * per + per - 1) == 7


def test_prefill_chunk_report():
    plan = _small_plan()
    rep = analysis.prefill_chunk_report(plan, seq_len=11, chunk=4)
    assert rep["num_chunks"] == 3
    assert rep["chunk_buckets"] == [4, 3]
    assert rep["state_bytes"] == plan.meta.decode.state_bytes(1)
    long = analysis.prefill_chunk_report(plan, seq_len=4096, chunk=64)
    assert long["chunked_plane_bytes"] == analysis.prefill_chunk_report(
        plan, seq_len=64 * 4096, chunk=64)["chunked_plane_bytes"]
    assert long["oneshot_plane_bytes"] > long["chunked_plane_bytes"]
    assert long["plane_reduction"] > 1.0
    exact = analysis.prefill_chunk_report(plan, seq_len=8, chunk=4)
    assert exact["num_chunks"] == 2 and exact["chunk_buckets"] == [4]


def test_pricers_refuse_a_mesh():
    """A malformed mesh or a zero axis is refused; a mesh prices the
    cross-rank bytes (``test_traffic_mesh_vs_jax``)."""
    cfg = _small_cfg(get_config)
    with pytest.raises(ValueError, match="dxm"):
        analysis.lm_spike_traffic(cfg, seq_len=4, mesh="2by1")
    with pytest.raises(ValueError, match=">= 1"):
        analysis.lm_decode_traffic(cfg, mesh=(0, 2))
    priced = analysis.lm_decode_traffic(cfg, mesh="2x2", backend="torch+packed")
    assert priced["cross_device_state_bytes"] == 0
    assert priced["cross_device_packed_bytes"] > 0


@pytest.mark.parametrize("mesh", ["1x2", (2, 2), "4x4"])
def test_traffic_mesh_vs_jax(ref, mesh):
    """The ``mesh=`` pricing of both families equals the JAX package's dicts
    (cross-rank bytes per edge, the crossing edges, the reduction)."""
    from repro_torch.core import spikformer as tsf

    from repro.core import spikformer as jsf

    for backend in ("torch", "torch+packed", "cuda+packed"):
        jbackend = _PRICED[backend](ref)
        for arch in ("llama3.2-1b_smoke", "llama3.2-1b"):
            jcfg, cfg = ref.serve.spiking_lm_config(arch), tserve.spiking_lm_config(arch)
            assert analysis.lm_spike_traffic(cfg, seq_len=13, batch=2, backend=backend,
                                             ordering="linear", mesh=mesh) == \
                ref.analysis.lm_spike_traffic(jcfg, seq_len=13, batch=2, backend=jbackend,
                                              ordering="linear", mesh=mesh)
            assert analysis.lm_decode_traffic(cfg, batch=4, backend=backend, mesh=mesh) == \
                ref.analysis.lm_decode_traffic(jcfg, batch=4, backend=jbackend, mesh=mesh)
        vision = dict(embed_dim=384, num_layers=8, num_heads=12, t=4)
        assert analysis.spike_traffic(tsf.SpikformerConfig(**vision), batch=8, backend=backend,
                                      mesh=mesh) == \
            ref.analysis.spike_traffic(jsf.SpikformerConfig(**vision), batch=8,
                                       backend=jbackend, mesh=mesh)


# the port's routes and the JAX backends that price alike: the closed SSA
# boundary is the kernel route with packed words ("pallas" with the matmul
# kernel on, which the CPU's interpret mode leaves off unless asked)
_PRICED = {
    None: lambda ref: None,
    "torch": lambda ref: "jnp",
    "torch+packed": lambda ref: "jnp+packed",
    "torch+packed+sparse": lambda ref: "jnp+packed+sparse",
    "cuda+packed": lambda ref: ref.Backend("pallas", packed=True, matmul_kernel=True),
    "cuda+packed+sparse": lambda ref: ref.Backend("pallas", packed=True, sparse=True,
                                                  matmul_kernel=True),
}


@pytest.mark.parametrize("backend", list(_PRICED))
def test_lm_traffic_vs_jax(ref, backend):
    jbackend = _PRICED[backend](ref)
    for arch in ("llama3.2-1b_smoke", "llama3.2-1b"):
        jcfg, cfg = ref.serve.spiking_lm_config(arch), tserve.spiking_lm_config(arch)
        for ordering in ("quadratic", "linear"):
            for s, b in ((1, 1), (13, 2), (512, 4)):
                assert analysis.lm_spike_traffic(cfg, seq_len=s, batch=b, backend=backend,
                                                 ordering=ordering) == \
                    ref.analysis.lm_spike_traffic(jcfg, seq_len=s, batch=b, backend=jbackend,
                                                  ordering=ordering)
        for b in (1, 4):
            assert analysis.lm_decode_traffic(cfg, batch=b, backend=backend) == \
                ref.analysis.lm_decode_traffic(jcfg, batch=b, backend=jbackend)


@pytest.mark.parametrize("backend", ["torch", "torch+packed", "cuda+packed",
                                     "cuda+packed+sparse"])
def test_serving_reports_vs_jax(ref, backend):
    cfg = _small_cfg(ref.get)
    params = _jax_params(ref, cfg)
    jplan = ref.engine.compile_plan(params, None, cfg, backend=_PRICED[backend](ref))
    plan = engine.compile_plan(params, None, _small_cfg(get_config), backend=backend,
                               device="cpu")
    for kw in (dict(slots=4, prompt_lens=(4, 7, 4)), dict(slots=3, budget_bytes=10 ** 6)):
        assert analysis.decode_slot_report(plan, **kw) == \
            ref.analysis.decode_slot_report(jplan, **kw)
    for seq_len, chunk, batch in ((11, 4, 1), (8, 4, 2), (4096, 64, 1)):
        assert analysis.prefill_chunk_report(plan, seq_len=seq_len, chunk=chunk, batch=batch) \
            == ref.analysis.prefill_chunk_report(jplan, seq_len=seq_len, chunk=chunk,
                                                 batch=batch)


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _top2_margin(logits):
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "cuda+packed", "cuda+packed+sparse"])
def test_paging_and_scheduler_on_card(card, backend):
    """On the card at smoke width (quadratic ordering, the kernels): batch-1
    prefills scattered equal a 4-row prefill's state, and the scheduler's
    streams equal the single-stream decode, except at a near-tie of the
    single-stream logits (top-2 margin <= ATOL: the head's cuBLAS order may
    differ between 1 and 4 rows)."""
    cfg = tserve.spiking_lm_config("llama3.2-1b_smoke")
    params = tslm.init_spiking_lm(torch.Generator(card).manual_seed(0), cfg)
    plan = engine.compile_plan(params, None, cfg, backend=backend, device=card)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab_size, (4, 9))
    _, want = engine.prefill(plan, seq)
    st = engine.decode_state_batch_init(plan.meta, 4)
    for slot in (3, 1, 0, 2):
        _, row = engine.prefill(plan, seq[slot][None])
        st = engine.decode_state_scatter(st, slot, row, 0)
    for got, w in zip(st.kv, want.kv):
        assert torch.equal(got, w)
    assert st.pos.tolist() == [9] * 4
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (5, 12, 7)[i % 3]),
                    max_new=(6, 3, 5, 4, 6)[i]) for i in range(5)]
    done = ContinuousScheduler(plan, slots=4, prefill_chunk=None).run(reqs)
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        logits, state = engine.prefill(plan, r.prompt[None])
        for j, tok in enumerate(r.tokens):
            row = logits[0, -1] if j == 0 else logits[0]
            if int(row.argmax()) != tok:
                assert _top2_margin(row) <= ATOL, (r.rid, j)
            if j + 1 < len(r.tokens):
                logits, state = engine.decode_step(plan, state,
                                                   torch.tensor([tok], device=card))
