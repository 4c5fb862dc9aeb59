"""The port's training substrate held against the JAX package:
``optim/optimizer.py`` (AdamW and Adafactor, the schedule, clipping, bf16
moments, master weights, the state specs), ``checkpoint.AsyncSaver``, and
``data/pipeline.py``'s ``modality_batch`` and ``Prefetcher``.  The twins of
``tests/test_substrate.py``'s optimizer, schedule, clipping, bf16-moment,
prefetcher-order and async-checkpoint tests and of
``tests/test_system.py::test_master_weights_optimizer`` keep their names.

Tolerances: one AdamW and one Adafactor update against the JAX package's on
a shared tree within ``rtol=1e-6, atol=1e-6`` (the same f32 arithmetic step
by step; ``sqrt``, the means and the global norm's sum may differ in the
last bit), bf16 moments within one bf16 ulp; the schedule within 1e-6;
``modality_batch`` bit for bit.  The test marked ``cuda`` holds an AdamW
update on the card against the same update on the CPU."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_batch, modality_batch
from repro_torch.distributed.sharding import make_rules, param_spec
from repro_torch.optim.optimizer import (
    OptimizerConfig, cosine_schedule, global_norm, make_adafactor, make_adamw, make_optimizer,
    opt_pspecs)

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

UPDATE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.data import pipeline as jdata
    from repro.optim import optimizer as jopt

    return SimpleNamespace(jax=jax, jnp=jnp, opt=jopt, data=jdata)


# -- the JAX package's substrate tests, in the port -------------------------------

def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([1.0])}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(kind):
    cfg = OptimizerConfig(kind=kind, lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    opt = make_optimizer(cfg)
    params = _quadratic_params()
    state = opt.init(params)
    loss = lambda p: (p["w"] ** 2).sum() + (p["b"] ** 2).sum()
    for step in range(150):
        g = {k: 2 * v for k, v in params.items()}
        params, state = opt.update(g, state, params, step=torch.tensor(step))
    assert float(loss(params)) < 1e-2


def test_cosine_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in (0, 5, 10, 60, 109)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=0.01)


def test_grad_clipping_records_norm():
    opt = make_optimizer(OptimizerConfig(clip_norm=1e-3))
    params = _quadratic_params()
    state = opt.init(params)
    g = {k: torch.full_like(v, 100.0) for k, v in params.items()}
    p2, state = opt.update(g, state, params, step=torch.tensor(0))
    assert float(opt.last_grad_norm(state)) > 100.0      # the pre-clip norm is recorded
    assert max(float((params[k] - p2[k]).abs().max()) for k in params) < 1.0


def test_bf16_moments():
    opt = make_optimizer(OptimizerConfig(state_dtype="bfloat16"))
    state = opt.init(_quadratic_params())
    assert state["m"]["w"].dtype == torch.bfloat16


def test_master_weights_optimizer():
    opt = make_optimizer(OptimizerConfig(master_weights=True, lr=0.1, warmup_steps=0,
                                         weight_decay=0.0))
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["master"]["w"].dtype == torch.float32
    g = {"w": torch.full((4, 4), 0.01, dtype=torch.bfloat16)}
    p1, s1 = opt.update(g, state, params, step=torch.tensor(0))
    assert p1["w"].dtype == torch.bfloat16
    for i in range(5):
        p1, s1 = opt.update(g, s1, p1, step=torch.tensor(i + 1))
    assert float((s1["master"]["w"] - p1["w"].float()).abs().max()) < 0.01


def test_prefetcher_orders_steps():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    pf = Prefetcher(cfg, start_step=5, depth=2)
    try:
        s, b = pf.next()
        assert s == 5
        s2, _ = pf.next()
        assert s2 == 6
        np.testing.assert_array_equal(b["tokens"], make_batch(cfg, 5)["tokens"])
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


def test_checkpoint_async(tmp_path):
    saver = tckpt.AsyncSaver()
    tree = {"x": torch.ones((3,))}
    saver.save_async(tmp_path, 1, tree)
    tree["x"].add_(1.0)          # an update after the call does not reach the save
    saver.wait()
    assert tckpt.latest_step(tmp_path) == 1
    restored, _ = tckpt.restore(tmp_path, {"x": torch.zeros(3)})
    assert torch.equal(restored["x"], torch.ones(3))


def test_checkpoint_async_raises_a_failed_save(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    saver = tckpt.AsyncSaver()
    saver.save_async(tmp_path / "file" / "ck", 1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                 # the error is raised once


# -- against the JAX package ---------------------------------------------------------

def _shared_tree(rng):
    return {"dense": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                      "b": rng.normal(size=(5,)).astype(np.float32)},
            "stack": rng.normal(size=(3, 4, 7)).astype(np.float32)}


def _assert_tree_close(got, want, **tol):
    """``got`` (tensors) against ``want`` (numpy), leaf by leaf in f32."""
    got, want = dict(flatten_with_names(got)), dict(flatten_with_names(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(), np.asarray(w, np.float32),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("kind,state_dtype,master", [
    ("adamw", "float32", False), ("adamw", "bfloat16", True),
    ("adafactor", "float32", False), ("adafactor", "bfloat16", False)])
def test_update_vs_jax(ref, kind, state_dtype, master):
    jnp = ref.jnp
    rng = np.random.default_rng(4)
    params, grads = _shared_tree(rng), _shared_tree(rng)
    cfg = dict(kind=kind, lr=0.05, warmup_steps=3, total_steps=50, clip_norm=2.0,
               state_dtype=state_dtype, master_weights=master)
    jopt = ref.opt.make_optimizer(ref.opt.OptimizerConfig(**cfg))
    topt = make_optimizer(OptimizerConfig(**cfg))
    jp, tp = ref.jax.tree_util.tree_map(jnp.asarray, params), bridge.to_torch(params)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(4):       # warm-up, peak, decay: moments carried across steps
        g = ref.jax.tree_util.tree_map(lambda x: x * (step + 1), grads)
        jp, jstate = jopt.update(ref.jax.tree_util.tree_map(jnp.asarray, g), jstate, jp,
                                 step=jnp.asarray(step))
        tp, tstate = topt.update(bridge.to_torch(g), tstate, tp, step=torch.tensor(step))
    to_np = lambda tree: ref.jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    _assert_tree_close(tp, to_np(jp), **UPDATE_TOL)
    np.testing.assert_allclose(float(tstate["grad_norm"]), float(jstate["grad_norm"]), rtol=1e-6)
    moment_tol = dict(rtol=2 ** -7, atol=1e-6) if state_dtype == "bfloat16" else UPDATE_TOL
    if "m" in jstate:
        assert tstate["m"]["stack"].dtype == getattr(torch, state_dtype)
        _assert_tree_close(tstate["m"], to_np(jstate["m"]), **moment_tol)
    _assert_tree_close(tstate["v"], to_np(jstate["v"]), **(
        moment_tol if kind == "adamw" else UPDATE_TOL))
    if master:
        _assert_tree_close(tstate["master"], to_np(jstate["master"]), **UPDATE_TOL)


def test_schedule_and_global_norm_vs_jax(ref):
    jnp = ref.jnp
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=90, min_lr_ratio=0.05)
    for step in (0, 3, 7, 8, 40, 89, 95):
        want = ref.opt.cosine_schedule(ref.opt.OptimizerConfig(**cfg), jnp.asarray(step))
        got = cosine_schedule(OptimizerConfig(**cfg), torch.tensor(step))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)
    tree = _shared_tree(np.random.default_rng(5))
    np.testing.assert_allclose(float(global_norm(bridge.to_torch(tree))),
                               float(ref.opt.global_norm(tree)), rtol=1e-6)


def test_opt_pspecs_vs_jax(ref):
    from jax.sharding import PartitionSpec as P

    rules = make_rules()
    names = {"w": ("embed", "ffn"), "b": ("ffn",), "e": ("vocab", "embed")}
    tspecs = {k: param_spec(*v, rules=rules) for k, v in names.items()}
    jspecs = {k: P(*s) for k, s in tspecs.items()}
    for kind in ("adamw", "adafactor"):
        got = opt_pspecs(tspecs, kind)
        want = ref.opt.opt_pspecs(jspecs, kind)
        want_t = ref.jax.tree_util.tree_map(tuple, want, is_leaf=lambda x: isinstance(x, P))
        assert got == want_t
    with pytest.raises(ValueError):
        opt_pspecs(tspecs, "sgd")
    with pytest.raises(ValueError):
        make_optimizer(OptimizerConfig(kind="sgd"))


@pytest.mark.parametrize("kind", ["audio_stub", "vision_stub"])
def test_modality_batch_vs_jax(ref, kind):
    kw = dict(kind=kind, vocab_size=70, seq_len=12, global_batch=4, d_model=6,
              num_prefix_tokens=5)
    for step, shard, shards in ((0, 0, 1), (3, 1, 2)):
        want = ref.data.modality_batch(ref.data.DataConfig(**kw), step, shard=shard,
                                       num_shards=shards)
        got = modality_batch(DataConfig(**kw), step, shard=shard, num_shards=shards)
        via = make_batch(DataConfig(**kw), step, shard=shard, num_shards=shards)
        assert sorted(got) == sorted(want) == sorted(via)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(via[key], want[key])
    with pytest.raises(ValueError):
        modality_batch(DataConfig(kind="tokens"), 0)


def test_prefetcher_stops_while_blocked():
    """A full queue does not keep the thread alive after ``stop``."""
    pf = Prefetcher(DataConfig(vocab_size=50, seq_len=8, global_batch=2), depth=1)
    deadline = time.monotonic() + 5
    while pf.q.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    pf.stop()
    assert not pf._thread.is_alive()


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_adamw_on_card_vs_cpu(card):
    """bf16 moments and master weights: the card's update equals the CPU's
    within UPDATE_TOL (the same elementwise f32 arithmetic; the global
    norm's sum runs in another order)."""
    rng = np.random.default_rng(6)
    params, grads = _shared_tree(rng), _shared_tree(rng)
    opt = make_adamw(OptimizerConfig(state_dtype="bfloat16", master_weights=True, warmup_steps=0))
    outs = {}
    for dev in ("cpu", card):
        p = bridge.to_torch(params, dev)
        state = opt.init(p)
        for step in range(3):
            p, state = opt.update(bridge.to_torch(grads, dev), state, p, step=step)
        outs[str(dev)] = (bridge.to_numpy(p), bridge.to_numpy(state["master"]))
    cpu, gpu = outs["cpu"], outs[str(card)]
    for a, b in zip(cpu, gpu):
        _assert_tree_close(bridge.to_torch(b), a, **UPDATE_TOL)
    assert make_adafactor(OptimizerConfig()).init(bridge.to_torch(params, card))["v"]["stack"][
        "row"].device.type == "cuda"
