"""The port's generic trainer (``launch/train.py::train``, ``data_config_for``
and the CLI) held against the JAX package's (the twin of
``tests/test_train_integration.py``).  Both packages start from the JAX
package's ``init_lm(PRNGKey(seed))`` weights (the port takes them through
``init=``) and read the same deterministic token stream.

Tolerances, each with its reason (the smoke configs compute in f32; the
port's sums run in another order than XLA's):
* per-step losses: rtol ``LOSS_RTOL`` 1e-5, the single-step loss tolerance
  of ``tests/test_torch_lm_models.py``.  Step 0 trains at lr 0 (the warm-up
  of ``max(1, steps // 20)`` steps starts at 0), so the first two losses
  are of the same weights; later steps add AdamW updates of 3e-4, whose
  reordering noise reaches the loss at ~1e-7 (measured).
* parameters after the run: elementwise within ``PARAM_ATOL`` 1e-5 (about
  three hundredths of one step of lr 3e-4).  An element whose gradient is
  well above AdamW's eps moves by +-lr per step in both packages, set by the
  gradient's sign; the measured largest gap is 3.5e-8.  An element whose
  gradient is zero but for rounding would move by noise of size lr (the rule
  of ``tests/test_torch_lm_models.py``); the smoke llama has no bias whose
  gradient is such, and a gap of that size would show here.
* ``compress_grads``: the int8 round trip is the JAX package's op for op,
  but a gradient element that sits at a rounding boundary of its block
  quantises one level apart in the two packages (measured: 2-9 of 4,096 to
  16,384 elements a leaf after 6 steps).  So parameters and first moments
  are held within ``COMPRESS_ATOL`` 1e-4, a third of one lr step (measured
  1.3e-5), and the error-feedback residuals elementwise within
  ``PARAM_ATOL`` but on at most ``FLIP_SHARE`` 2e-3 of a leaf's elements
  (measured 5.5e-4), each of those within one quantisation step, at most
  twice the leaf's largest residual.
* the port's own restart on the CPU: ``torch.equal`` (the same eager ops on
  the same inputs in the same order).
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ARCH = "llama3.2-1b_smoke"
STEPS, BATCH, SEQ = 6, 2, 32
RESTART_STEPS, STOP = 8, 4
LOSS_RTOL, PARAM_ATOL, COMPRESS_ATOL, FLIP_SHARE = 1e-5, 1e-5, 1e-4, 2e-3
OTHERS = ("granite-moe-3b-a800m_smoke", "mamba2-130m_smoke", "musicgen-large_smoke",
          "paligemma-3b_smoke")
OTHER_STEPS = 2
QUIET = dict(log_every=1000)


def _jax_init(arch, seed=0):
    import jax

    from repro.models import lm as jlm
    from repro.models import transformer as JT

    params = JT.init_lm(jax.random.PRNGKey(seed), jlm.get_config(arch))
    return jax.tree_util.tree_map(np.asarray, params)


def _np_state(state):
    import jax

    return jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's runs, once per module: (state as numpy, losses)."""
    from repro.launch.train import train as jtrain

    runs = {}
    for compress in (False, True):
        state, losses = jtrain(ARCH, steps=STEPS, batch=BATCH, seq_len=SEQ,
                               compress_grads=compress, **QUIET)
        runs[("llama", compress)] = (_np_state(state), losses)
    for arch in OTHERS:
        runs[arch] = (None, jtrain(arch, steps=OTHER_STEPS, batch=BATCH, seq_len=SEQ,
                                   **QUIET)[1])
    d = tmp_path_factory.mktemp("jax_ckpt")
    jtrain(ARCH, steps=RESTART_STEPS, batch=BATCH, seq_len=SEQ, ckpt_dir=str(d),
           ckpt_every=100, stop_after=STOP, **QUIET)
    state, losses = jtrain(ARCH, steps=RESTART_STEPS, batch=BATCH, seq_len=SEQ, **QUIET)
    runs["restart"] = (_np_state(state), losses, d)
    return runs


def _flat(tree) -> dict:
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, dtype=np.float64)
            for k, v in flatten_with_names(tree)}


def _assert_close(got, want, atol, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=f"{what} {k}")


def _assert_flips(got, want, what):
    """Elementwise within PARAM_ATOL but on at most FLIP_SHARE of a leaf's
    elements, those within twice the leaf's largest magnitude."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        gap = np.abs(g[k] - w[k])
        assert (gap > PARAM_ATOL).mean() <= FLIP_SHARE, f"{what} {k}"
        assert gap.max() <= 2 * np.abs(w[k]).max(), f"{what} {k}"


def _port(arch=ARCH, steps=STEPS, **kw):
    return ttrain.train(arch, steps=steps, batch=BATCH, seq_len=SEQ, device="cpu",
                        init=_jax_init(arch), **QUIET, **kw)


@pytest.mark.parametrize("arch", [a + s for a in ASSIGNED_ARCHS for s in ("", "_smoke")])
def test_data_config_for_matches_reference(arch):
    import dataclasses

    from repro.launch.train import data_config_for as jdata
    from repro.models import lm as jlm

    got = ttrain.data_config_for(tlm.get_config(arch), 4, 64, 3)
    want = jdata(jlm.get_config(arch), 4, 64, 3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("compress", [False, True])
def test_train_matches_reference(ref, compress):
    want_state, want_losses = ref[("llama", compress)]
    state, losses = _port(compress_grads=compress)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert sorted(state) == sorted(want_state)
    atol = COMPRESS_ATOL if compress else PARAM_ATOL
    _assert_close(state["params"], want_state["params"], atol, "params")
    _assert_close(state["opt_state"]["m"], want_state["opt_state"]["m"], atol, "m")
    assert int(state["step"]) == int(want_state["step"]) == STEPS
    assert state["step"].dtype == torch.int32
    if compress:
        _assert_flips(state["ef_residual"], want_state["ef_residual"], "ef_residual")


@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_losses_match_reference(ref, arch):
    _, want = ref[arch]
    _, losses = _port(arch, steps=OTHER_STEPS)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_opt_kind_is_ignored_as_in_reference():
    """``train()`` builds AdamW whatever ``cfg.opt_kind`` says (kimi's smoke
    config asks for momentum-free Adafactor): the state has JAX's keys."""
    import jax

    from repro.launch.train import train as jtrain

    arch = "kimi-k2-1t-a32b_smoke"
    assert tlm.get_config(arch).opt_kind == "adafactor"
    state, _ = ttrain.train(arch, steps=1, batch=BATCH, seq_len=16, device="cpu", **QUIET)
    jstate, _ = jtrain(arch, steps=1, batch=BATCH, seq_len=16, **QUIET)
    assert sorted(state["opt_state"]) == sorted(jstate["opt_state"]) == ["grad_norm", "m", "v"]
    want = {k: np.shape(v) for k, v in flatten_with_names(jax.tree_util.tree_map(
        np.asarray, jstate["opt_state"]))}
    assert {k: tuple(v.shape) for k, v in flatten_with_names(state["opt_state"])} == want


def test_first_step_trains_at_lr_zero():
    """The warm-up starts at lr 0, so the first step moves no parameter; it
    only fills the AdamW moments (a quirk of the reference, kept)."""
    init = _jax_init(ARCH)
    state, _ = ttrain.train(ARCH, steps=STEPS, batch=BATCH, seq_len=SEQ, device="cpu",
                            init=init, stop_after=1, **QUIET)
    for (k, a), (_, b) in zip(flatten_with_names(state["params"]),
                              flatten_with_names(bridge.to_torch(init, "cpu", None))):
        assert torch.equal(a, b), k
    assert any(bool(m.abs().max() > 0) for m in bridge.leaves(state["opt_state"]["m"]))


def test_restart_is_exact(tmp_path):
    """8 uninterrupted steps equal 4, a stop with a checkpoint, and a resume
    to 8, bit for bit."""
    full, losses_full = _port(steps=RESTART_STEPS)
    d = tmp_path / "ckpt"
    _, first = _port(steps=RESTART_STEPS, ckpt_dir=str(d), ckpt_every=100, stop_after=STOP)
    assert tckpt.latest_step(d) == STOP
    resumed, rest = _port(steps=RESTART_STEPS, ckpt_dir=str(d), ckpt_every=100)
    assert first + rest == losses_full
    assert int(resumed["step"]) == RESTART_STEPS
    for (k, a), (_, b) in zip(flatten_with_names(full), flatten_with_names(resumed)):
        assert torch.equal(a, b), k


def test_resume_from_a_reference_checkpoint(ref):
    """The JAX package trains to step 4 and checkpoints; the port resumes
    from its checkpoint to step 8 and reaches the JAX package's
    uninterrupted state."""
    want_state, want_losses, d = ref["restart"]
    state, losses = ttrain.train(ARCH, steps=RESTART_STEPS, batch=BATCH, seq_len=SEQ,
                                 ckpt_dir=str(d), ckpt_every=100, device="cpu", **QUIET)
    np.testing.assert_allclose(losses, want_losses[STOP:], rtol=LOSS_RTOL)
    assert int(state["step"]) == RESTART_STEPS
    _assert_close(state["params"], want_state["params"], PARAM_ATOL, "params")
    _assert_close(state["opt_state"], want_state["opt_state"], PARAM_ATOL, "opt_state")


def test_heartbeat_and_forced_straggler_checkpoint(tmp_path):
    """Every step beats the heartbeat file; a watchdog that flags every step
    (factor 0, one sample) forces a checkpoint after ``max_straggler_events``
    events, between the periodic ones, and keeps every step's time."""
    wd = tft.StepWatchdog(tft.WatchdogConfig(straggler_factor=0.0, min_samples=1))
    hb, d = tmp_path / "hb", tmp_path / "ckpt"
    ttrain.train(ARCH, steps=4, batch=BATCH, seq_len=16, device="cpu", ckpt_dir=str(d),
                 ckpt_every=100, heartbeat_dir=str(hb), max_straggler_events=2, watchdog=wd,
                 **QUIET)
    assert len(wd.times) == 4 and len(wd.straggler_events) == 3
    beat = json.loads((hb / "host_00000.hb").read_text())
    assert beat["step"] == 3
    # events at steps 1, 2, 3 -> forced saves at 3 and 4 (after the 2nd and
    # 3rd events), and the final one at 4; keep=3 leaves both
    assert sorted(p.name for p in d.glob("step_*")) == ["step_00000003", "step_00000004"]


def test_cli_lm_and_vision(capsys, monkeypatch):
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2",
                 "--seq-len", "16"])
    assert "[train] done: first-10 mean" in capsys.readouterr().out
    calls = []
    monkeypatch.setattr(ttrain, "train_spikformer", lambda arch, **kw: calls.append((arch, kw)))
    ttrain.main(["--device", "cpu"])
    assert calls == [("spike-iand-former-8-384",
                      dict(seed=0, device="cpu", ckpt_dir=None, steps=3, batch=16, lr=0.05,
                           eval_batches=20))]
    for bad in (["--seq-len", "8"], ["--compress-grads"], ["--arch", ARCH, "--eval-batches", "2"],
                ["--arch", "no-such-arch"]):
        with pytest.raises(SystemExit):
            ttrain.main(bad + ["--device", "cpu"])


def test_cli_vision_smoke_runs(capsys):
    ttrain.main(["--arch", "spike-iand-former_smoke", "--device", "cpu", "--steps", "1",
                 "--batch", "2", "--eval-batches", "1"])
    assert "held-out accuracy" in capsys.readouterr().out


def test_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda:0"):
        with pytest.raises(RuntimeError, match="is_available"):
            ttrain.train(ARCH, steps=1, batch=1, seq_len=8, device=device)


@pytest.mark.cuda
def test_restart_on_card(tmp_path):
    """The restart on the card: within the reference's own rtol 1e-5 / atol
    1e-6 (``tests/test_train_integration.py``), since the embedding
    gradient's indexed accumulate is not deterministic on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    kw = dict(steps=RESTART_STEPS, batch=BATCH, seq_len=SEQ, device="cuda", **QUIET)
    full, _ = ttrain.train(ARCH, **kw)
    d = tmp_path / "ckpt"
    ttrain.train(ARCH, ckpt_dir=str(d), ckpt_every=100, stop_after=STOP, **kw)
    resumed, _ = ttrain.train(ARCH, ckpt_dir=str(d), ckpt_every=100, **kw)
    for (k, a), (_, b) in zip(flatten_with_names(full["params"]),
                              flatten_with_names(resumed["params"])):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6, msg=k)
    assert bridge.leaves(full["params"])[0].device.type == "cuda"
