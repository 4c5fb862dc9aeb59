"""The port's twins of the JAX package's trained-fixture tests:
``test_trained_fixture_memoized_and_learned`` (``tests/test_sparsity.py``)
and ``test_trained_fixture_sharded_bit_exact``
(``tests/test_sharded_engine.py``, here a 1x2 gloo world).  The port's own
fixture (``checkpoint/fixtures.py::trained_lm_fixture``), trained on the CPU
into a fresh directory, learns, is memoised (a second call retrains
nothing), names its corpus and device, serves every T from one checkpoint,
and serves ``torch.equal`` from a plan sharded over two ranks."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint import fixtures as tfix
from repro_torch.launch import mesh as tmesh
from repro_torch.models import spiking_lm as tslm

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

WORLD_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def port_fixture(tmp_path_factory):
    """The port's own fixture, trained on the CPU into a fresh directory."""
    ckpt_dir, cfg = tfix.trained_lm_fixture(tmp_path_factory.mktemp("port_fix") / "ck",
                                            device="cpu")
    return ckpt_dir, cfg


def _tokens(seq, seed=2, batch=1, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, (batch, seq)))


def test_trained_fixture_memoized_and_learned(port_fixture):
    ckpt_dir, _ = port_fixture
    step = tckpt.latest_step(ckpt_dir)
    assert step == tfix.FIXTURE_STEPS
    manifest = json.loads((Path(ckpt_dir) / f"step_{step:08d}" / "manifest.json").read_text())
    meta = manifest["meta"]
    assert meta["loss_last"] < meta["loss_first"]        # it actually learned
    assert meta["device"] == "cpu" and meta["route"] == "plain" and "default_rng" in meta["corpus"]
    pointer = Path(ckpt_dir) / "LATEST"
    mtime = pointer.stat().st_mtime_ns
    ckpt_dir2, _ = tfix.trained_lm_fixture(ckpt_dir, device="cpu")   # memoized: no retrain
    assert str(ckpt_dir2) == str(ckpt_dir)
    assert pointer.stat().st_mtime_ns == mtime
    # spike_t changes no parameter shape: ONE checkpoint serves every T
    for t in (8, 32):
        cfg_t = tfix.fixture_config(spike_t=t)
        skel = tslm.init_spiking_lm(torch.Generator().manual_seed(0), cfg_t)
        plan = engine.compile_plan(skel, None, cfg_t, backend="torch+packed", ordering="linear",
                                   checkpoint=str(ckpt_dir), device="cpu")
        out = engine.apply(plan, _tokens(4))
        assert out.shape == (1, 4, cfg_t.vocab_size) and bool(torch.isfinite(out).all())


def test_default_dir_names_the_device():
    d = tfix._default_dir(torch.device("cpu"))
    assert d.endswith(f"{tfix.FIXTURE_ARCH}-seed{tfix.FIXTURE_SEED}-cpu")
    assert "repro_fixtures" not in d and Path(d).parent.name == "fixtures"


def _fixture_world(rank, ckpt_dir, tokens):
    """Each T: the fixture's ``torch+packed`` linear plan on a (1, 2) mesh
    against the single-device plan, on every rank."""
    out = {}
    with torch.inference_mode():
        for t in (8, 32):
            cfg = tfix.fixture_config(spike_t=t)
            skel = tslm.init_spiking_lm(torch.Generator().manual_seed(0), cfg)
            plans = [engine.compile_plan(skel, None, cfg, backend="torch+packed",
                                         ordering="linear", checkpoint=ckpt_dir, device="cpu",
                                         mesh=mesh) for mesh in (None, (1, 2))]
            base, sharded = (engine.apply(p, tokens) for p in plans)
            out[t] = (torch.equal(sharded, base), sharded.shape)
    return out


@pytest.fixture(scope="module")
def fixture_world(port_fixture):
    ckpt_dir, _ = port_fixture
    return tmesh.spawn_world(_fixture_world, 2, (str(ckpt_dir), _tokens(6, seed=7, batch=2)),
                             timeout=WORLD_TIMEOUT)


@pytest.mark.parametrize("t", [8, 32], ids=["T8", "T32"])
def test_trained_fixture_sharded_bit_exact(fixture_world, t):
    for rank, out in enumerate(fixture_world):
        equal, shape = out[t]
        assert equal, f"rank {rank}, T={t}"
        assert tuple(shape) == (2, 6, 256)
