"""How ``chip_smoke.py`` schedules its work, rehearsed on the CPU: phases 16
and 17 on one ``launch.mesh.World`` that takes the configs in turn, a rank
that raises failing its phase with its traceback, a failed background task
(the dry-run sweep's process) failing phase 15, and the one shared segment
that carries a reference to the ranks."""

import os
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import pytest
import torch

from repro_torch.launch.mesh import World

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
LLAMA = (("llama3.2-1b_smoke", None, (4, 32), ("base",)),)
MAMBA = (("mamba2-130m_smoke", None, (4, 32)),)
TRAIN = (4, 64)
RAISED = "rank 1 raised in llama3.2-1b_smoke on purpose"


def _raises_in_llama(rank, arch, *args):
    if arch.startswith("llama") and rank == 1:
        raise RuntimeError(RAISED)
    return chip_smoke._spmd_rank(rank, arch, *args)


class _RaisingRanks:
    """A world whose ranks run :func:`_raises_in_llama` in place of the
    phase's rank function."""

    def __init__(self, world):
        self.world = world

    def run(self, fn, args=(), *, timeout=None):
        assert fn is chip_smoke._spmd_rank
        return self.world.run(_raises_in_llama, args, timeout=timeout)


@pytest.fixture(scope="module")
def world():
    """One world for the module's tests, in file order; the last one ends it."""
    with World(chip_smoke.SPMD_RANKS, timeout=120.0) as w:
        yield w


def test_one_world_takes_both_phases(capsys, world):
    """llama3.2-1b_smoke under base (phase 16), then mamba2-130m_smoke
    (phase 17, its reference in shared host memory) on the same four ranks,
    each held as ``phase_spmd`` holds a config."""
    chip_smoke.phase_spmd(CPU, "cpu", LLAMA, "phase 16", world, train=TRAIN)
    pids = world.run(_pid)
    chip_smoke.phase_spmd(CPU, "cpu", MAMBA, "phase 17", world, train=TRAIN)
    assert world.run(_pid) == pids      # the same four processes took both
    out = capsys.readouterr().out
    for arch in ("llama3.2-1b_smoke", "mamba2-130m_smoke"):
        assert f"{arch} steps: adamw held, prefill held, decode held" in out
        assert f"{arch} collective operand bytes per rank" in out
    assert "mamba2-130m_smoke: the reference (0.0 GiB) in shared host memory" in out
    assert len(set(pids)) == chip_smoke.SPMD_RANKS and os.getpid() not in pids
    assert not chip_smoke._FAILED


def _pid(rank):
    return os.getpid()


def test_rank_raising_in_second_config_fails_the_phase(capsys, world):
    """mamba2-130m_smoke held, then a rank raising in llama3.2-1b_smoke:
    the phase fails with that rank's traceback, and the world takes no more
    calls."""
    ranks = _RaisingRanks(world)
    chip_smoke.phase_spmd(CPU, "cpu", MAMBA, "phase 17", ranks, train=TRAIN)
    with pytest.raises(SystemExit) as exit_:
        chip_smoke.phase_spmd(CPU, "cpu", LLAMA, "phase 17", ranks, train=TRAIN)
    assert exit_.value.code == 1
    with pytest.raises(RuntimeError, match="failed before"):
        world.run(_pid)
    out = capsys.readouterr().out
    assert "mamba2-130m_smoke steps: adamw held, prefill held, decode held" in out
    assert "FAIL: phase 17: the 4-rank world of llama3.2-1b_smoke failed" in out
    assert "rank 1:\nTraceback" in out and f"RuntimeError: {RAISED}" in out


def _sweep_raises():
    raise ValueError("the sweep raised on purpose")


def _sweep_dies():
    os._exit(3)


def test_failed_sweep_fails_phase_15(capsys):
    """The sweep's process raising, then dying, each fails phase 15 with
    its traceback before any other check of the dry run."""
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        for task, shown in [(_sweep_raises, "ValueError: the sweep raised on purpose"),
                            (_sweep_dies, "BrokenProcessPool")]:
            with pytest.raises(SystemExit) as exit_:
                chip_smoke._gt_dryrun(CPU, "cpu", pool.submit(task))
            assert exit_.value.code == 1
            out = capsys.readouterr().out
            assert "FAIL: phase 15: the dry-run sweep's process failed:" in out
            assert "Traceback" in out and shown in out


def test_shared_host_tree_is_one_segment():
    g = torch.Generator().manual_seed(0)
    tree = {"init": {"w": torch.randn(3, 5, generator=g),
                     "b": torch.randn(7, generator=g, dtype=torch.bfloat16)},
            "steps": [torch.arange(11, dtype=torch.int32), torch.tensor(2.5)],
            "cache": (torch.zeros(0, 4), torch.randn(4, 6, generator=g, dtype=torch.float64).t()),
            "mask": torch.tensor([True, False, True]), "loss": 1.25, "name": "x"}
    shared = chip_smoke._to_shared_host(tree)
    want, got = _tensors(tree), _tensors(shared)
    assert len(got) == len(want) == 7
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(want, got))
    assert len({x.untyped_storage().data_ptr() for x in got}) == 1
    assert all(x.is_shared() and x.is_contiguous() for x in got)
    assert all(x.storage_offset() * x.element_size() % chip_smoke.SHARED_ALIGN == 0 for x in got)
    assert (shared["loss"], shared["name"], type(shared["cache"])) == (1.25, "x", tuple)


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
