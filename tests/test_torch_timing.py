"""The timing script of the port (``repro_torch/launch/timing.py``) on the
CPU: its statistics, and every measurement at a tiny size."""

import statistics

import pytest
import torch

from repro_torch.launch import timing

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores


@pytest.mark.parametrize("xs", [[3.0], [4.0, 1.0], [5.0, 1.0, 2.0, 9.0, 7.0, 3.0]])
def test_spread(xs):
    s = timing.spread(xs)
    assert s["median"] == statistics.median(xs)
    assert s["q1"] <= s["median"] <= s["q3"]
    assert (s["min"], s["max"], s["mean"]) == (min(xs), max(xs), statistics.fmean(xs))


def test_ssa_on_the_cpu(capsys):
    timing.main(["--device", "cpu", "ssa", "--g", "3", "--n", "5", "--dh", "13",
                 "--reps", "2"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("[timing] ") and "repro_torch on cpu:" in line
    assert "ssa_fwd G=3 N=5 Dh=13: torch.equal the plain version" in line
    assert line.endswith("device not measured")


@pytest.mark.parametrize("route,name", [("packed", "packed_ssa_fwd"),
                                        ("sparse", "sparse_packed_ssa_fwd")])
def test_packed_ssa_routes_on_the_cpu(capsys, route, name):
    timing.main(["--device", "cpu", "ssa", "--g", "8", "--n", "5", "--dh", "13", "--reps", "2",
                 "--route", route, "--causal"])
    line = capsys.readouterr().out.strip()
    assert f"{name} G=8 N=5 Dh=13 T=4 causal: torch.equal the plain version" in line
    assert line.endswith("device not measured")


def test_ssa_lists_on_the_cpu(capsys):
    """Comma-separated token counts and routes: one line each, N outer."""
    timing.main(["--device", "cpu", "ssa", "--g", "4", "--n", "3,6", "--dh", "9", "--reps", "1",
                 "--route", "dense,sparse"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [x.split(": ")[1].split(" G=")[0] for x in lines] == ["ssa_fwd", "sparse_packed_ssa_fwd"] * 2
    assert ["N=3 " in x for x in lines] == [True, True, False, False]


def test_ssa_unknown_route_refused():
    with pytest.raises(SystemExit):
        timing.main(["--device", "cpu", "ssa", "--route", "dense,wide"])


def test_train_on_the_cpu(capsys):
    timing.main(["--device", "cpu", "train", "--arch", "spike-iand-former_smoke",
                 "--steps", "2", "--warmup", "1", "--batch", "2"])
    line = capsys.readouterr().out.strip()
    assert "train spike-iand-former_smoke batch 2, 2 steps after 1 warm-up" in line
    assert all(f"{k} " in line for k in ("median", "q1", "q3", "mean", "min", "max"))


def test_lm_on_the_cpu(capsys):
    timing.main(["--device", "cpu", "lm", "--arch", "llama3.2-1b_smoke", "--steps", "2",
                 "--warmup", "1", "--slots", "2", "--prompt", "5", "--routes", "cuda,torch"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all("2 slots, prompt 5, 2 decode steps after 1 warm-up" in x
                                   for x in lines)
    assert "backend=cuda " in lines[0] and "backend=torch " in lines[1]
    assert all(f"{k} " in lines[0] for k in ("median", "q1", "q3", "mean", "min", "max"))


def test_prefill_on_the_cpu(capsys):
    """One line per route: ms per prefill on the host clock; the kernels'
    device ms are not measured off the card."""
    timing.main(["--device", "cpu", "prefill", "--arch", "llama3.2-1b_smoke", "--slots", "2",
                 "--prompt", "5", "--reps", "1", "--routes", "cuda,torch"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all("2 slots, prompt 5, 1 reps: ms per prefill: events " in x
                                   for x in lines)
    assert "backend=cuda " in lines[0] and "backend=torch " in lines[1]
    assert all(x.endswith("ssa not measured, gemm not measured, lif not measured")
               for x in lines)


def test_lif_on_the_cpu():
    """A line per launch shape, then the form's line: its launches of one
    forward, host-clock ms, no device time off the card, the byte bound."""
    lines = []
    forms = ["K1 LM decode", "K4+map LM decode"]
    got = timing.time_lif(forms, 1, torch.device("cpu"), log=lines.append)
    assert len(lines) == 6
    assert all("torch.equal the plain version" in x and "device not measured" in x
               for x in lines)
    assert list(got) == forms
    for form, st in got.items():
        assert st["launches"] == 113 and st["events_ms"] > 0 and st["bound_ms"] > 0
        assert st["device_ms"] is None and st["memset_ms"] is None
        line = timing.lif_line(form, st)
        assert line.startswith(f"lif {form}: 113 launches; ms per forward: events ")
        assert "device not measured (memset not measured)" in line
        assert line.endswith("device share not measured")


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        timing.main(["ssa", "--g", "1", "--n", "2", "--dh", "4"])


def test_serve_on_the_cpu(capsys):
    """One line per route: the median, quartiles, mean and extremes of the
    slot batches after the warm-up, in ms."""
    routes = ("cuda", "cuda+packed+sparse")
    timing.main(["--device", "cpu", "serve", "--arch", "spike-iand-former_smoke",
                 "--batches", "3", "--warmup", "1", "--slots", "2", "--routes",
                 ",".join(routes)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(routes)
    for route, line in zip(routes, lines):
        assert line.startswith("[timing] ") and "repro_torch on cpu:" in line
        assert (f"serve spike-iand-former_smoke backend={route} slot batch 2, 3 batches "
                "after 1 warm-up: ms per slot batch " in line)
        stats = dict(kv.split() for kv in line.split("ms per slot batch ")[1].split(", "))
        assert list(stats) == ["median", "q1", "q3", "mean", "min", "max"]
        s = {k: float(v) for k, v in stats.items()}
        assert 0 < s["min"] <= s["q1"] <= s["median"] <= s["q3"] <= s["max"]



def test_build_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``build`` times each library alone and all together, each into a fresh
    directory (an nvcc stand-in that writes its -o file), and restores the
    build directory."""
    import stat
    import sys

    from repro_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys, pathlib\n"
                    "pathlib.Path(sys.argv[sys.argv.index('-o') + 1]).write_text('x')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    before = _build.BUILD_DIR
    timing.main(["--device", "cpu", "build"])
    lines = capsys.readouterr().out.strip().splitlines()
    names = [*_build.SOURCES, *_build.CONTROLS, "all"]
    assert [line.split(" build ")[1].split(":")[0] for line in lines] == names
    assert all(line.startswith("[timing] ") and ": seconds " in line for line in lines)
    assert _build.BUILD_DIR == before
