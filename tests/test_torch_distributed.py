"""The port's ``distributed`` package and the pieces of the mesh that run
without a model, held against the JAX package: the fault-tolerance
bookkeeping (``StepWatchdog``, ``HeartbeatFile``, ``plan_remesh``), int8
error-feedback compression (bit for bit on the same numpy inputs), the
sharding rules and specs, ``feasible_mesh_shape``, sharded checkpoint
restore on a 2-rank gloo world, and the kernel build's lock."""

import os
import stat
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import _build
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from types import SimpleNamespace

    from repro.distributed import compression, fault_tolerance, sharding
    from repro.launch import mesh

    return SimpleNamespace(comp=compression, ft=fault_tolerance, shd=sharding, mesh=mesh)


# -- fault tolerance ---------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _watch(module, monkeypatch, steps):
    clock = _Clock()
    monkeypatch.setattr(module.time, "monotonic", clock)
    dog = module.StepWatchdog(module.WatchdogConfig(window=6, straggler_factor=2.0,
                                                    hang_timeout_s=5.0, min_samples=3))
    events, hangs = [], []
    for i, dt in enumerate(steps):
        dog.start_step()
        clock.t += dt
        hangs.append(dog.hang_check())
        events.append(dog.end_step(i))
    return events, hangs, dog.median(), dog.straggler_events


def test_step_watchdog_vs_jax(ref, monkeypatch):
    steps = [1.0, 1.1, 0.9, 1.0, 3.5, 1.0, 0.95, 6.0, 1.0, 2.1]
    assert _watch(tft, monkeypatch, steps) == _watch(ref.ft, monkeypatch, steps)
    events, hangs, _, stragglers = _watch(tft, monkeypatch, steps)
    assert [e["step"] for e in events if e] == [4, 7, 9] == [e["step"] for e in stragglers]
    assert hangs == [False] * 7 + [True, False, False]
    assert tft.StepWatchdog().median() is None and not tft.StepWatchdog().hang_check()


def test_heartbeat_file(tmp_path):
    beats = [tft.HeartbeatFile(tmp_path, h) for h in range(3)]
    for h, hb in enumerate(beats):
        hb.beat(10 + h)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "host_00000.hb", "host_00001.hb", "host_00002.hb"]
    assert '"step": 11' in beats[1].path.read_text()
    old = beats[2].path.stat().st_mtime - 1000
    os.utime(beats[2].path, (old, old))
    assert beats[0].dead_hosts(timeout_s=120.0) == [2]
    assert beats[0].dead_hosts(timeout_s=1e6) == []


@pytest.mark.parametrize("old,left,batch", [
    ((4, 4), 16, 64), ((4, 4), 20, 64), ((4, 4), 12, 64), ((4, 4), 3, 64),
    ((5, 2), 9, 50), ((6, 2), 9, 48), ((3, 4), 11, 30), ((1, 8), 7, 8),
])
def test_plan_remesh_vs_jax(ref, old, left, batch):
    """The largest divisor of the data degree that fits, the batch scaled
    with it -- also on non-power-of-two fleets (data 5 on 9 devices keeps
    data 1, never the non-divisor 2)."""
    got = tft.plan_remesh(old, left, batch)
    want = ref.ft.plan_remesh(old, left, batch)
    assert (got.old_shape, got.new_shape, got.new_global_batch, got.action) == \
        (want.old_shape, want.new_shape, want.new_global_batch, want.action)


def test_plan_remesh_non_power_of_two():
    p = tft.plan_remesh((5, 2), 9, 50)
    assert p.new_shape == (1, 2) and p.new_global_batch == 10 and p.action == "remesh"
    p = tft.plan_remesh((6, 2), 9, 48)
    assert p.new_shape == (3, 2) and p.new_global_batch == 24
    assert tft.plan_remesh((2, 8), 7, 8).action == "abort"
    assert tft.plan_remesh((2, 2), 4, 8).action == "continue"


# -- compression ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (256,), (3, 300), (2, 5, 129)])
def test_compress_vs_jax(ref, shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 50.0], shape)).astype(np.float32)
    q, s = tcomp.compress(torch.from_numpy(g))
    jq, js = ref.comp.compress(g)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = tcomp.decompress(q, s, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.comp.decompress(jq, js, shape)))
    np.testing.assert_array_equal(tcomp.roundtrip(torch.from_numpy(g)).numpy(),
                                  np.asarray(ref.comp.roundtrip(g)))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127


def test_error_feedback_vs_jax(ref):
    rng = np.random.default_rng(0)
    res_t = torch.zeros((3, 100))
    res_j = np.zeros((3, 100), np.float32)
    for _ in range(4):
        g = rng.standard_normal((3, 100)).astype(np.float32)
        out_t, res_t = tcomp.error_feedback_step(torch.from_numpy(g), res_t)
        out_j, res_j = ref.comp.error_feedback_step(g, res_j)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
        np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))


def test_tree_error_feedback():
    rng = np.random.default_rng(1)
    grads = {"a": torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32)),
             "b": (torch.from_numpy(rng.standard_normal(7).astype(np.float32)),)}
    res = tcomp.init_residuals(grads)
    assert torch.equal(res["a"], torch.zeros(4, 5)) and res["b"][0].shape == (7,)
    est, new = tcomp.tree_error_feedback(grads, res)
    want_a = tcomp.error_feedback_step(grads["a"], res["a"])
    assert torch.equal(est["a"], want_a[0]) and torch.equal(new["a"], want_a[1])
    assert isinstance(est["b"], tuple) and torch.equal(
        est["b"][0] + new["b"][0], grads["b"][0])


# -- sharding rules ------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["base", "fsdp", "sp", "zero2"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_rules_vs_jax(ref, preset, multi_pod):
    assert tshd.make_rules(preset=preset, multi_pod=multi_pod) == \
        ref.shd.make_rules(preset=preset, multi_pod=multi_pod)


@pytest.mark.parametrize("family", ["vision", "lm"])
def test_engine_rules_and_specs_vs_jax(ref, family):
    rules = tshd.engine_rules(family)
    assert rules == ref.shd.engine_rules(family)
    assert tshd.engine_rules(family, heads=None) == ref.shd.engine_rules(family, heads=None)
    for names in [("batch", "seq", "embed"), (None, "heads"), ("fsdp", "tp"),
                  ("embed", "ffn"), ("vocab",), ()]:
        assert tshd.spec(*names, rules=rules) == tuple(ref.shd.spec(*names, rules=rules))
        assert tshd.param_spec(*names, rules=rules) == tuple(
            ref.shd.param_spec(*names, rules=rules))
    with pytest.raises(ValueError, match="family"):
        tshd.engine_rules("audio")


def test_use_rules_and_constrain():
    assert tshd.active_rules() is None
    rules = tshd.make_rules()
    with tshd.use_rules(rules):
        assert tshd.active_rules() is rules
        assert tshd.spec("batch", "heads") == ("data", "model")
        assert tshd.spec("batch", rules=tshd.make_rules(preset="fsdp")) == (("data", "model"),)
    assert tshd.active_rules() is None and tshd.spec("heads") == (None,)
    x = torch.ones(3)
    assert tshd.constrain(x, "batch") is x


@pytest.mark.parametrize("shape,n", [((2, 2), 2), ((4, 1), 2), ((3, 2), 4), ((2, 4), 1),
                                     ((8,), 3), ((2, 16, 16), 300)])
def test_feasible_mesh_shape_vs_jax(ref, shape, n):
    assert tmesh.feasible_mesh_shape(shape, n) == ref.mesh.feasible_mesh_shape(shape, n)


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="256"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.batch_axes(True) == ("pod", "data") and tmesh.batch_axes(False) == ("data",)


# -- sharded restore on a 2-rank world ------------------------------------------------

def _restore_rank(rank, ckpt_dir):
    """Rank's view of a 1x2 restore: the sharded leaves' blocks and the
    replicated leaf, beside the unsharded restore."""
    mesh = tmesh.make_host_mesh((1, 2))
    target = {"w": torch.zeros(6, 8), "b": torch.zeros(8), "emb": torch.zeros(4, 3),
              "words": torch.zeros(2, 4, dtype=torch.int32)}
    shard = {"w": tshd.NamedSharding(mesh, (None, "model")),
             "b": tshd.NamedSharding(mesh, ("model",)),
             "emb": None,
             "words": tshd.NamedSharding(mesh, (("data", "model"), None))}
    got, manifest = tckpt.restore(ckpt_dir, target, shardings=shard)
    full, _ = tckpt.restore(ckpt_dir, target)
    return {k: v.clone() for k, v in got.items()}, full, manifest["step"]


def test_sharded_restore_on_two_ranks(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)),
            "b": torch.arange(8.0), "emb": torch.ones(4, 3),
            "words": torch.tensor([[1, -1, 7, 2 ** 31 - 1], [0, 5, -8, 3]], dtype=torch.int32)}
    tckpt.save(tmp_path / "ck", 3, tree)
    results = tmesh.spawn_world(_restore_rank, 2, (str(tmp_path / "ck"),), timeout=120.0)
    for rank, (got, full, step) in enumerate(results):
        assert step == 3
        for k in tree:
            assert torch.equal(full[k], tree[k])
        assert torch.equal(got["w"], tree["w"][:, 4 * rank:4 * rank + 4])
        assert torch.equal(got["b"], tree["b"][4 * rank:4 * rank + 4])
        assert torch.equal(got["emb"], tree["emb"])
        assert torch.equal(got["words"], tree["words"][rank:rank + 1])
        assert got["words"].dtype == torch.int32


def test_named_sharding_refuses_an_uneven_cut():
    mesh = tmesh.HostMesh((1, 2), ("data", "model"), None,
                          {"data": tmesh.MeshAxis("data", 1, 0),
                           "model": tmesh.MeshAxis("model", 2, 1)})
    ns = tshd.NamedSharding(mesh, (None, "model"))
    assert ns.local_slices((3, 8)) == (slice(0, 3), slice(4, 8))
    with pytest.raises(ValueError, match="split"):
        ns.local_slices((3, 7))


# -- one build for many processes -----------------------------------------------------

def test_build_runs_once_for_racing_processes(tmp_path, monkeypatch):
    """Ranks reaching first use together build each library once: the build
    holds a lock on the build directory, and a waiter finds the library."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys, time, pathlib\n"
                    f"pathlib.Path({str(calls)!r}).open('a').write('x')\n"
                    "time.sleep(0.5)\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "pathlib.Path(out).write_text('lib')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    source = tmp_path / "k.cu"
    source.write_text("// kernel\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", {"k": source})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    logs = []
    threads = [threading.Thread(target=lambda: logs.append(_build.build(["k"])))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert calls.read_text() == "x"
    assert sorted(len(x) for x in logs) == [0, 0, 0, 1]
    assert _build.library_path("k").read_text() == "lib"


# -- a library built in parts ---------------------------------------------------------

SSA_PART_OF = {"ssa_fwd": 0, "repro_cuda_error_string": 0, "launch_dense": 0,
               "packed_ssa_fwd": 1, "sparse_packed_ssa_fwd": 1, "launch_packed_tc": 1,
               "ssa_launch_wide<256>": 2, "ssa_launch_wide<512>": 3}


def _fake_nvcc(tmp_path, fail_on=None):
    """An nvcc that logs its arguments, writes its -o file (an object under
    -c, else a library) and prints a ptxas line; it fails when ``fail_on``
    is among its arguments."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys, pathlib\n"
                    f"pathlib.Path({str(calls)!r}).open('a').write(' '.join(sys.argv[1:]) + '\\n')\n"
                    f"if {fail_on!r} in sys.argv:\n"
                    "    print('nvcc fatal: this step failed'); sys.exit(1)\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "pathlib.Path(out).write_text('obj' if '-c' in sys.argv else 'lib')\n"
                    "print('ptxas info    : Used 40 registers,', sys.argv[sys.argv.index('-o') - 1])\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return fake, calls


def test_parts_recipe():
    """Each part of ``ssa`` is its own nvcc command with NVCC_FLAGS (``-c``
    for ``-shared``) and its part's ``-D``; one link line of NVCC_FLAGS names
    every part's object.  The other libraries and the control builds stay one
    command each."""
    out = Path("/b/ssa-x.tmp.so")
    compiles, link = _build._commands("nvcc", "ssa", out)
    macro, n = _build.PARTS["ssa"]
    flags = ["-c" if f == "-shared" else f for f in _build.NVCC_FLAGS]
    assert "-shared" in _build.NVCC_FLAGS and len(compiles) == n == 4
    objects = []
    for i, cmd in enumerate(compiles):
        assert cmd[:len(flags) + 2] == ["nvcc", *flags, f"-D{macro}={i}"]
        assert cmd[-1] == str(_build.SOURCES["ssa"]) and cmd[-3] == "-o"
        objects.append(cmd[-2])
    assert len(set(objects)) == n and all(o.startswith("/b/ssa-x.tmp.part") for o in objects)
    assert link == ["nvcc", *_build.NVCC_FLAGS, "-o", str(out), *objects]
    for name in ("lif_parallel", "spike_matmul", *_build.CONTROLS):
        source, want = _build._recipe(name)
        assert _build._commands("nvcc", name, out) == ([["nvcc", *want, "-o", str(out),
                                                         str(source)]], None)


def test_library_path_tracks_every_part(tmp_path, monkeypatch):
    """The SSA library's path changes with its source's bytes, its part
    count and the flags of any command."""
    source = tmp_path / "ssa.cu"
    source.write_bytes(_build.SOURCES["ssa"].read_bytes())
    monkeypatch.setattr(_build, "SOURCES", {**_build.SOURCES, "ssa": source})
    paths = [_build.library_path("ssa")]
    source.write_bytes(source.read_bytes().replace(b"#if SSA_IN_PART(3)", b"#if SSA_IN_PART(3) "))
    paths.append(_build.library_path("ssa"))
    monkeypatch.setattr(_build, "PARTS", {"ssa": ("SSA_PART", 3)})
    paths.append(_build.library_path("ssa"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    paths.append(_build.library_path("ssa"))
    assert len(set(paths)) == 4


def test_parts_build_one_library(tmp_path, monkeypatch):
    fake, calls = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    built = _build.build(["ssa", "lif_parallel"])
    ssa = built["ssa"]
    assert len(ssa.parts) == 4 and all(0 < s <= ssa.seconds for s in ssa.parts)
    assert built["lif_parallel"].parts == () and built["lif_parallel"].seconds > 0
    assert ssa.log.count("ptxas info") == 5      # four parts and the link
    lines = calls.read_text().splitlines()
    links = [x for x in lines if "-shared" in x and "ssa" in x]
    assert len(lines) == 6 and len(links) == 1 and links[0].count(".o") == 4
    assert _build.library_path("ssa").read_text() == "lib"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        ["build.lock", _build.library_path("ssa").name, _build.library_path("lif_parallel").name])


@pytest.mark.parametrize("step", ["-DSSA_PART=0", "-DSSA_PART=1", "-DSSA_PART=2",
                                  "-DSSA_PART=3", "-shared"])
def test_failed_part_fails_the_build(tmp_path, monkeypatch, step):
    """nvcc failing on any part (or on the link) raises with its output and
    leaves no library, object or temporary file behind."""
    fake, _ = _fake_nvcc(tmp_path, fail_on=step)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="nvcc failed for ssa:") as err:
        _build.build(["ssa"])
    assert "nvcc fatal: this step failed" in str(err.value)
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["build.lock"]


def test_ssa_parts_split_the_source(tmp_path):
    """Preprocessed with each ``-DSSA_PART``, ``ssa.cu`` holds each entry
    point, launcher and wide instantiation in its one part, and all of them
    without SSA_PART."""
    import re
    import subprocess

    for header in ("cuda_fp16.h", "cuda_runtime.h"):
        (tmp_path / header).write_text("")

    def defined(*defines):
        text = subprocess.run(["gcc", "-E", "-P", "-x", "c++", f"-I{tmp_path}", *defines,
                               str(_build.SOURCES["ssa"])], capture_output=True, text=True,
                              check=True).stdout
        found = re.findall(r'^(?:extern "C" (?:int|const char\*) |int |template int )'
                           r"(\w+(?:<\d+>)?)\(", text, flags=re.M)
        return [f for f in found if f in SSA_PART_OF]

    for part in range(_build.PARTS["ssa"][1]):
        assert sorted(defined(f"-DSSA_PART={part}")) == sorted(
            f for f, p in SSA_PART_OF.items() if p == part)
    assert sorted(defined()) == sorted(SSA_PART_OF)
