"""The port's dry run (``launch/dryrun.py``) held against the JAX package's
shardings (the twin of ``tests/test_dryrun_small.py``).  No 512-device
program is compiled: the JAX side's per-device shapes come from
``NamedSharding(AbstractMesh(shape, axes), sanitize_spec(...)).shard_shape``
on ``jax.eval_shape`` structs, the port's from ``build_cell`` on meta.

At ``ShapeCell("tiny_train", 64, 4, "train")`` of ``llama3.2-1b_smoke`` on one
device the arguments hold 1,086,216 bytes in both packages; XLA's
``memory_analysis`` of the compiled JAX step reads 1,086,212, since it drops
the 4-byte ``grad_norm`` scalar the step never reads.  The FLOPs on meta are
``torch.utils.flop_counter``'s count of the port's step (205,520,896 there),
held against ``FlopCounterMode`` on a real CPU step; XLA's ``cost_analysis``
counts another program (119,203,648), so no test equates the two.
"""

import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import lm as tlm
from repro_torch.models.config import SHAPE_CELLS, ShapeCell, cell_by_name, cell_supported

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ROOT = Path(__file__).resolve().parents[1]
TINY = ShapeCell("tiny_train", 64, 4, "train")
PRESETS = ("base", "zero2", "fsdp", "sp")
# the collective kinds the JAX package's dry run counts (``collective_bytes``)
JAX_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"}


@pytest.fixture(scope="module")
def jdry():
    """The JAX package's dry-run helpers.  Importing ``repro.launch.dryrun``
    sets XLA_FLAGS to force 512 host devices; the CPU backend is initialised
    first, so this process keeps its one device, and the variable is put
    back for any process started later."""
    import jax

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jd


def _jax_shards(jd, arch, cell, multi_pod, preset):
    """{leaf name: (global shape, per-device shape, itemsize)} of the
    reference's arguments for this cell, as its ``build_cell`` shards them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

    from repro.distributed.sharding import make_rules
    from repro.models import lm as jlm
    from repro.models import transformer as JT
    from repro.optim.optimizer import OptimizerConfig, make_optimizer

    cfg = jlm.get_config(arch)
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))
    rules = make_rules(multi_pod=multi_pod, preset=preset)
    is_p = lambda x: isinstance(x, P)
    param_specs = JT.param_pspecs(cfg)
    opt_param_specs = param_specs
    if rules.get("params") == "replicated":
        param_specs = jax.tree_util.tree_map(lambda s: P(), param_specs, is_leaf=is_p)
    params = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), cfg))
    batch_specs = jd._batch_pspec_tree(cfg, cell, rules["batch"])
    batch = jlm.batch_struct(cfg, cell)
    if cell.kind == "train":
        opt = make_optimizer(OptimizerConfig(kind=cfg.opt_kind, b1=cfg.opt_b1,
                                             state_dtype=cfg.opt_state_dtype,
                                             master_weights=cfg.opt_master_weights))
        opt_struct = jax.eval_shape(opt.init, params)
        structs = ({"params": params, "opt_state": opt_struct,
                    "step": jax.ShapeDtypeStruct((), jnp.int32)}, batch)
        specs = ({"params": param_specs,
                  "opt_state": jd._opt_specs(cfg, opt_struct, opt_param_specs, params),
                  "step": P()}, batch_specs)
    elif cell.kind == "prefill":
        structs, specs = (params, batch), (param_specs, batch_specs)
    else:
        structs = (params, jlm.cache_struct(cfg, cell), batch,
                   jax.ShapeDtypeStruct((), jnp.int32))
        specs = (param_specs, JT.cache_pspecs(cfg), batch_specs, P())
    out = {}
    flat_specs = jax.tree_util.tree_leaves(specs, is_leaf=is_p)
    flat_structs = jax.tree_util.tree_flatten_with_path(structs)[0]
    assert len(flat_specs) == len(flat_structs)
    for (path, s), spec in zip(flat_structs, flat_specs):
        shard = NamedSharding(mesh, jd.sanitize_spec(mesh, spec, s.shape)).shard_shape(s.shape)
        out["/".join(str(k) for k in path)] = (tuple(s.shape), tuple(shard),
                                               np.dtype(s.dtype).itemsize)
    return out


def _port_shards(arch, cell, multi_pod, preset):
    c = D.build_cell(arch, cell, multi_pod=multi_pod, preset=preset)
    return {name: (shape, per, dt.itemsize) for name, shape, _, per, dt in c.shards()}, c


CASES = [(arch, cell.name) for arch in ASSIGNED_ARCHS for cell in SHAPE_CELLS]


@pytest.mark.parametrize("arch,cell", CASES)
def test_shard_shapes_and_argument_bytes_match_reference(jdry, arch, cell):
    """Every argument leaf's per-device shape (params, AdamW or Adafactor
    state, batch, cache) on both production meshes under the four presets,
    and the per-device argument bytes, equal the JAX package's."""
    from repro.models.config import cell_by_name

    for multi_pod in (False, True):
        for preset in PRESETS:
            want = _jax_shards(jdry, arch, cell_by_name(cell), multi_pod, preset)
            got, c = _port_shards(arch, cell, multi_pod, preset)
            assert got == want, (arch, cell, multi_pod, preset)
            assert c.argument_bytes() == sum(math.prod(per) * n for _, per, n in want.values())


def test_sanitize_spec_matches_reference(jdry):
    from jax.sharding import AbstractMesh, PartitionSpec as P

    for multi_pod in (False, True):
        jmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
                 else AbstractMesh((16, 16), ("data", "model")))
        mesh = D.production_mesh(multi_pod)
        assert mesh.shape == dict(jmesh.shape)
        for spec, shape in [(("data", "model"), (49155, 2048)), (("model", "data"), (64, 48)),
                            ((None, "data", None, "model"), (2, 40, 7, 32)),
                            ((("data", "model"),), (512, 3)), ((("data", "model"),), (300,)),
                            ((), (4, 4)), (("data",), ())]:
            want = tuple(jdry.sanitize_spec(jmesh, P(*spec), shape))
            assert D.sanitize_spec(mesh, spec, shape) == want, (spec, shape)
    assert D.production_mesh(False).tag == "pod16x16"
    assert D.production_mesh(True).tag == "pod2x16x16"


def test_tiny_train_argument_bytes_on_one_device():
    """1,086,216 bytes: the JAX structs' sum (XLA's memory_analysis reads
    1,086,212 without the unused grad_norm scalar)."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.models import transformer as JT
    from repro.optim.optimizer import OptimizerConfig, make_optimizer

    cfg = jlm.get_config("llama3.2-1b_smoke")
    params = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), cfg))
    opt = make_optimizer(OptimizerConfig())
    structs = ({"params": params, "opt_state": jax.eval_shape(opt.init, params),
                "step": jax.ShapeDtypeStruct((), jnp.int32)}, jlm.batch_struct(cfg, TINY))
    want = sum(math.prod(s.shape) * np.dtype(s.dtype).itemsize
               for s in jax.tree_util.tree_leaves(structs))
    one = D.AbstractMesh((1, 1), ("data", "model"))
    c = D.build_cell("llama3.2-1b_smoke", TINY, mesh=one)
    assert c.argument_bytes() == want == 1_086_216


def _real_step_flops(arch, cell, cfg):
    """FlopCounterMode over the same step on real CPU tensors."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer

    params = T.init_lm(0, cfg, device="cpu")
    gen = np.random.default_rng(0)
    batch = {k: (torch.from_numpy(gen.integers(0, cfg.vocab_size, tuple(v.shape)).astype(np.int32))
                 if v.dtype == torch.int32 else torch.randn(tuple(v.shape), dtype=v.dtype))
             for k, v in tlm.batch_struct(cfg, cell).items()}
    with FlopCounterMode(display=False) as fc:
        if cell.kind == "train":
            opt = make_optimizer(OptimizerConfig(kind=cfg.opt_kind, b1=cfg.opt_b1,
                                                 state_dtype=cfg.opt_state_dtype))
            state = {"params": params, "opt_state": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
            tlm.make_train_step(cfg, opt)(state, batch)
        elif cell.kind == "prefill":
            tlm.make_prefill_step(cfg)(params, batch)
        else:
            cache = T.cache_init(cfg, cell.global_batch, cell.seq_len, device="cpu")
            tlm.make_serve_step(cfg)(params, cache, batch, cell.seq_len - 1)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["llama3.2-1b_smoke", "granite-moe-3b-a800m_smoke",
                                  "mamba2-130m_smoke", "recurrentgemma-9b_smoke",
                                  "kimi-k2-1t-a32b_smoke"])
def test_flops_on_meta_equal_a_real_cpu_step(arch):
    one = D.AbstractMesh((1, 1), ("data", "model"))
    cfg = tlm.get_config(arch)
    for cell in (TINY, ShapeCell("tiny_prefill", 64, 2, "prefill"),
                 ShapeCell("tiny_decode", 64, 2, "decode")):
        rec = D.dryrun_cell(arch, cell, mesh=one, save=False, verbose=False)
        assert rec["status"] == "OK", rec.get("error")
        want = _real_step_flops(arch, cell, cfg)
        assert rec["flops"] == want > 0, (arch, cell.name)
        assert rec["bytes_accessed"] > 0
        assert rec["memory"]["temp_size_in_bytes"] > 0
    if arch == "llama3.2-1b_smoke":
        assert D.dryrun_cell(arch, TINY, mesh=one, save=False,
                             verbose=False)["flops"] == 205_520_896


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_depth_extension_is_exact(arch):
    """FLOPs and bytes summed from the traced depths equal a trace of every
    layer (7 here); the peak's extension stays within the whole trace's
    (measured 62-100% of it, and a few scalars' bytes above it)."""
    cfg = tlm.get_config(arch + "_smoke").replace(num_layers=7, attn_block_q=32,
                                                   attn_block_k=32)
    for cell in (ShapeCell("t", 64, 4, "train"), ShapeCell("p", 128, 2, "prefill"),
                 ShapeCell("d", 64, 2, "decode")):
        got = D.measure(arch, cell, cfg_override=cfg)
        assert got["traced_layers"] == list(range(1, len(got["traced_layers"]) + 1))
        assert len(got["traced_layers"]) < 7
        c, rec = D.build_cell(arch, cell, cfg_override=cfg), D.StepRecorder()
        with rec:
            out = c.call()
        del out
        assert (got["flops"], got["bytes"]) == (rec.flops, rec.bytes), (arch, cell.name)
        assert 0.5 * rec.peak <= got["peak"] <= 1.0001 * rec.peak, (arch, cell.name)


def test_depth_extension_at_full_width():
    """llama3.2-1b's 16-layer training step of 4 x 512 tokens (chip_smoke.py
    phase 15's): FLOPs and bytes from depths 1-3 equal the whole trace's; the
    peak's extension is a lower bound, 59% of the whole trace's (the
    module's docstring), because the leaf whose AdamW update sets the peak
    changes past the traced depths."""
    arch, cell = "llama3.2-1b", ShapeCell("phase15_train", 512, 4, "train")
    got = D.measure(arch, cell)
    assert got["traced_layers"] == [1, 2, 3]
    c, rec = D.build_cell(arch, cell), D.StepRecorder()
    with rec:
        out = c.call()
    del out
    assert (got["flops"], got["bytes"]) == (rec.flops, rec.bytes)
    assert got["peak"] <= rec.peak
    assert round(got["peak"] / rec.peak, 2) == 0.59


def test_skips_match_reference_and_production_record(tmp_path, monkeypatch):
    from repro.models import lm as jlm
    from repro.models.config import cell_supported as jsupported

    for arch in ASSIGNED_ARCHS:
        for cell in SHAPE_CELLS:
            assert cell_supported(tlm.get_config(arch), cell) == jsupported(
                jlm.get_config(arch), cell), (arch, cell.name)
    monkeypatch.setattr(D, "ARTIFACT_DIR", tmp_path)
    skip = D.dryrun_cell("llama3.2-1b", "long_500k", verbose=False)
    assert skip["status"] == "SKIP" and "sub-quadratic" in skip["reason"]
    rec = D.dryrun_cell("llama3.2-1b", "decode_32k", multi_pod=True, verbose=False)
    assert rec["status"] == "OK" and rec["mesh"] == "pod2x16x16" and rec["num_devices"] == 512
    assert set(rec["collective_bytes_per_device"]) <= JAX_KINDS and "collective_note" not in rec
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and "trace_s" in rec
    saved = json.loads((tmp_path / "llama3.2-1b__decode_32k__pod2x16x16.json").read_text())
    assert saved == rec


def test_failed_build_is_recorded_and_the_sweep_goes_on(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ARTIFACT_DIR", tmp_path)

    def broken(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(D, "measure", broken)
    recs = D.sweep(["llama3.2-1b_smoke"], ["train_4k", "long_500k"], [False], verbose=False)
    assert [r["status"] for r in recs] == ["FAIL", "SKIP"]
    assert "no such step" in recs[0]["error"] and "Traceback" in recs[0]["traceback"]


def test_cli_writes_only_under_dryrun_torch(tmp_path, monkeypatch, capsys):
    assert D.ARTIFACT_DIR == ROOT / "artifacts" / "dryrun_torch"
    ref_dir = ROOT / "artifacts" / "dryrun"
    existed = ref_dir.exists()
    out = tmp_path / "artifacts" / "dryrun_torch"
    monkeypatch.setattr(D, "ARTIFACT_DIR", out)
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "llama3.2-1b_smoke", "--cell", "train_4k", "--both-meshes"])
    assert e.value.code == 0
    assert "done: 2 OK, 0 SKIP, 0 FAIL" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.rglob("*.json")) == [
        "llama3.2-1b_smoke__train_4k__pod16x16.json",
        "llama3.2-1b_smoke__train_4k__pod2x16x16.json"]
    assert all(p.parent == out for p in tmp_path.rglob("*.json"))
    assert ref_dir.exists() == existed


def test_lower_on_host_mesh():
    """The twin of the reference's: the full build_cell path records the
    tiny training step on a one-device mesh."""
    one = D.AbstractMesh((1, 1), ("data", "model"))
    rec = D.dryrun_cell("llama3.2-1b_smoke", TINY, mesh=one, save=False, verbose=False)
    assert rec["status"] == "OK" and rec["mesh"] == "pod1x1" and rec["flops"] > 0


def test_mesh_factory_shapes():
    assert batch_axes(False) == ("data",)
    assert batch_axes(True) == ("pod", "data")
    assert D.production_mesh(False).shape == {"data": 16, "model": 16}
    assert D.production_mesh(True).size == 512


# -- the sharded step's records ---------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_collective_bytes_of_dense_records(arch):
    """Every arch's decode_32k record (and long_500k's, where the arch runs
    it) on both production meshes carries its recorded rank's collective
    operand bytes under the JAX package's kind names, and no
    ``collective_note``: kimi's carry the MoE's all-to-all (384 experts on
    ``data`` = 16), granite's none (its 40 experts stay whole); a
    recurrentgemma long_500k record is of ``model`` rank 15, the writer of
    ring slot 2047 of 2048."""
    cfg = tlm.get_config(arch)
    for cell in ("decode_32k", "long_500k"):
        for multi_pod in (False, True):
            rec = D.dryrun_cell(arch, cell, multi_pod=multi_pod, save=False, verbose=False)
            if rec["status"] == "SKIP":
                assert cell == "long_500k" and not cfg.supports_long_context
                continue
            assert rec["status"] == "OK", rec.get("error")
            coll = rec["collective_bytes_per_device"]
            assert coll and set(coll) <= JAX_KINDS and all(v > 0 for v in coll.values())
            assert "all-reduce" in coll and "collective_note" not in rec
            assert ("all-to-all" in coll) == (arch == "kimi-k2-1t-a32b"), (arch, cell, coll)
    if arch == "recurrentgemma-9b":
        mesh = D.production_mesh(False)
        assert D.recorded_ranks(cfg, cell_by_name("long_500k"), mesh) == {"model": 15}
        assert D.recorded_ranks(cfg, cell_by_name("decode_32k"), mesh) == {"model": 15}
    if arch == "mamba2-130m":
        assert D.recorded_ranks(cfg, cell_by_name("long_500k"), D.production_mesh(True)) == {}


def test_train_record_of_llama_on_both_meshes():
    """llama3.2-1b's train_4k: the gathers, the psums and the gradients'
    reduce-scatter all appear, and the multi-pod record adds the pod
    all-reduce of every gradient."""
    single = D.dryrun_cell("llama3.2-1b", "train_4k", save=False, verbose=False)
    multi = D.dryrun_cell("llama3.2-1b", "train_4k", multi_pod=True, save=False, verbose=False)
    for rec in (single, multi):
        assert set(rec["collective_bytes_per_device"]) == {"all-gather", "all-reduce",
                                                           "reduce-scatter"}
    assert (multi["collective_bytes_per_device"]["reduce-scatter"]
            == single["collective_bytes_per_device"]["reduce-scatter"])
    assert multi["flops"] < single["flops"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1, 2)])
def test_collective_extension_is_exact(shape):
    """The collective bytes (and FLOPs and bytes) of the sharded step
    summed from the traced depths equal a trace of every layer (5 here) on
    a record-only mesh."""
    from repro_torch.launch.mesh import record_only_mesh

    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = record_only_mesh(shape, axes)
    arch = "llama3.2-1b_smoke"
    cfg = tlm.get_config(arch).replace(num_layers=5, attn_block_q=32, attn_block_k=32)
    for cell in (ShapeCell("t", 64, 4, "train"), ShapeCell("p", 128, 4, "prefill"),
                 ShapeCell("d", 64, 4, "decode")):
        got = D.measure(arch, cell, cfg_override=cfg, mesh=mesh)
        assert len(got["traced_layers"]) < 5
        c, rec = D.build_cell(arch, cell, cfg_override=cfg, mesh=mesh), D.StepRecorder()
        with rec:
            out = c.call()
        del out
        assert got["collectives"] == rec.collectives and rec.collectives, cell.name
        assert (got["flops"], got["bytes"]) == (rec.flops, rec.bytes), cell.name


@pytest.mark.parametrize("arch", ["llama3.2-1b_smoke", "paligemma-3b_smoke",
                                  "musicgen-large_smoke", "granite-moe-3b-a800m_smoke",
                                  "mamba2-130m_smoke", "recurrentgemma-9b_smoke"])
def test_one_device_shard_equals_the_whole_step(arch):
    """On a 1x1 record-only mesh the sharded step's FLOPs, bytes and peak
    equal the single-device step's exactly, and it records no collective."""
    from repro_torch.launch.mesh import record_only_mesh

    one = record_only_mesh((1, 1))
    for cell in (TINY, ShapeCell("tiny_prefill", 64, 2, "prefill"),
                 ShapeCell("tiny_decode", 64, 2, "decode")):
        whole, shard = D.measure(arch, cell), D.measure(arch, cell, mesh=one)
        assert shard == {**whole, "collectives": {}}, (arch, cell.name)


def test_sweep_statuses(monkeypatch, tmp_path):
    """Every (arch, cell, mesh) builds its step -- the SPMD step of a rank of
    the record-only production mesh -- and the statuses are 64 OK, 16 SKIP,
    0 FAIL.  The traces
    themselves are stubbed here (the whole sweep takes minutes; the records
    above trace the cells whole); ``chip_smoke.py`` phase 15 runs it
    unstubbed."""
    monkeypatch.setattr(D, "ARTIFACT_DIR", tmp_path)
    built = []

    def stub(arch, cell, *, cfg_override=None, mesh=None):
        cfg = tlm.get_config(arch).replace(num_layers=1)
        c = D.build_cell(arch, cell, cfg_override=cfg, mesh=mesh)
        built.append((arch, cell.name, None if mesh is None else mesh.shape, c.local is not None))
        return {"flops": 1, "bytes": 1, "peak": 1, "collectives": {}, "traced_layers": [1]}

    monkeypatch.setattr(D, "measure", stub)
    recs = D.sweep(ASSIGNED_ARCHS, [c.name for c in SHAPE_CELLS], [False, True], verbose=False)
    n = {s: sum(r["status"] == s for r in recs) for s in ("OK", "SKIP", "FAIL")}
    assert n == {"OK": 64, "SKIP": 16, "FAIL": 0}, [r.get("error") for r in recs]
    assert sum(local for *_, local in built) == 64        # every OK record: a rank's SPMD step
    assert {shape for _, _, shape, local in built if local} == {(16, 16), (2, 16, 16)}


def test_decode_record_is_the_cache_writing_rank():
    """A dense decode record is of the ``model`` rank that owns the new
    token's slot, ``pos = seq_len - 1`` (the last, where ``model`` splits
    the cache): its bytes and peak exceed rank 0's by the copy of its cache
    block, its collectives equal rank 0's; the other steps are rank 0's."""
    arch, cell = "llama3.2-1b_smoke", ShapeCell("d", 64, 4, "decode")
    mesh = D.AbstractMesh((1, 2), ("data", "model"))
    cfg = tlm.get_config(arch)
    assert D.recorded_ranks(cfg, cell, mesh) == {"model": 1}
    assert D.recorded_ranks(cfg, TINY, mesh) == {}
    assert D.recorded_ranks(cfg, ShapeCell("d", 63, 4, "decode"), mesh) == {}   # cache not split
    ring = tlm.get_config("recurrentgemma-9b_smoke")                          # window 16
    assert D.recorded_ranks(ring, ShapeCell("d", 64, 4, "decode"), mesh) == {"model": 1}
    assert D.recorded_ranks(ring, ShapeCell("d", 40, 4, "decode"), mesh) == {"model": 0}
    writer = D.measure(arch, cell, mesh=mesh.record_only({"model": 1}))
    other = D.measure(arch, cell, mesh=mesh.record_only())
    assert writer["collectives"] == other["collectives"] and writer["flops"] == other["flops"]
    assert writer["bytes"] > other["bytes"] and writer["peak"] > other["peak"]
    rec = D.dryrun_cell(arch, cell, mesh=mesh, save=False, verbose=False)
    assert rec["bytes_accessed"] == writer["bytes"]
    assert rec["memory"]["temp_size_in_bytes"] == writer["peak"]


def test_sweep_in_worker_processes_equals_one_process(tmp_path, monkeypatch):
    """``sweep(workers=2)``, an arch to each spawned process, gives the
    records of one process (but for ``trace_s``) in the same order, and the
    caller saves them."""
    monkeypatch.setattr(D, "ARTIFACT_DIR", tmp_path)
    args = (["llama3.2-1b_smoke", "mamba2-130m_smoke"], ["decode_32k", "long_500k"],
            [False, True])
    strip = lambda recs: [{k: v for k, v in r.items() if k != "trace_s"} for r in recs]
    one = D.sweep(*args, verbose=False)
    assert [r["status"] for r in one].count("OK") == 6 and len(one) == 8
    assert strip(D.sweep(*args, verbose=False, workers=2)) == strip(one)
    assert len(list(tmp_path.glob("*.json"))) == 8
