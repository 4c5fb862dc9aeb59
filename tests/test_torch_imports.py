"""The port stands alone: it imports neither JAX nor the JAX package, its
copy of the layer layout agrees with the reference's for every vision config,
and its entry points never drop quietly to the CPU."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.configs import spike_iand_former as tconfigs
from repro_torch.core import spikformer as tsf
from repro_torch.engine import layout as tlayout

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_port_imports_neither_jax_nor_the_jax_package():
    assert {"repro_torch.engine.analysis", "repro_torch.kernels.spike_matmul.ops",
            "repro_torch.kernels.spiking_attention.ops", "repro_torch.launch.train",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.scheduler", "repro_torch.core.bundling",
            "repro_torch.core.encoding", "repro_torch.launch.mesh",
            "repro_torch.distributed.sharding", "repro_torch.distributed.compression",
            "repro_torch.distributed.fault_tolerance", "repro_torch.checkpoint.fixtures",
            "repro_torch.optim.optimizer", "repro_torch.configs", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.lm", "repro_torch.models.moe",
            "repro_torch.models.mamba2", "repro_torch.models.rglru",
            "repro_torch.models.transformer", "repro_torch.models.quantization",
            "repro_torch.configs.kimi_k2_1t_a32b", "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.launch.serve", "repro_torch.launch.dryrun"} <= set(_modules())
    from repro_torch.launch.serve import serve
    assert callable(serve)
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def _as_tuples(items):
    return [dataclasses.astuple(x) for x in items]


@pytest.mark.parametrize("arch", tconfigs.list_vision_configs())
def test_layout_copy_matches_reference(arch):
    pytest.importorskip("jax")
    from repro.configs.spike_iand_former import get_vision_config
    from repro.engine import layout as jlayout

    jcfg, tcfg = get_vision_config(arch), tconfigs.get_vision_config(arch)
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    jt, tt = jcfg.tokenizer_config(), tcfg.tokenizer_config()
    assert dataclasses.astuple(tt) == dataclasses.astuple(jt)
    assert _as_tuples(tlayout.tokenizer_layout(tt)) == _as_tuples(jlayout.tokenizer_layout(jt))
    assert tlayout.tokenizer_grid(tt, tcfg.img_size) == jlayout.tokenizer_grid(jt, jcfg.img_size)
    assert _as_tuples(tlayout.block_layout(tcfg)) == _as_tuples(jlayout.block_layout(jcfg))
    assert _as_tuples(tlayout.spike_edges(tcfg)) == _as_tuples(jlayout.spike_edges(jcfg))


def test_compile_plan_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsf.SpikformerConfig(embed_dim=16, num_layers=1, num_heads=2)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg)
    for backend in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="is_available"):
            engine.compile_plan(params, state, cfg, backend=backend)
    with pytest.raises(RuntimeError, match="is_available"):
        engine.compile_plan(params, state, cfg, device="cuda:0")
    assert engine.compile_plan(params, state, cfg, device="cpu").meta.device.type == "cpu"


def test_generic_lm_entry_points_without_a_card_raise(monkeypatch):
    """``init_lm``, ``cache_init`` and the generic ``serve`` run on the card
    unless ``device="cpu"`` (or ``"meta"``) is asked for."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = lm.get_config("llama3.2-1b_smoke")
    for call in (lambda: transformer.init_lm(0, cfg),
                 lambda: transformer.init_lm(0, cfg, device="cuda:0"),
                 lambda: transformer.cache_init(cfg, 1, 4),
                 lambda: serve("llama3.2-1b_smoke", num_requests=1, prompt_len=2, max_new=1,
                               verbose=False)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    params = transformer.init_lm(0, cfg, device="cpu")
    assert {t.device.type for t in bridge.leaves(params)} == {"cpu"}
    assert {t.device.type for t in bridge.leaves(
        transformer.init_lm(0, cfg, device="meta"))} == {"meta"}
    assert serve("llama3.2-1b_smoke", num_requests=1, prompt_len=2, max_new=1, verbose=False,
                 device="cpu")[0][1].shape == (1,)
