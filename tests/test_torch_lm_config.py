"""The port's copy of the architecture configs and of the generic LM's trees
held against the JAX package: ``ArchConfig``'s fields and defaults, the twenty
registered configs field by field, the shape cells, the full configs'
parameter trees built on the ``meta`` device against
``jax.eval_shape(init_lm)`` (the 123B and 1T configs included, with no
memory), the shardings, the decode caches and batch inputs of every shape
cell, and ``bridge`` carrying a mixed bf16/f32 tree both ways bit for bit.
All exact."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.models import config as tconfig
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as TT

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ALL_ARCHS = [a for arch in ASSIGNED_ARCHS for a in (arch, arch + "_smoke")]

# test_models_smoke.py::test_full_config_param_counts' ranges
PARAM_RANGES = {
    "llama3.2-1b": (1.0e9, 1.7e9),
    "qwen3-8b": (7e9, 9.5e9),
    "mistral-large-123b": (1.1e11, 1.35e11),
    "kimi-k2-1t-a32b": (0.95e12, 1.15e12),
    "mamba2-130m": (1.1e8, 1.6e8),
    "granite-moe-3b-a800m": (2.6e9, 3.6e9),
    "recurrentgemma-9b": (7.5e9, 1.05e10),
    "paligemma-3b": (2.0e9, 3.2e9),
    "qwen1.5-4b": (3.0e9, 4.5e9),
    "musicgen-large": (2.2e9, 3.0e9),
}

_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax

    from repro.models import config as jconfig
    from repro.models import lm as jlm
    from repro.models import transformer as JT
    return dataclasses.make_dataclass("J", ["jax", "config", "lm", "T"])(jax, jconfig, jlm, JT)


def _flat(tree) -> dict:
    return dict(flatten_with_names(tree))


def _shapes(tree):
    """path -> (shape, torch dtype) of a port tree or a JAX one."""
    out = {}
    for k, v in _flat(tree).items():
        dt = v.dtype if isinstance(v, torch.Tensor) else _DTYPE[np.dtype(v.dtype).name]
        out[k] = (tuple(v.shape), dt)
    return out


def _specs(tree):
    """A JAX spec tree (``PartitionSpec`` leaves) as the port's tuples."""
    from jax.sharding import PartitionSpec

    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(v) for v in tree]
    assert isinstance(tree, PartitionSpec)
    return tuple(tree)


def test_archconfig_fields_and_defaults(J):
    want = [(f.name, f.default) for f in dataclasses.fields(J.config.ArchConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tconfig.ArchConfig)]
    assert got == want
    assert len(got) == 44


def test_registry_and_shape_cells(J):
    from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED

    assert tlm.list_archs() == J.lm.list_archs() == sorted(ALL_ARCHS)
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert [dataclasses.astuple(c) for c in tconfig.SHAPE_CELLS] == [
        dataclasses.astuple(c) for c in J.config.SHAPE_CELLS]
    for cell in J.config.SHAPE_CELLS:
        assert dataclasses.astuple(tconfig.cell_by_name(cell.name)) == dataclasses.astuple(cell)
        for arch in ALL_ARCHS:
            assert (tconfig.cell_supported(tlm.get_config(arch), tconfig.cell_by_name(cell.name))
                    == J.config.cell_supported(J.lm.get_config(arch), cell))
    with pytest.raises(KeyError):
        tconfig.cell_by_name("nope")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_equal_field_by_field(J, arch):
    got, want = tlm.get_config(arch), J.lm.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.resolved_head_dim, got.d_inner, got.ssm_heads) == (
        want.resolved_head_dim, want.d_inner, want.ssm_heads)
    assert TT.layer_kinds(got) == J.T.layer_kinds(want)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_meta_tree_matches_eval_shape(J, arch):
    """The full config's parameter tree on ``meta`` (no memory) equals
    ``jax.eval_shape(init_lm)`` leaf for leaf, and so do the shardings."""
    cfg = tlm.get_config(arch)
    jax = J.jax
    want = jax.eval_shape(lambda: J.T.init_lm(jax.random.PRNGKey(0), J.lm.get_config(arch)))
    got = TT.init_lm(0, cfg, device="meta")
    assert all(t.device.type == "meta" for t in bridge.leaves(got))
    assert _shapes(got) == _shapes(want)
    n = TT.num_params(got)
    lo, hi = PARAM_RANGES[arch]
    assert lo <= n <= hi, f"{arch}: {n:.3e} params not in [{lo:.1e}, {hi:.1e}]"
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))
    assert TT.param_pspecs(cfg) == _specs(J.T.param_pspecs(J.lm.get_config(arch)))
    assert TT.cache_pspecs(cfg) == _specs(J.T.cache_pspecs(J.lm.get_config(arch)))
    # the optimizer state's shardings take the port's spec tuples as they are
    from repro.optim.optimizer import opt_pspecs as j_opt_pspecs

    from repro_torch.optim.optimizer import opt_pspecs
    assert opt_pspecs(TT.param_pspecs(cfg), cfg.opt_kind) == _specs(
        j_opt_pspecs(J.T.param_pspecs(J.lm.get_config(arch)), cfg.opt_kind))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_and_batch_structs(J, arch):
    """``cache_struct``, ``batch_struct`` and ``batch_pspecs`` at every shape
    cell equal the JAX package's."""
    cfg, jcfg = tlm.get_config(arch), J.lm.get_config(arch)
    for cell in J.config.SHAPE_CELLS:
        tcell = tconfig.cell_by_name(cell.name)
        assert _shapes(tlm.cache_struct(cfg, tcell)) == _shapes(J.lm.cache_struct(jcfg, cell))
        got = tlm.batch_struct(cfg, tcell)
        assert all(v.device.type == "meta" for v in got.values())
        assert _shapes(got) == _shapes(J.lm.batch_struct(jcfg, cell))
        for axes in (("data",), ("pod", "data")):
            assert tlm.batch_pspecs(cfg, tcell, batch_axes=axes) == _specs(
                J.lm.batch_pspecs(jcfg, cell, batch_axes=axes))


@pytest.mark.parametrize("arch", ["paligemma-3b", "recurrentgemma-9b"])
def test_embed_scale_rounds_in_the_compute_dtype(J, arch):
    """``embed_inputs`` at full width in bf16: sqrt(d_model) is rounded to
    bf16 before the product (sqrt(2048) -> 45.25), bit for bit the JAX
    package's, on a small embedding table."""
    jnp = J.jax.numpy
    cfg = tlm.get_config(arch).replace(vocab_size=16, num_prefix_tokens=3)
    rng = np.random.default_rng(4)
    table = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, 16, (2, 5)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.modality == "vision_stub":
        batch["image_embeds"] = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    want, want_p = J.T.embed_inputs({"embed": {"table": jnp.asarray(table)}},
                                    {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    got, got_p = TT.embed_inputs({"embed": {"table": torch.from_numpy(table)}},
                                 {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert got.dtype == torch.bfloat16 and got_p == want_p
    assert bridge.to_numpy(got).tobytes() == np.asarray(want).tobytes()
    assert torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16).item() in (45.25, 64.0)


def test_bridge_keeps_mixed_dtypes_bit_for_bit(J):
    """``to_torch(dtype=None)`` keeps each leaf's dtype (bf16 by its bits),
    ``to_numpy`` gives the same bits back: a kimi-style tree of bf16 leaves
    with the f32 router."""
    jnp = J.jax.numpy
    rng = np.random.default_rng(0)
    tree = {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
            "moe": {"router": {"w": jnp.asarray(rng.standard_normal((7, 3)), jnp.float32)},
                    "w_up": jnp.asarray(rng.standard_normal((3, 7, 2)) * 1e-20, jnp.bfloat16)},
            "layers": [{"scale": jnp.asarray([1.5, -0.0, np.inf], jnp.bfloat16)}]}
    host = J.jax.tree_util.tree_map(np.asarray, tree)
    got = bridge.to_torch(host, "cpu", None)
    assert got["w"].dtype == got["moe"]["w_up"].dtype == torch.bfloat16
    assert got["moe"]["router"]["w"].dtype == torch.float32
    back = bridge.to_numpy(got)
    for k, v in _flat(host).items():
        b = _flat(back)[k]
        assert b.dtype == v.dtype and b.tobytes() == v.tobytes(), k
    # a bf16 tensor's value equals the JAX array's
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(tree["w"], np.float32))
    # the default (f32) is unchanged
    assert bridge.to_torch(host)["w"].dtype == torch.float32
