"""Weight-only int8 quantization of the port held against the JAX package's
(the twin of ``tests/test_quantization.py``): ``quantize_int8``'s int8 values
and scales equal JAX's (both round half to even), ``quantize_params_int8``
quantizes the same leaves with the same bytes before and after (on a uniform
model only the 2-D embedding and head: a stacked layer leaf is 3-D), the
round trip is within half a step, and a quantized model's logits keep a
cosine above 0.995."""

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as TT
from repro_torch.models.quantization import (dequant, dequantize_params, quantize_int8,
                                             quantize_params_int8)

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores


@pytest.fixture(scope="module")
def jq():
    pytest.importorskip("jax")
    from repro.models import quantization as jq
    return jq


@pytest.mark.parametrize("shape,scale", [((128, 256), 0.02), ((64, 96), 3.0), ((256, 64), 1e-6)])
def test_quantize_int8_equals_jax(jq, shape, scale):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w[0, :4] = [0.5, -0.5, 1.5, -2.5]      # ties, rounded half to even in both
    w[:, 1] = 0.0                          # an all-zero channel
    got, want = quantize_int8(torch.from_numpy(w)), jq.quantize_int8(w)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    w2 = dequant(got, torch.float32).numpy()
    np.testing.assert_array_equal(w2, np.asarray(jq.dequant(want, np.float32)))
    bound = np.abs(w).max(axis=0) / 127.0
    assert np.all(np.abs(w - w2) <= bound[None, :] * 0.5 + 1e-8)


@pytest.mark.parametrize("arch", ["llama3.2-1b_smoke", "recurrentgemma-9b_smoke"])
def test_params_tree_bytes_equal_jax(jq, arch):
    """Same leaves quantized, same bytes before and after, same values; on
    the hybrid model (a list of per-layer dicts) the 2-D layer matrices of
    64 x 64 and up are quantized too."""
    import jax

    from repro.models import lm as jlm
    from repro.models import transformer as JT

    params = JT.init_lm(jax.random.PRNGKey(0), jlm.get_config(arch))
    host = jax.tree_util.tree_map(np.asarray, params)
    want_q, want_before, want_after = jq.quantize_params_int8(params)
    got_q, before, after = quantize_params_int8(bridge.to_torch(host, "cpu", None))
    assert (before, after) == (want_before, want_after)
    assert after < before
    got_flat = _flat(got_q)
    want_flat = _flat(jax.tree_util.tree_map(np.asarray, want_q))
    assert got_flat.keys() == want_flat.keys()
    for k, w in want_flat.items():
        np.testing.assert_array_equal(got_flat[k].numpy(), w, err_msg=k)
    if arch.startswith("llama"):
        assert isinstance(got_q["embed"]["table"], dict)
        assert torch.is_tensor(got_q["layers"]["attn"]["wq"]["w"])   # (L, d, d): passes


def _flat(tree) -> dict:
    return dict(flatten_with_names(tree))


def test_small_tree_shrinks_and_restores():
    gen = torch.Generator().manual_seed(0)
    params = {"big": torch.randn((256, 128), generator=gen), "norm": torch.ones((128,)),
              "tiny": torch.randn((8, 8), generator=gen)}
    q, before, after = quantize_params_int8(params)
    assert after < before * 0.5
    assert isinstance(q["big"], dict) and q["big"]["q"].dtype == torch.int8
    assert q["norm"].dtype == params["norm"].dtype and torch.equal(q["tiny"], params["tiny"])
    restored = dequantize_params(q, torch.float32)
    np.testing.assert_allclose(restored["big"].numpy(), params["big"].numpy(), atol=0.03)
    assert torch.equal(restored["norm"], params["norm"])


def test_quantized_model_quality():
    cfg = tlm.get_config("llama3.2-1b_smoke")
    params = TT.init_lm(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    logits, _, _ = TT.forward(params, {"tokens": tokens}, cfg)
    q, _, _ = quantize_params_int8(params)
    logits_q, _, _ = TT.forward(dequantize_params(q, torch.float32), {"tokens": tokens}, cfg)
    a, b = logits.flatten().double(), logits_q.flatten().double()
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos > 0.995
