"""The port's ``core/nn.py`` takes the JAX package's arguments: ``conv_apply``
at any kernel size with ``stride`` and ``padding`` ("SAME" / "VALID", XLA's
meaning: SAME pads ``max((ceil(H/s) - 1)·s + k - H, 0)`` zeros, one more on
the high side where that is odd), ``maxpool`` with ``window`` and ``stride``,
and ``linear_init`` / ``conv_init`` / ``bn_init`` with ``bias=`` and
``dtype=``.

Tolerances, each with its reason:
* ``conv_apply`` values and both gradients: ``rtol=1e-5, atol=1e-5`` (f32
  sums of at most 3·3·4 products for the values and the input gradient, of
  2·9·8 for the weight gradient, in another order than XLA's).
* ``maxpool`` values and gradient: exact.  The input is binary, so most
  windows hold tied maxima and the gradient must reach the element the
  reference's ``reduce_window`` VJP picks (the first, row-major); the
  cotangent is integer-valued, so the sums that overlapping windows add at
  one element are exact in any order.
* the inits: the same tree, shapes and dtypes (the values come from each
  package's own generator)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import nn as tnn

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
H, W, C_IN, C_OUT = 9, 8, 4, 5      # one odd and one even spatial size


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import nn as jnn

    return jax, jnp, jnn


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_conv_apply_vs_jax(ref, k, stride, padding):
    jax, jnp, jnn = ref
    rng = np.random.default_rng(100 * k + 10 * stride + (padding == "SAME"))
    x = rng.normal(size=(2, H, W, C_IN)).astype(np.float32)
    p = {"w": rng.normal(size=(k, k, C_IN, C_OUT)).astype(np.float32),
         "b": rng.normal(size=(C_OUT,)).astype(np.float32)}
    want, vjp = jax.vjp(lambda p_, x_: jnn.conv_apply(p_, x_, stride=stride, padding=padding),
                        p, x)
    g = rng.normal(size=want.shape).astype(np.float32)
    dp, dx = vjp(g)

    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {n: torch.from_numpy(v).requires_grad_(True) for n, v in p.items()}
    got = tnn.conv_apply(pt, xt, stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CONV_TOL)
    gx, gw, gb = torch.autograd.grad(got, (xt, pt["w"], pt["b"]), torch.from_numpy(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(dx), **CONV_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(dp["w"]), **CONV_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(dp["b"]), **CONV_TOL)


def test_conv_apply_odd_stride1_same_is_the_symmetric_conv():
    """The engine's and the vision model's call (odd kernel, the defaults)
    is the one convolution it was before the arguments came: ``F.conv2d``
    with SAME padding, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, H, W, C_IN), generator=gen)
    for k in (1, 3, 5):
        w = torch.randn((k, k, C_IN, C_OUT), generator=gen)
        want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding="same")
        assert torch.equal(tnn.conv_apply({"w": w}, x), want.permute(0, 2, 3, 1))


def test_conv_apply_rejects_unknown_padding():
    with pytest.raises(ValueError, match="SAME"):
        tnn.conv_apply({"w": torch.zeros((3, 3, 1, 1))}, torch.zeros((1, 4, 4, 1)),
                       padding="FULL")


@pytest.mark.parametrize("stride", [1, 2, None], ids=["s1", "s2", "sNone"])
@pytest.mark.parametrize("window", [2, 3])
def test_maxpool_vs_jax(ref, window, stride):
    jax, _, jnn = ref
    rng = np.random.default_rng(10 * window + (stride or 0))
    x = rng.integers(0, 2, (2, H, W, 3)).astype(np.float32)
    x[:, :window, :window, :] = 1.0            # a window tied in every place
    want, vjp = jax.vjp(lambda x_: jnn.maxpool(x_, window=window, stride=stride), x)
    g = rng.integers(-4, 5, want.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tnn.maxpool(xt, window=window, stride=stride)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(vjp(g)[0]))


def _tree_shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False, None], ids=["bias", "nobias", "default"])
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_init_forms_vs_jax(ref, kind, bias, dtype):
    jax, jnp, jnn = ref
    kw_j = {"dtype": getattr(jnp, dtype)}
    kw_t = {"dtype": getattr(torch, dtype)}
    if bias is not None:
        kw_j["bias"] = kw_t["bias"] = bias
    gen = torch.Generator().manual_seed(0)
    if kind == "linear":
        want = jnn.linear_init(jax.random.PRNGKey(0), 6, 3, **kw_j)
        got = tnn.linear_init(gen, 6, 3, **kw_t)
    else:
        want = jnn.conv_init(jax.random.PRNGKey(0), 4, 5, 3, **kw_j)
        got = tnn.conv_init(gen, 4, 5, 3, **kw_t)
    assert _tree_shapes(got) == _tree_shapes(want)
    if "b" in got:
        assert not got["b"].any()
    scale = 1 / np.sqrt(6 if kind == "linear" else 4 * 9)
    assert float(got["w"].abs().max()) <= scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", None], ids=["f32", "bf16", "default"])
def test_bn_init_vs_jax(ref, dtype):
    _, jnp, jnn = ref
    want = jnn.bn_init(7) if dtype is None else jnn.bn_init(7, getattr(jnp, dtype))
    got = tnn.bn_init(7) if dtype is None else tnn.bn_init(7, getattr(torch, dtype))
    for g, w in zip(got, want):
        assert _tree_shapes(g) == _tree_shapes(w)
        for k in g:
            np.testing.assert_array_equal(g[k].float().numpy(), np.asarray(w[k], np.float32))


def test_linear_init_default_draw_unchanged():
    """``bias``/``dtype`` leave the default f32 draw as it was: the vision
    model's seeded weights do not move."""
    a = tnn.linear_init(torch.Generator().manual_seed(3), 8, 4)
    b = torch.empty((8, 4)).uniform_(-8 ** -0.5, 8 ** -0.5,
                                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(a["w"], b) and torch.equal(a["b"], torch.zeros(4))
