"""The port's spike GEMM and its conv wrappers held against the JAX package's
Pallas kernel (interpret mode) and its XLA conv, at ragged shapes; plus the
NHWC/HWIO conv, maxpool and BN folding primitives.  Tolerance rtol = atol =
1e-5: the sums run in another order than XLA's (f32 reassociation).  Tests
marked ``cuda`` hold the CUDA kernel against its plain version on the card."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import nn as tnn
from repro_torch.kernels.spike_matmul import ops as tops

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    from repro.core import nn as jnn
    from repro.kernels.spike_matmul import ops as jops

    return SimpleNamespace(nn=jnn, ops=jops)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _spikes(seed, shape):
    return (np.random.default_rng(seed).random(shape) > 0.6).astype(np.float32)


def _weights(seed, shape):
    return np.random.default_rng(seed).normal(0, 0.3, shape).astype(np.float32)


@pytest.mark.parametrize("m,k,c", [(130, 200, 70), (7, 432, 96), (300, 33, 129)])
def test_spike_matmul_vs_pallas_kernel(ref, m, k, c):
    x, w = _spikes(m, (m, k)), _weights(k, (k, c))
    want = ref.ops.spike_matmul_op(x, w, interpret=True)
    got = tops.spike_matmul_op(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (m, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 7, 5, 6), (1, 6, 6, 16, 3)])
def test_conv3x3_vs_pallas_kernel_and_xla_conv(ref, n, h, w, cin, cout):
    """Random non-symmetric HWIO weights: a channel-major im2col (the order of
    ``F.unfold``) pairs patch columns with the wrong weight rows and fails."""
    x, wt = _spikes(h, (n, h, w, cin)), _weights(cin, (3, 3, cin, cout))
    got = tops.conv3x3_op(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.ops.conv3x3_op(x, wt, interpret=True)),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(ref.nn.conv_apply({"w": wt}, x)), **TOL)


def test_im2col_column_order_is_hwio():
    x = torch.arange(2 * 3 * 3 * 4, dtype=torch.float32).reshape(2, 3, 3, 4)
    cols = tops._im2col(x).reshape(2, 3, 3, 9, 4)          # (.., i*3+j, c)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for i in range(3):
        for j in range(3):
            assert torch.equal(cols[:, :, :, i * 3 + j, :], xp[:, i:i + 3, j:j + 3, :])


def test_conv1x1_vs_pallas_kernel(ref):
    x, w = _spikes(1, (2, 5, 3, 24)), _weights(2, (24, 10))
    want = ref.ops.conv1x1_op(x, w, interpret=True)
    got = tops.conv1x1_op(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,c", [(0, 8, 4), (5, 0, 4), (5, 8, 0)])
def test_zero_sized_dims_never_reach_the_kernel(m, k, c):
    got = tops.spike_matmul_op(torch.ones((m, k)), torch.ones((k, c)))
    assert got.shape == (m, c) and not got.any()


def test_analog_conv_and_maxpool_vs_jax(ref):
    """The encoding conv (NHWC/HWIO around F.conv2d) and the 2x2 VALID pool."""
    x = np.random.default_rng(3).random((2, 10, 10, 3)).astype(np.float32)
    p = {"w": _weights(4, (3, 3, 3, 8)), "b": _weights(5, (8,))}
    got = tnn.conv_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.nn.conv_apply(p, x)), **TOL)
    np.testing.assert_array_equal(tnn.maxpool(got).numpy(),
                                  np.asarray(ref.nn.maxpool(got.numpy())))


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_bn_folding_vs_jax(ref, kind):
    rng = np.random.default_rng(6)
    shape = (3, 3, 4, 8) if kind == "conv" else (16, 8)
    layer = {"w": _weights(7, shape), "b": _weights(8, (8,))}
    bn_p = {"scale": rng.uniform(0.7, 1.3, 8).astype(np.float32),
            "bias": rng.normal(0, 0.2, 8).astype(np.float32)}
    bn_s = {"mean": rng.normal(0, 0.2, 8).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    fold_j = ref.nn.fold_conv_bn if kind == "conv" else ref.nn.fold_linear_bn
    fold_t = tnn.fold_conv_bn if kind == "conv" else tnn.fold_linear_bn
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    want, got = fold_j(layer, bn_p, bn_s), fold_t(t(layer), t(bn_p), t(bn_s))
    for key in ("w", "b"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,c", [(130, 200, 70), (257, 432, 96), (1, 1, 1),
                                   (300, 1536, 384),
                                   (33000, 75, 257)])   # many tiles, ragged in every dim
def test_spike_matmul_kernel_vs_plain_on_card(card, m, k, c):
    x = torch.from_numpy(_spikes(m, (m, k))).to(card)
    w = torch.from_numpy(_weights(k, (k, c))).to(card)
    before = tops.spike_matmul_fwd.launches
    got = tops.spike_matmul_op(x, w)
    torch.cuda.synchronize()
    assert tops.spike_matmul_fwd.launches == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_conv3x3_kernel_vs_plain_on_card(card):
    x = torch.from_numpy(_spikes(9, (2, 9, 7, 5))).to(card)
    w = torch.from_numpy(_weights(10, (3, 3, 5, 6))).to(card)
    torch.testing.assert_close(tops.conv3x3_op(x, w), tnn.conv_apply({"w": w}, x),
                               rtol=1e-5, atol=1e-5)
