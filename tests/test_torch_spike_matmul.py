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
from repro_torch.core import packing as tpk
from repro_torch.kernels.spike_matmul import ops as tops

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    from repro.core import nn as jnn
    from repro.kernels.spike_matmul import ops as jops
    from repro.kernels.spike_matmul import ref as jref

    return SimpleNamespace(nn=jnn, ops=jops, ref=jref)


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


# The oracles the reference's kernel tests use (tests/test_kernels.py), on
# spikes and on analog inputs: f32 sums in another order than XLA's, rtol 1e-5.
ORACLE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("binary", [True, False])
def test_conv_oracles_vs_jax(ref, binary):
    from repro_torch.kernels.spike_matmul.ref import conv1x1_ref, conv3x3_ref

    x = _spikes(3, (2, 8, 7, 16)) if binary else _weights(3, (2, 8, 7, 16))
    w1, w3 = _weights(1, (16, 32)), _weights(2, (3, 3, 16, 32))
    got1 = conv1x1_ref(torch.from_numpy(x), torch.from_numpy(w1))
    got3 = conv3x3_ref(torch.from_numpy(x), torch.from_numpy(w3))
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref.ref.conv1x1_ref(x, w1)),
                               **ORACLE_TOL)
    np.testing.assert_allclose(got3.numpy(), np.asarray(ref.ref.conv3x3_ref(x, w3)),
                               **ORACLE_TOL)
    if binary:   # the reference's own use: the conv wrappers against the oracles
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(tops.conv1x1_op(xt, torch.from_numpy(w1)).numpy(),
                                   got1.numpy(), **ORACLE_TOL)
        np.testing.assert_allclose(tops.conv3x3_op(xt, torch.from_numpy(w3)).numpy(),
                                   got3.numpy(), **ORACLE_TOL)


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


# (rows of the dense operand, K, C) of the six GEMMs of the 8-384 main path at
# T = 4, slot batch 8: three tokenizer convs (im2col) and the block linears
MAIN_PATH = [(4 * 8 * 112 * 112, 9 * 48, 96), (4 * 8 * 56 * 56, 9 * 96, 192),
             (4 * 8 * 28 * 28, 9 * 192, 384), (4 * 8 * 196, 384, 384),
             (4 * 8 * 196, 384, 1536), (4 * 8 * 196, 1536, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,c", MAIN_PATH)
def test_gemm_kernels_at_main_path_shapes_on_card(card, m, k, c):
    """K2 within rtol 1e-5 / atol 1e-4 of the f32 product; K5 on the words
    of the same spikes equal to K2 bit for bit; K8 equal to K5 with no tile
    dead and with every second (64, 128) tile dead."""
    t = 4
    gen = torch.Generator(card).manual_seed(k + c)
    planes = (torch.rand((t, m // t, k), generator=gen, device=card) > 0.5).float()
    w = (torch.rand((k, c), generator=gen, device=card) * 2 - 1) / k ** 0.5
    x = planes.reshape(m, k)
    got = tops.spike_matmul_fwd(x, w)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-4)
    words = tpk.pack(planes).words[0]
    del planes, x
    packed = tops.packed_spike_matmul_fwd(words, w, t=t)
    assert torch.equal(packed.reshape(m, c), got)
    mt, kt = tops.grid_tiles_shape(m // t, k)
    checker = (torch.arange(mt, device=card)[:, None] + torch.arange(kt, device=card)) % 2 == 1
    dead = checker.repeat_interleave(64, 0)[:m // t].repeat_interleave(128, 1)[:, :k]
    for xw in (words, torch.where(dead, 0, words)):
        tiles = tops._occ_to_grid_tiles(None, xw)
        assert torch.equal(tops.sparse_packed_spike_matmul_fwd(xw, w, tiles, t=t),
                           tops.packed_spike_matmul_fwd(xw, w, t=t))


@pytest.mark.cuda
@pytest.mark.parametrize("k,c", sorted({(k, c) for _, k, c in MAIN_PATH}))
def test_gemm_kernels_on_one_hot_rows_on_card(card, k, c):
    """Rows with one spike select a weight, which three bf16 pieces sum to
    exactly: K2, K5 and K8 give it within one unit in the last place (the
    tensor cores' truncating add), where a GEMM of two pieces misses by up
    to ~64 and passes the rtol 1e-5 / atol 1e-4 check all the same."""
    t = 4
    gen = torch.Generator(card).manual_seed(k + c)
    w = (torch.rand((k, c), generator=gen, device=card) * 2 - 1) / k ** 0.5
    idx = (torch.arange(k, device=card)[None] + 7 * torch.arange(t, device=card)[:, None]) % k
    planes = torch.nn.functional.one_hot(idx, k).float()
    want = w[idx]
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"), device=card)) - want.abs()
    words = tpk.pack(planes).words[0]
    tiles = tops._occ_to_grid_tiles(None, words)
    for got in (tops.spike_matmul_fwd(planes.reshape(t * k, k), w).reshape(t, k, c),
                tops.packed_spike_matmul_fwd(words, w, t=t),
                tops.sparse_packed_spike_matmul_fwd(words, w, tiles, t=t)):
        assert ((got - want).abs() / ulp).max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,c", [(4 * 8 * 196, 384, 384), (4 * 8 * 196, 384, 1536),
                                   (130, 75, 13)])
@pytest.mark.parametrize("top", [9, 17])
def test_spike_matmul_on_counts_on_card(card, m, k, c, top):
    """The residual='add' configs' linears read the residual stream, counts
    up to 2L + 1 = 17 at L = 8, on the dense GEMM: within rtol 1e-5 / atol
    1e-4 of the f32 product."""
    gen = torch.Generator(card).manual_seed(k + c + top)
    x = torch.randint(0, top + 1, (m, k), generator=gen, device=card).float()
    w = (torch.rand((k, c), generator=gen, device=card) * 2 - 1) / k ** 0.5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(tops.spike_matmul_fwd(x, w), x @ w, rtol=1e-5, atol=1e-4)


def test_control_builds_substitute_and_restore(tmp_path, monkeypatch):
    """A control build has its own library file (its defines are part of the
    hash); ``substitute`` points the wrappers of its library at it for the
    block and restores what was loaded before."""
    import shutil

    import _ctypes

    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {("spike_matmul", "f"): "main's f"})
    paths = {n: _build.library_path(n) for n in ("spike_matmul", *_build.CONTROLS)}
    assert len(set(paths.values())) == len(paths)
    shutil.copy(_ctypes.__file__, paths["spike_matmul_hi"])   # any shared object stands in
    with _build.substitute("spike_matmul", "spike_matmul_hi"):
        assert _build._libs["spike_matmul"]._name == str(paths["spike_matmul_hi"])
        assert ("spike_matmul", "f") not in _build._fns
    assert _build._libs == {} and _build._fns == {("spike_matmul", "f"): "main's f"}
    with pytest.raises(ValueError, match="control build of spike_matmul"):
        with _build.substitute("ssa", "spike_matmul_hi"):
            pass
