"""The input encoding (``core/encoding.py``, the paper's Sec. III-A) held
against the JAX package: direct encoding, the 8-bit bitplane split and its
inverse (``torch.equal``: integers and powers of two, exact in f32), and
``bitplane_conv`` -- a conv of an 8-bit image as 8 binary-plane passes --
against the JAX package's on the same weights and image, with the
reference's own tolerance (rtol 1e-4, atol 1e-3,
``tests/test_iand_spikformer.py``: eight f32 convs recombined by 2^k sum in
another order than one conv of the image).  The kernel route's conv
(``conv3x3_op``, the spike GEMM on im2col patches) as ``conv_apply_fn`` runs
its plain version here; the test marked ``cuda`` runs it on K2."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import encoding as tenc
from repro_torch.core import nn as tnn
from repro_torch.kernels.spike_matmul import ops as mm_ops

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    from repro.core import encoding as jenc
    from repro.core import nn as jnn

    return SimpleNamespace(enc=jenc, nn=jnn)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _image(seed, shape=(2, 8, 8, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _conv_w(seed, cin=3, cout=4):
    scale = 1.0 / np.sqrt(9 * cin)
    return np.random.default_rng(seed).uniform(-scale, scale, (3, 3, cin, cout)).astype(
        np.float32)


def _spike_conv(p, x):
    """The kernel route's 3x3 conv: im2col patches through the spike GEMM."""
    return mm_ops.conv3x3_op(x, p["w"])


def test_bitplane_roundtrip_vs_jax(ref):
    img = _image(0)
    planes = tenc.to_bitplanes(torch.from_numpy(img))
    assert planes.shape == (8,) + img.shape and planes.dtype == torch.float32
    assert torch.equal(planes, torch.from_numpy(np.array(ref.enc.to_bitplanes(img))))
    back = tenc.from_bitplanes(planes)
    assert torch.equal(back, torch.from_numpy(img.astype(np.float32)))
    assert torch.equal(back, torch.from_numpy(np.array(ref.enc.from_bitplanes(
        np.asarray(ref.enc.to_bitplanes(img))))))


def test_direct_encode_vs_jax(ref):
    img = np.random.default_rng(1).random((2, 5, 5, 3)).astype(np.float32)
    got = tenc.direct_encode(torch.from_numpy(img), 4)
    assert torch.equal(got, torch.from_numpy(np.array(ref.enc.direct_encode(img, 4))))


@pytest.mark.parametrize("route", ["conv_apply", "spike_conv"])
def test_bitplane_conv_vs_jax(ref, route):
    """``bitplane_conv`` on the direct conv and on the kernel route's spike
    conv, against the JAX package's ``bitplane_conv`` and its direct conv of
    the image (linearity), on the same weights."""
    img, w = _image(2, (2, 9, 7, 3)), _conv_w(3)
    fn = tnn.conv_apply if route == "conv_apply" else _spike_conv
    got = tenc.bitplane_conv(fn, {"w": torch.from_numpy(w)}, torch.from_numpy(img))
    want = ref.enc.bitplane_conv(lambda p, x: ref.nn.conv_apply(p, x), {"w": w}, img)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    direct = ref.nn.conv_apply({"w": w}, img.astype(np.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(direct), **TOL)


def test_to_bitplanes_takes_uint8_only():
    with pytest.raises(TypeError, match="uint8"):
        tenc.to_bitplanes(torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.cuda
def test_bitplane_conv_on_the_spike_gemm_on_card(card):
    """On the card the eight planes ride one K2 launch (8 B images of
    im2col patches); the result is within the reference's tolerance of the
    same function over the plain GEMM and of a direct f32 conv."""
    img = torch.from_numpy(_image(4, (2, 33, 31, 3))).to(card)
    p = {"w": torch.from_numpy(_conv_w(5, 3, 48)).to(card)}
    before = mm_ops.spike_matmul_fwd.launches
    got = tenc.bitplane_conv(_spike_conv, p, img)
    torch.cuda.synchronize()
    assert mm_ops.spike_matmul_fwd.launches == before + 1
    plain = tenc.bitplane_conv(
        lambda q, x: (mm_ops._im2col(x, 3) @ q["w"].reshape(-1, 48)).reshape(
            x.shape[:3] + (48,)), p, img)
    torch.testing.assert_close(got, plain, **TOL)
    torch.testing.assert_close(got, tnn.conv_apply(p, img.float()), **TOL)
