"""The LIF kernels' bf16 form (K1, K4, K7 on a bf16 drive) held against the
JAX package.  The reference's kernels take a bf16 drive and run the chain in
it (``_chain``: every product and sum a bf16 value), K1 emits bf16 spikes
and K7 its gradient in the drive's dtype; its own tests run K1 in bf16
(``tests/test_kernels.py``).  On the CPU the port's wrappers run the plain
versions, eager PyTorch in bf16 (one rounding per operation); they are held
``torch.equal`` to the JAX kernels in interpret mode at the reference's
shapes, chain_len 1/2/4 and both resets.  Tests marked ``cuda`` hold the
CUDA kernels' bf16 instantiation ``torch.equal`` to the plain versions on
the card.  Tolerance: none, bit for bit."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.kernels.lif_parallel import ops as tops

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

# tests/test_kernels.py::test_lif_kernel_shapes_dtypes
SHAPES = [(4, 128), (4, 8, 300), (2, 1024), (1, 130), (4, 3, 5, 7), (8, 256)]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.lif_parallel import ops as jops

    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bf16(seed, shape, scale=1.0):
    """A normal array already rounded to bf16 (so both packages read the
    same values), a third of it on a 1/8 grid: membranes on theta too."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, scale, shape).astype(np.float32)
    grid = rng.random(shape) < 1 / 3
    d[grid] = np.round(d[grid] * 8) / 8
    return torch.from_numpy(d).bfloat16()


def _jax(ref, x: torch.Tensor):
    return ref.jnp.asarray(x.float().numpy()).astype(ref.jnp.bfloat16)


def _np(a):
    return np.array(a.astype("float32"))


# The CUDA forward kernels' edges in bf16 (8 columns a thread, chunked loads
# where T != 4): (shape, chain_len), N of several residues mod 8.
EDGES = [((33, 205), 3), ((40, 207), 8), ((1, 204), 1)]


@pytest.mark.parametrize("shape,chain_len", [pytest.param(s, None, id=f"shape{i}")
                                             for i, s in enumerate(SHAPES)]
                         + [pytest.param(s, c, id=f"T{s[0]}-N{s[1]}-chain{c}")
                            for s, c in EDGES])
def test_bf16_forward_vs_pallas_kernel(ref, shape, chain_len):
    drive = _bf16(sum(shape), shape)
    got = tops.lif_parallel_op(drive, chain_len=chain_len)
    assert got.dtype == torch.bfloat16
    want = ref.ops.lif_parallel_op(_jax(ref, drive), chain_len=chain_len, interpret=True)
    assert want.dtype == ref.jnp.bfloat16
    assert torch.equal(got, torch.from_numpy(_np(want)).bfloat16())


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4])
def test_bf16_forms_vs_pallas_kernels(ref, chain_len, reset):
    """K1 (and its fused IAND), K4 (and its packed IAND) and K7 in bf16 on
    the plain route against the Pallas kernels in interpret mode."""
    shape = (4, 3, 100)
    drive, g = _bf16(chain_len, shape), _bf16(10 + chain_len, shape, 0.5)
    skip = (torch.from_numpy(np.random.default_rng(20).random(shape)) > 0.5).bfloat16()
    kw = dict(chain_len=chain_len, reset=reset)
    jd = _jax(ref, drive)
    spikes = tops.lif_parallel_op(drive, **kw)
    assert torch.equal(spikes.float(), torch.from_numpy(
        _np(ref.ops.lif_parallel_op(jd, interpret=True, **kw))))
    iand = tops.lif_iand_op(drive, skip, **kw)
    assert iand.dtype == torch.bfloat16
    assert torch.equal(iand.float(), torch.from_numpy(
        _np(ref.ops.lif_iand_op(jd, _jax(ref, skip), interpret=True, **kw))))
    words = tops.lif_pack_op(drive, **kw)
    assert np.array_equal(bridge.words_to_numpy(words),
                          np.asarray(ref.ops.lif_pack_op(jd, interpret=True, **kw)))
    x = drive.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(tops.lif_parallel_op(x, **kw), x, g)
    assert dx.dtype == torch.bfloat16
    _, vjp = ref.jax.vjp(lambda d: ref.ops.lif_parallel_op(d, interpret=True, **kw), jd)
    assert torch.equal(dx.float(), torch.from_numpy(_np(vjp(_jax(ref, g))[0])))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrappers_refuse_other_dtypes(dtype):
    drive = torch.zeros((4, 8), dtype=dtype)
    for call in (lambda: tops.lif_parallel_fwd(drive, chain_len=4, lam=0.25, theta=0.5,
                                               reset="hard"),
                 lambda: tops.lif_parallel_pack_fwd(drive, chain_len=4, lam=0.25,
                                                    theta=0.5, reset="hard"),
                 lambda: tops.lif_parallel_bwd(drive, drive, chain_len=4, lam=0.25,
                                               theta=0.5, reset="hard")):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4, 8])
def test_bf16_kernels_equal_plain_on_card(card, chain_len, reset):
    """K1 (+IAND), K4 (+IAND, + occupancy map) and K7 on bf16 operands at a
    ragged width, each ``torch.equal`` its plain version on the card, one
    launch each."""
    from repro_torch.core import packing as tpk
    from repro_torch.kernels.lif_parallel.ref import (
        lif_pack_ref, lif_parallel_ref, lif_parallel_ref_grad)

    t, n = 8, 3 * 517
    drive, g = _bf16(chain_len, (t, n)).to(card), _bf16(5, (t, n), 0.5).to(card)
    skip = (torch.rand((t, n), device=card) > 0.5).bfloat16()
    skip_words = tpk.pack(skip.float()).words
    kw = dict(chain_len=chain_len, lam=0.25, theta=0.5, reset=reset)
    counts = (tops.lif_parallel_fwd.launches, tops.lif_parallel_pack_fwd.launches,
              tops.lif_parallel_bwd.launches)
    for sk in (None, skip):
        got = tops.lif_parallel_fwd(drive, skip=sk, **kw)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, lif_parallel_ref(drive, skip=sk, **kw))
    for sk in (None, skip_words):
        words, occ = tops.lif_parallel_pack_fwd(drive, skip_words=sk, occ_cols=517, **kw)
        want = lif_pack_ref(drive, skip_words=sk, **kw)
        assert torch.equal(words, want)
        assert torch.equal(occ, tpk.occupancy_map(want.reshape(1, 3, 517)))
    dx = tops.lif_parallel_bwd(drive, g, **kw)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, lif_parallel_ref_grad(drive, g, chain_len=chain_len, reset=reset))
    assert (tops.lif_parallel_fwd.launches, tops.lif_parallel_pack_fwd.launches,
            tops.lif_parallel_bwd.launches) == (counts[0] + 2, counts[1] + 2, counts[2] + 1)
