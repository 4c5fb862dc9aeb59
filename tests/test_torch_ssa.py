"""The port's spiking self-attention held bit-exact against the JAX package's
Pallas kernel (interpret mode) and its einsum oracle: binary q, k, v make
every contraction exact integer arithmetic in f32.  Tests marked ``cuda``
hold the CUDA kernel against its plain version on the card."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import spiking_attention as tsa
from repro_torch.kernels.spiking_attention import ops as tops
from repro_torch.kernels.spiking_attention.ref import ssa_ref

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

SHAPE = (2, 2, 3, 49, 16)   # (T, B, H, N, Dh): N ragged


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    from repro.core.spiking_attention import merge_heads, split_heads, ssa
    from repro.kernels.spiking_attention.ops import ssa_op

    return SimpleNamespace(ssa=ssa, ssa_op=ssa_op, split_heads=split_heads,
                           merge_heads=merge_heads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [(rng.random(shape) > 0.5).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_ssa_op_bit_exact_vs_pallas_kernel(ref, causal):
    q, k, v = _qkv(0)
    want = ref.ssa_op(q, k, v, interpret=True, causal=causal)
    got = tops.ssa_op(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ordering", ["quadratic", "linear"])
def test_ssa_bit_exact_vs_jax(ref, ordering):
    q, k, v = _qkv(1)
    want = ref.ssa(q, k, v, ordering=ordering)
    got = tsa.ssa(*map(torch.from_numpy, (q, k, v)), ordering=ordering)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tops.ssa_op(*map(torch.from_numpy, (q, k, v))).numpy())


def test_split_merge_heads_vs_jax(ref):
    x = np.random.default_rng(2).random((2, 3, 49, 48)).astype(np.float32)
    split = tsa.split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(split.numpy(), np.asarray(ref.split_heads(x, 4)))
    np.testing.assert_array_equal(tsa.merge_heads(split).numpy(),
                                  np.asarray(ref.merge_heads(ref.split_heads(x, 4))))


def test_ssa_op_takes_head_split_views():
    """split_heads returns a transposed view; the wrapper makes it dense."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (2, 2, 49, 48)))
    views = [tsa.split_heads(a, 3) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    want = tsa.ssa(*[a.contiguous() for a in views])
    assert torch.equal(tops.ssa_op(*views), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,m,causal,ones", [
    (SHAPE, None, False, False), (SHAPE, None, True, False),
    ((4, 2, 12, 196, 32), None, False, False), ((4, 2, 12, 196, 32), None, True, False),
    ((2, 1, 3, 33, 8), None, False, False), ((1, 2, 2, 65, 48), None, True, False),
    ((1, 1, 2, 70, 128), None, False, False),   # Dh=128: the widest register tile
    ((2, 1, 3, 33, 13), None, False, False), ((2, 1, 3, 33, 13), None, True, False),
    ((2, 2, 3, 49, 20), None, False, False), ((2, 2, 3, 49, 20), None, True, False),
    ((1, 2, 2, 1, 20), None, False, False), ((1, 2, 2, 1, 20), None, True, False),  # N = M = 1
    ((1, 2, 3, 57, 20), 40, False, False), ((1, 2, 3, 57, 20), 40, True, False),   # N != M
    ((1, 2, 3, 40, 20), 57, False, False), ((1, 2, 3, 40, 20), 57, True, False),
    ((1, 1, 4, 196, 128), None, False, True), ((1, 1, 4, 196, 128), None, True, True),
])
def test_ssa_kernel_bit_exact_vs_plain_on_card(card, shape, m, causal, ones):
    """The tensor-core kernel equals the plain f32 version bit for bit; all
    ones at Dh=128 give the largest scores (128) and sums (128 * 196)."""
    kv_shape = shape[:3] + (m or shape[3], shape[4])
    q = torch.from_numpy(_qkv(4, shape)[0])
    k, v = (torch.from_numpy(a) for a in _qkv(5, kv_shape)[:2])
    if ones:
        q, k, v = torch.ones_like(q), torch.ones_like(k), torch.ones_like(v)
    q, k, v = q.to(card), k.to(card), v.to(card)
    before = tops.ssa_fwd.launches
    got = tops.ssa_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.ssa_fwd.launches == before + 1
    fold = lambda x: x.reshape((-1,) + tuple(x.shape[3:]))
    want = ssa_ref(fold(q), fold(k), fold(v), causal=causal).reshape(shape)
    assert torch.equal(got, want)
    if m is None:
        assert torch.equal(got, tsa.ssa(q, k, v, causal=causal))


@pytest.mark.cuda
def test_ssa_kernel_takes_head_split_views_on_card(card):
    q, k, v = (torch.from_numpy(a).to(card) for a in _qkv(5, (2, 2, 49, 48)))
    views = [tsa.split_heads(a, 3) for a in (q, k, v)]
    assert torch.equal(tops.ssa_op(*views), tsa.ssa(*views))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["ssa_fwd", "packed_ssa_fwd", "sparse_packed_ssa_fwd"])
def test_ssa_kernels_at_the_exactness_bound_on_card(card, fn):
    """All ones at Dh=32 with M = 2^19 - 1 keys: every output is M * Dh =
    2^24 - 32, the largest sum below the bound, and equals the plain
    version; one key more (M * Dh == 2^24) the wrapper raises ValueError and
    the C entry point, called directly, refuses the operands."""
    from repro_torch.core import packing as tpk
    from repro_torch.kernels import _build
    from repro_torch.kernels.spiking_attention.ref import packed_ssa_ref

    d, t = 32, 4
    edge = 2 ** 24 // d
    for m in (edge - 1, edge):
        if fn == "ssa_fwd":
            q, kv = torch.ones((1, 3, d), device=card), torch.ones((1, m, d), device=card)
            call = lambda: tops.ssa_fwd(q, kv, kv, scale=1.0)
            plain = lambda: ssa_ref(q, kv, kv, scale=1.0)
        else:
            q = tpk.pack(torch.ones((t, 1, 1, 3, d), device=card)).words.reshape(1, 1, 3, d)
            kv = torch.full((1, 1, m, d), 2 ** t - 1, dtype=torch.int32, device=card)
            live = torch.ones((1, t), dtype=torch.int32, device=card)
            plain = lambda: packed_ssa_ref(q, kv, kv, t=t, scale=1.0)
            call = ((lambda: tops.packed_ssa_fwd(q, kv, kv, t=t, scale=1.0))
                    if fn == "packed_ssa_fwd"
                    else (lambda: tops.sparse_packed_ssa_fwd(q, kv, kv, live, t=t, scale=1.0)))
        if m < edge:
            got = call()
            torch.cuda.synchronize()
            assert got.max().item() == m * d
            assert torch.equal(got, plain())
            continue
        with pytest.raises(ValueError, match="2\\^24"):
            call()
        out = torch.empty((t, 1, 3, d), device=card)
        stream = _build.stream(card)
        if fn == "ssa_fwd":
            raw = _build.kernel("ssa", fn, tops._ARGTYPES)
            err = raw(q.data_ptr(), kv.data_ptr(), kv.data_ptr(), out.data_ptr(), 1, 3, m, d,
                      1.0, 0, stream)
        elif fn == "packed_ssa_fwd":
            raw = _build.kernel("ssa", fn, tops._PACKED_ARGTYPES)
            err = raw(q.data_ptr(), kv.data_ptr(), kv.data_ptr(), out.data_ptr(), 1, 3, m, d,
                      t, 1.0, 0, stream)
        else:
            raw = _build.kernel("ssa", fn, tops._SPARSE_ARGTYPES)
            err = raw(q.data_ptr(), kv.data_ptr(), kv.data_ptr(), live.data_ptr(),
                      out.data_ptr(), 1, 3, m, d, t, 1.0, 0, stream)
        assert err == 1     # cudaErrorInvalidValue
