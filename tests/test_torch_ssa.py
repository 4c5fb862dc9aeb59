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
    from repro.kernels.spiking_attention.ref import ssa_linear_ref

    return SimpleNamespace(ssa=ssa, ssa_op=ssa_op, split_heads=split_heads,
                           merge_heads=merge_heads, ssa_linear_ref=ssa_linear_ref)


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


def test_ssa_linear_ref_vs_jax_and_quadratic(ref):
    """The linear-ordering oracle Q (K^T V): within rtol 1e-5 of the JAX
    oracle and of the quadratic plain version (no softmax, so the two
    orderings agree; f32 sums in another order)."""
    from repro_torch.kernels.spiking_attention.ref import ssa_linear_ref

    q, k, v = (a.reshape(-1, 49, 16) for a in _qkv(9))
    got = ssa_linear_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.ssa_linear_ref(q, k, v)),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.numpy(), ssa_ref(*map(torch.from_numpy, (q, k, v))).numpy(),
                               rtol=1e-5, atol=0)


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
    # past Dh = 128: the wide kernel (128-feature output slabs), up to Dh = 512
    ((1, 1, 2, 70, 129), None, True, False), ((1, 2, 2, 33, 256), None, False, False),
    ((1, 1, 2, 70, 257), None, True, False), ((1, 1, 2, 70, 512), None, False, False),
    ((4, 4, 4, 32, 512), None, True, False),    # the spiking LM's prefill: G = 64, N = 32
    ((1, 2, 3, 57, 200), 40, False, False), ((1, 2, 3, 40, 200), 57, True, False),
    ((1, 2, 2, 1, 200), None, True, False),
    ((1, 1, 2, 196, 512), None, False, True), ((1, 1, 2, 196, 512), None, True, True),
])
def test_ssa_kernel_bit_exact_vs_plain_on_card(card, shape, m, causal, ones):
    """The tensor-core kernels equal the plain f32 version bit for bit; all
    ones at Dh=128 and 512 give the largest scores (the head dim) and sums
    (Dh * 196)."""
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
@pytest.mark.parametrize("d", [32, 512])
@pytest.mark.parametrize("fn", ["ssa_fwd", "packed_ssa_fwd", "sparse_packed_ssa_fwd"])
def test_ssa_kernels_at_the_exactness_bound_on_card(card, fn, d):
    """Around the 2^24 edge (Dh = 32: the narrow kernels, Dh = 512: the wide
    one), M = 2^24 / Dh - 1, 2^24 / Dh and 2^24 / Dh + 4096 keys: all ones
    (every output M * Dh, the largest sums, exact in f32 at these M) and
    near-ones (one q feature in 64 and one v entry in 512 at zero, so the
    totals past 2^24 are odd and round), each ``torch.equal`` its plain
    version, which sums the same key ranges in the same order."""
    from repro_torch.core import packing as tpk
    from repro_torch.kernels.spiking_attention.ref import packed_ssa_ref, sparse_packed_ssa_ref

    t, n = 4, 5
    edge = 2 ** 24 // d
    for m in (edge - 1, edge, edge + 4096):
        for ones in (True, False):
            q, v = torch.ones((t, n, d), device=card), torch.ones((t, m, d), device=card)
            if not ones:
                q[..., ::64] = (torch.rand(q[..., ::64].shape, device=card) > 0.5).float()
                v[torch.rand(v.shape, device=card) < 1 / 512] = 0.0
            k = torch.ones((t, m, d), device=card)
            if fn == "ssa_fwd":
                got = tops.ssa_fwd(q, k, v, scale=1.0)
                want = ssa_ref(q, k, v, scale=1.0)
            else:
                qw, kw, vw = (tpk.pack(x[:, None]).words for x in (q, k, v))
                if fn == "packed_ssa_fwd":
                    got = tops.packed_ssa_fwd(qw, kw, vw, t=t, scale=1.0)
                    want = packed_ssa_ref(qw, kw, vw, t=t, scale=1.0)
                else:
                    live = tops._plane_liveness(qw, kw, vw, t)
                    got = tops.sparse_packed_ssa_fwd(qw, kw, vw, live, t=t, scale=1.0)
                    want = sparse_packed_ssa_ref(qw, kw, vw, live, t=t, scale=1.0)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, ones)
            if ones:
                assert got.max().item() == m * d


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["ssa_fwd", "packed_ssa_fwd", "sparse_packed_ssa_fwd"])
def test_ssa_kernels_at_max_head_dim_on_card(card, fn):
    """Dh = 512 (the widest head) runs and equals the plain version; Dh = 513
    is refused by the wrapper (ValueError) and by the C entry point, called
    directly (cudaErrorInvalidValue)."""
    from repro_torch.core import packing as tpk
    from repro_torch.kernels import _build
    from repro_torch.kernels.spiking_attention.ref import packed_ssa_ref, sparse_packed_ssa_ref

    t, g, n = 4, 3, 21
    for d in (tops.MAX_HEAD_DIM, tops.MAX_HEAD_DIM + 1):
        trains = [torch.from_numpy(a).to(card) for a in _qkv(d, (t, g, n, d))]
        if fn == "ssa_fwd":
            q, k, v = (x.reshape(t * g, n, d) for x in trains)
            call = lambda: tops.ssa_fwd(q, k, v, scale=0.125, causal=True)
            plain = lambda: ssa_ref(q, k, v, causal=True)
        else:
            q, k, v = (tpk.pack(x).words for x in trains)
            live = tops._plane_liveness(q, k, v, t)
            call = ((lambda: tops.packed_ssa_fwd(q, k, v, t=t, scale=0.125, causal=True))
                    if fn == "packed_ssa_fwd"
                    else (lambda: tops.sparse_packed_ssa_fwd(q, k, v, live, t=t, scale=0.125,
                                                             causal=True)))
            plain = ((lambda: packed_ssa_ref(q, k, v, t=t, scale=0.125, causal=True))
                     if fn == "packed_ssa_fwd"
                     else (lambda: sparse_packed_ssa_ref(q, k, v, live, t=t, scale=0.125,
                                                         causal=True)))
        if d <= tops.MAX_HEAD_DIM:
            got = call()
            torch.cuda.synchronize()
            assert torch.equal(got, plain())
            continue
        with pytest.raises(ValueError, match="head dim"):
            call()
        out = torch.empty((t * g, n, d), device=card)
        stream = _build.stream(card)
        if fn == "ssa_fwd":
            raw = _build.kernel("ssa", fn, tops._ARGTYPES)
            err = raw(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), t * g, n, n, d,
                      0.125, 1, stream)
        elif fn == "packed_ssa_fwd":
            raw = _build.kernel("ssa", fn, tops._PACKED_ARGTYPES)
            err = raw(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g, n, n, d, t,
                      0.125, 1, stream)
        else:
            raw = _build.kernel("ssa", fn, tops._SPARSE_ARGTYPES)
            err = raw(q.data_ptr(), k.data_ptr(), v.data_ptr(), live.data_ptr(),
                      out.data_ptr(), g, n, n, d, t, 0.125, 1, stream)
        assert err == 1     # cudaErrorInvalidValue
