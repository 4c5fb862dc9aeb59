"""The exactness argument the SSA tensor-core kernels rest on, checked on the
CPU at the shapes the card tests use.

``ssa_fwd`` and ``sparse_packed_ssa_fwd`` run both products on the f16
tensor cores (``mma.m16n8k16``) with f32 accumulators.  For spikes in {0, 1},
Dh <= 512 and M * Dh < 2^24 that is exact: 0 and 1 are exact in f16, a score
is an integer <= Dh <= 512 (f16 holds integers up to 2048), and every partial
sum of S v is an integer below 2^24, exact in f32 whatever the order.  Past
M * Dh = 2^24 the keys are summed in ranges that keep each range's sums
below 2^24, the range partials added in ascending order (one rounding each),
in the kernels and the plain versions alike; held within 1e-6 of the JAX
oracle there.  These
tests round the operands and scores to f16 as the kernels do, accumulate in
f32 in the kernels' order (16 features, then 16 keys, per step), and hold
the result ``torch.equal`` to the port's plain versions and to the JAX
package's oracle and Pallas kernel (interpret mode); the packed case builds
its f16 operands from the word bits as the kernel does (1.0 is 0x3C00).
Tolerance: none, bit for bit."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import packing as tpk
from repro_torch.kernels.spiking_attention import ops as tops
from repro_torch.kernels.spiking_attention.ref import (
    KEY_TILE, MAX_SUM, key_range, packed_ssa_ref, ssa_ref)

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

K16 = 16                    # the depth of one mma.m16n8k16 step
PLANES = 4                  # planes per block of the gated kernel at Dh <= 32
WIDE_KEYS = 16              # keys per tile of the wide kernel (kWideKeys in ssa.cu)
SSA_CU = (Path(tops.__file__).parent / "csrc" / "ssa.cu")

# (G, N, M, Dh, all ones): the card tests' shapes -- ragged Dh, N = M = 1,
# N != M both ways, and the largest scores (128) and sums (128 * 196) of the
# vision path's token count; past Dh = 128 the wide kernel's (the spiking LM's
# Dh = 512 and a ragged 200, all ones at 512: scores 512, sums 512 * 196)
SHAPES = [(4, 49, 49, 16, False), (3, 33, 33, 8, False), (3, 33, 33, 13, False),
          (4, 49, 49, 20, False), (2, 1, 1, 20, False), (3, 57, 40, 20, False),
          (3, 40, 57, 20, False), (2, 65, 65, 48, False), (2, 70, 70, 128, False),
          (2, 196, 196, 128, True), (2, 57, 40, 200, False), (2, 33, 33, 512, False),
          (1, 196, 196, 512, True)]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    from repro.kernels.spiking_attention import ops as jops
    from repro.kernels.spiking_attention import ref as jref

    return SimpleNamespace(ssa_ref=jref.ssa_ref, ops=jops)


def _operands(seed, g, n, m, d, ones):
    if ones:
        return [np.ones((g, r, d), np.float32) for r in (n, m, m)]
    rng = np.random.default_rng(seed)
    return [(rng.random((g, r, d)) > 0.5).astype(np.float32) for r in (n, m, m)]


def _causal(scores):
    n, m = scores.shape[-2:]
    keep = torch.arange(m)[None, :] <= torch.arange(n)[:, None]
    return torch.where(keep, scores, 0.0)


def _tensor_core_order(q16, k16, v16, *, scale=0.125, causal=False, wide=None, q0=0):
    """f16 q, k, v (G, N, Dp), (G, M, Dp) with Dp a multiple of 16 -> the
    kernels' arithmetic: S accumulated in f32 over 16-feature steps, masked,
    rounded to f16 (asserted lossless), then O accumulated in f32 over
    16-key steps, times scale.  ``wide`` (the head dim D > 128, Dp = 256 or
    512): the wide kernel's order instead (:func:`_wide_order`)."""
    if wide is not None:
        return _wide_order(q16, k16, v16, d=wide, scale=scale, causal=causal, q0=q0)
    g, n, dp = q16.shape
    m = k16.shape[1]
    s = torch.zeros((g, n, m), dtype=torch.float32)
    for f in range(0, dp, K16):
        s += torch.bmm(q16[..., f:f + K16].float(), k16[..., f:f + K16].float().transpose(1, 2))
    if causal:
        s = _causal(s)
    s16 = s.half()
    assert torch.equal(s16.float(), s), "a score is not exact in f16"
    o = torch.zeros((g, n, dp), dtype=torch.float32)
    for j in range(0, m, K16):
        o += torch.bmm(s16[..., j:j + K16].float(), v16[:, j:j + K16].float())
        assert o.abs().max().item() < 2 ** 24
    return o * scale


def _wide_order(q16, k16, v16, *, d, scale=0.125, causal=False, q0=0):
    """The wide kernel's arithmetic (``ssa_wide_tc_kernel``, 128 < D <= 512)
    on f16 q, k, v padded to DQ = 256 or 512 features: each half of the
    features gives partial scores accumulated in f32 over 16-feature steps
    and rounded to f16 (asserted lossless: integers <= DQ / 2); the two
    partials are added in f32, masked on absolute positions (query row i is
    position q0 + i), rounded to f16 (asserted lossless); then per tile of
    WIDE_KEYS keys O += S V in f32, one 16-key step.  The keys are summed in
    ranges of ``key_range(M, D)`` (a multiple of WIDE_KEYS), each range's
    partial from zero (asserted below 2^24) and added into the output in f32,
    ascending; times scale last."""
    g, n, dq = q16.shape
    m, half = k16.shape[1], dq // 2
    parts = []
    for h in range(2):
        p = torch.zeros((g, n, m), dtype=torch.float32)
        for f in range(h * half, (h + 1) * half, K16):
            p += torch.bmm(q16[..., f:f + K16].float(),
                           k16[..., f:f + K16].float().transpose(1, 2))
        assert torch.equal(p.half().float(), p), "a partial score is not exact in f16"
        parts.append(p.half().float())
    s = parts[0] + parts[1]
    if causal:
        keep = torch.arange(m)[None, :] <= torch.arange(q0, q0 + n)[:, None]
        s = torch.where(keep, s, 0.0)
    s16 = s.half()
    assert torch.equal(s16.float(), s), "a score is not exact in f16"
    r = key_range(m, d)
    assert r % WIDE_KEYS == 0 or r == m
    out, o = None, torch.zeros((g, n, dq), dtype=torch.float32)
    for kv0 in range(0, m, WIDE_KEYS):
        o += torch.bmm(s16[..., kv0:kv0 + WIDE_KEYS].float(), v16[:, kv0:kv0 + WIDE_KEYS].float())
        if kv0 + WIDE_KEYS >= m or (kv0 + WIDE_KEYS) % r == 0:   # the end of a key range
            assert o.abs().max().item() < MAX_SUM
            out = o if out is None else out + o
            o = torch.zeros_like(o)
    return out * scale


def _pad16(x):
    d = x.shape[-1]
    return torch.nn.functional.pad(x, (0, -d % K16))


def _pad_wide(x):
    """Features padded to the wide kernel's DQ: 256 up to D = 256, else 512."""
    d = x.shape[-1]
    return torch.nn.functional.pad(x, (0, (256 if d <= 256 else 512) - d))


@pytest.mark.parametrize("g,n,m,d,ones", SHAPES)
def test_f16_holds_binary_operands_and_scores(g, n, m, d, ones):
    q, k, v = (torch.from_numpy(a) for a in _operands(d + n, g, n, m, d, ones))
    for x in (q, k, v):
        assert torch.equal(x.half().float(), x)
    scores = torch.einsum("gnd,gmd->gnm", q, k)
    assert scores.max().item() <= d <= tops.MAX_HEAD_DIM
    assert torch.equal(scores.half().float(), scores)
    out = torch.einsum("gnm,gmd->gnd", scores, v)
    assert out.max().item() <= m * d < 2 ** 24
    if ones:
        assert scores.max().item() == d and out.max().item() == m * d


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("g,n,m,d,ones", [SHAPES[i] for i in (2, 5, 6, 8, 9, 10, 11, 12)])
def test_tensor_core_order_equals_plain_and_jax(ref, g, n, m, d, ones, causal):
    q, k, v = _operands(2 * d + m, g, n, m, d, ones)
    got = _tensor_core_order(*(_pad16(torch.from_numpy(x)).half() for x in (q, k, v)),
                             causal=causal)[..., :d]
    want = ssa_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.ssa_ref(q, k, v, causal=causal)))


# (G, N, M, Dh, all ones): the wide kernel's ragged edges (Dh 200 in the
# 256-feature form, 257 in the 512 one, N != M both ways, N < 64) and the
# spiking LM's Dh 512, all ones there (scores 512: partials 256 each)
WIDE_SHAPES = [(2, 57, 40, 200, False), (2, 40, 57, 200, False), (2, 57, 40, 257, False),
               (2, 40, 57, 257, False), (2, 33, 33, 512, False), (1, 70, 45, 512, False),
               (1, 40, 40, 512, True)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("g,n,m,d,ones", WIDE_SHAPES)
def test_wide_order_equals_plain_and_jax(ref, g, n, m, d, ones, causal):
    """The wide kernel's order (scores once per 16-key tile: two f16 partial
    halves added in f32, then S V per tile) ``torch.equal`` the plain
    version and the JAX oracle."""
    q, k, v = _operands(3 * d + n, g, n, m, d, ones)
    got = _tensor_core_order(*(_pad_wide(torch.from_numpy(x)).half() for x in (q, k, v)),
                             causal=causal, wide=d)[..., :d]
    want = ssa_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.ssa_ref(q, k, v, causal=causal)))


def test_wide_order_past_the_edge_range_by_range():
    """Past M * Dh = 2^24 at Dh 512 (M = 32,832: ranges of 32,704 and 128
    keys), causal, on query rows at positions 32,810.. of the sequence, whose
    keys straddle the two ranges: the wide order, each range's partial from
    zero added into the output in f32, ``torch.equal`` the plain version.
    The operands are near all ones (a row of q misses at most one feature, a
    key's v a block of 128), so the outputs pass 2^24 with odd sums and the
    addition of the two ranges rounds."""
    d, m, q0, n = 512, 32832, 32810, 8
    rng = np.random.default_rng(11)
    q = np.ones((1, n, d), np.float32)
    q[0, np.arange(n), rng.integers(0, d, n)] = rng.random(n) > 0.5
    k = np.ones((1, m, d), np.float32)
    v = (rng.random((1, m, 4)) > 1 / 1024).astype(np.float32).repeat(d // 4, axis=2)
    assert key_range(m, d) == 32704
    got = _tensor_core_order(*(torch.from_numpy(x).half() for x in (q, k, v)), causal=True,
                             wide=d, q0=q0)
    want = ssa_ref(*map(torch.from_numpy, (q, k, v)), causal=True, q0=q0)
    assert torch.equal(got, want)
    assert want.max().item() / 0.125 > MAX_SUM


def test_wide_key_tile_divides_the_range_tile():
    """The wide kernel's key tile (kWideKeys, read from ssa.cu's source) divides
    the key ranges' unit ``ref.KEY_TILE`` (kKeys in ssa.cu), so that every
    range ends on a tile boundary; the emulation above uses the same tile."""
    src = SSA_CU.read_text()
    consts = dict(re.findall(r"constexpr int (kKeys|kWideKeys) = (\d+);", src))
    assert int(consts["kKeys"]) == KEY_TILE
    assert int(consts["kWideKeys"]) == WIDE_KEYS and KEY_TILE % WIDE_KEYS == 0


def _plane_f16(words, t, planes=PLANES):
    """Bit plane t of int32 words (..., Dh), Dh even, as f16 built the way the
    packed kernel builds a fragment register: the two features of a register
    merged as (w0 >> bit0) & 0xFFFF | (w1 >> bit0) << 16, bit0 the first plane
    of the block's group of ``planes``, then ((merged >> p) & 0x00010001) *
    0x3C00 read as two f16 lanes (low lane the even feature)."""
    w = words[t // 32].to(torch.int64) & 0xFFFFFFFF
    bit0, p = (t % 32) // planes * planes, t % planes
    merged = ((w[..., 0::2] >> bit0) & 0xFFFF) | (((w[..., 1::2] >> bit0) << 16) & 0xFFFF0000)
    reg = ((merged >> p) & 0x00010001) * 0x3C00
    lanes = torch.stack([reg & 0xFFFF, reg >> 16], dim=-1).reshape(words.shape[1:])
    return lanes.to(torch.int16).view(torch.float16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,shape", [(1, (1, 3, 33, 8)), (4, (2, 2, 13, 16)),
                                     (4, (2, 12, 196, 32)), (33, (1, 1, 40, 64)),
                                     (40, (1, 2, 20, 20)), (2, (1, 2, 65, 48))])
def test_packed_tensor_core_order_equals_plain_and_jax(ref, t, shape, causal):
    """Words (W, B, H, N, Dh) from random trains; every plane's f16 operands
    built from the bits, the kernels' arithmetic, against ``packed_ssa_ref``
    and the JAX package's packed Pallas kernel in interpret mode."""
    rng = np.random.default_rng(t)
    qw, kw, vw = (tpk.pack(torch.from_numpy((rng.random((t,) + shape) > 0.5)
                                            .astype(np.float32))).words for _ in range(3))
    w, b, h, n, d = qw.shape
    fold = lambda x: x.reshape(w, b * h, n, d)
    planes = []
    for ti in range(t):
        q16, k16, v16 = (_pad16(_plane_f16(fold(x), ti)) for x in (qw, kw, vw))
        planes.append(_tensor_core_order(q16, k16, v16, causal=causal)[..., :d])
    got = torch.stack(planes).reshape((t,) + shape)
    want = packed_ssa_ref(*map(fold, (qw, kw, vw)), t=t, scale=0.125, causal=causal)
    assert torch.equal(got, want.reshape(got.shape))
    jax_out = ref.ops.packed_ssa_op(*map(bridge.words_to_numpy, (qw, kw, vw)), t=t,
                                    interpret=True, causal=causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))


def _planes_per_block(d):
    """The packed kernel's planes per block (planes_per_block in ssa.cu):
    4, 4, 2, 1 for Dh rounded up to 16, 32, 64, 128."""
    return 4 if d <= 32 else 2 if d <= 64 else 1


@pytest.mark.parametrize("t,shape,causal", [(33, (1, 2, 20, 20), False),
                                            (40, (1, 2, 20, 20), True),
                                            (33, (1, 1, 24, 64), True),
                                            (40, (1, 1, 9, 128), False)])
def test_ungated_packed_order_every_plane(ref, t, shape, causal):
    """The ungated kernel (``packed_ssa_fwd``) computes every plane below T:
    the blocks' groups of the kernel's P planes walk both words of a 33- or
    40-step train (P divides 32, so no group straddles two words), each
    plane built from the bits, against ``packed_ssa_ref`` and the JAX
    package's oracle on the unpacked trains."""
    rng = np.random.default_rng(t + shape[-1])
    trains = [(rng.random((t,) + shape) > 0.5).astype(np.float32) for _ in range(3)]
    qw, kw, vw = (tpk.pack(torch.from_numpy(a)).words for a in trains)
    w, b, h, n, d = qw.shape
    fold = lambda x: x.reshape(w, b * h, n, d)
    p = _planes_per_block(d)
    assert 32 % p == 0
    out = []
    for p0 in range(0, t, p):                      # blockIdx.z walks the groups
        for ti in range(p0, min(p0 + p, t)):       # planes at or past T are not computed
            q16, k16, v16 = (_pad16(_plane_f16(fold(x), ti, p)) for x in (qw, kw, vw))
            out.append(_tensor_core_order(q16, k16, v16, causal=causal)[..., :d])
    got = torch.stack(out).reshape((t,) + shape)
    want = packed_ssa_ref(*map(fold, (qw, kw, vw)), t=t, scale=0.125, causal=causal)
    assert torch.equal(got, want.reshape(got.shape))
    fold_t = lambda a: a.reshape(t * b * h, n, d)
    jax_out = ref.ssa_ref(*map(fold_t, trains), causal=causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out).reshape(got.shape))


def test_plane_f16_is_the_unpacked_plane():
    words = tpk.pack(torch.from_numpy((np.random.default_rng(0).random((40, 3, 6)) > 0.5)
                                      .astype(np.float32))).words
    dense = tpk.unpack(tpk.PackedSpikes(words, 40))
    for ti in range(40):
        assert torch.equal(_plane_f16(words, ti).float(), dense[ti])


@pytest.mark.parametrize("fn", ["ssa_fwd", "packed_ssa_fwd", "sparse_packed_ssa_fwd"])
def test_kernel_wrappers_raise_above_max_head_dim(fn):
    """Dh = 513 exceeds the kernels' widest head (a score could pass 512, and
    the wide kernel's shared memory is sized for 512): the wrapper refuses it
    for any tensor off the CPU, before the kernel is looked up."""
    d = tops.MAX_HEAD_DIM + 1
    if fn == "ssa_fwd":
        x = torch.empty((2, 5, d), device="meta")
        call = lambda: tops.ssa_fwd(x, x, x, scale=0.125)
    else:
        x = torch.empty((1, 2, 5, d), dtype=torch.int32, device="meta")
        live = torch.empty((2, 4), dtype=torch.int32, device="meta")
        call = ((lambda: tops.packed_ssa_fwd(x, x, x, t=4, scale=0.125))
                if fn == "packed_ssa_fwd"
                else (lambda: tops.sparse_packed_ssa_fwd(x, x, x, live, t=4, scale=0.125)))
    with pytest.raises(ValueError, match="head dim"):
        call()


@pytest.mark.parametrize("d", [8, 20, 32, 128, 200, 512])
def test_exact_shape_bound(d):
    """M * Dh < 2^24 keeps every partial sum of S v exact in f32: below the
    edge the keys form one range; from M * Dh = 2^24 on they are summed in
    ranges of R keys, R the largest multiple of the kernels' 64-key tile
    with R * Dh < 2^24, and the shape check takes any M."""
    edge = -(-MAX_SUM // d)            # the first M with M * Dh >= 2^24
    assert key_range(edge - 1, d) == edge - 1
    r = key_range(edge, d)
    assert r % KEY_TILE == 0 and r * d < MAX_SUM <= (r + KEY_TILE) * d
    assert key_range(10 * edge, d) == r
    tops.check_exact_shape("ssa", d)


@pytest.mark.parametrize("fn", ["ssa_fwd", "packed_ssa_fwd", "sparse_packed_ssa_fwd"])
def test_kernel_wrappers_raise_at_the_exactness_bound(fn):
    """Dh = 32 with M = 2^19 keys: M * Dh == 2^24, no longer refused for its
    shape (the key ranges keep the sums exact); a tensor off the CPU that is
    not on the card is still refused before the kernel is looked up."""
    d, m = 32, 2 ** 24 // 32
    if fn == "ssa_fwd":
        q, kv = torch.empty((2, 5, d), device="meta"), torch.empty((2, m, d), device="meta")
        call = lambda: tops.ssa_fwd(q, kv, kv, scale=0.125)
    else:
        q = torch.empty((1, 2, 5, d), dtype=torch.int32, device="meta")
        kv = torch.empty((1, 2, m, d), dtype=torch.int32, device="meta")
        live = torch.empty((2, 4), dtype=torch.int32, device="meta")
        call = ((lambda: tops.packed_ssa_fwd(q, kv, kv, t=4, scale=0.125))
                if fn == "packed_ssa_fwd"
                else (lambda: tops.sparse_packed_ssa_fwd(q, kv, kv, live, t=4, scale=0.125)))
    with pytest.raises(ValueError, match="CUDA device"):
        call()


@pytest.mark.parametrize("d", [tops.MAX_HEAD_DIM, tops.MAX_HEAD_DIM + 1])
def test_max_head_dim_edge(d):
    """Dh = 512 is the widest head the kernels take (its scores, <= 512, are
    exact in f16); Dh = 513 is refused."""
    assert tops.MAX_HEAD_DIM == 512
    if d <= tops.MAX_HEAD_DIM:
        tops.check_exact_shape("ssa", d)
    else:
        with pytest.raises(ValueError, match="head dim"):
            tops.check_exact_shape("ssa", d)


# Past the 2^24 edge (G = 1, N = 8, Dh = 32, M = 2^19 + 4096: two key ranges,
# 524,224 and 4,160 keys): "near-ones" leaves one q feature in 64 and one k
# or v entry in 512 at zero, so the totals pass 2^24 with odd values, which
# f32 rounds; the range partials stay exact.  Against the JAX oracle (one
# f32 einsum over all keys, XLA's own order) within RTOL_PAST_EDGE: each of
# the two sums rounds at most once more than the exact value (2^-24 each).
PAST_EDGE = dict(g=1, n=8, d=32, m=2 ** 19 + 4096)
RTOL_PAST_EDGE = 1e-6


def _past_edge_operands(kind):
    g, n, d, m = (PAST_EDGE[x] for x in "gndm")
    rng = np.random.default_rng(7)
    if kind == "random":
        return [(rng.random((g, r, d)) > 0.5).astype(np.float32) for r in (n, m, m)]
    q, k, v = (np.ones((g, r, d), np.float32) for r in (n, m, m))
    if kind == "near-ones":
        q[..., 0::64] = rng.random(q[..., 0::64].shape) > 0.5
        k[rng.random(k.shape) < 1 / 512] = 0.0
        v[rng.random(v.shape) < 1 / 512] = 0.0
    return [q, k, v]


def _range_order(q, k, v, r, scale=0.125):
    """The kernels' order from exact pieces: each range's S v in float64
    (integers below 2^24, so exact in f32 too), the partials added in f32
    in ascending key order, the scale last."""
    out = None
    for k0 in range(0, k.shape[1], r):
        s = np.einsum("gnd,gmd->gnm", q.astype(np.float64), k[:, k0:k0 + r].astype(np.float64))
        part = np.einsum("gnm,gmd->gnd", s, v[:, k0:k0 + r].astype(np.float64))
        assert part.max() < MAX_SUM
        part = part.astype(np.float32)
        out = part if out is None else out + part
    return out * np.float32(scale)


@pytest.mark.parametrize("kind", ["ones", "near-ones", "random"])
def test_range_split_past_the_edge_vs_jax(ref, kind):
    """M * Dh past 2^24, not causal: the plain version sums two key ranges
    exactly and adds them in order (``torch.equal`` to that order built from
    float64 pieces), and is within RTOL_PAST_EDGE of the JAX oracle."""
    q, k, v = _past_edge_operands(kind)
    d, m = PAST_EDGE["d"], PAST_EDGE["m"]
    r = key_range(m, d)
    assert (r, m - r) == (524224, 4160)
    got = ssa_ref(*map(torch.from_numpy, (q, k, v)))
    assert torch.equal(got, torch.from_numpy(_range_order(q, k, v, r)))
    if kind != "random":
        assert got.max().item() / 0.125 > MAX_SUM       # the sums pass 2^24
    if kind == "ones":
        assert got.max().item() == m * d * 0.125
    want = np.asarray(ref.ssa_ref(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_PAST_EDGE, atol=0)


def test_range_split_causal_slice_uses_absolute_positions():
    """Causal past the edge on a slice of the queries (``q0``): query rows
    at positions 32,700..32,830 of a 32,832-key sequence at Dh = 512 (two
    ranges of 32,704 and 128 keys) see key j iff j <= their position, and
    equal the kernels' order built from float64 pieces per row; the first
    rows past 32,704 keys straddle the two ranges."""
    d, m, q0, n = 512, 32832, 32700, 131
    rng = np.random.default_rng(3)
    q = np.ones((1, n, d), np.float32)
    q[..., 0::64] = rng.random(q[..., 0::64].shape) > 0.5
    k = np.ones((1, m, d), np.float32)
    v = (rng.random((1, m, 4)) > 0.2).astype(np.float32).repeat(d // 4, axis=2)
    r = key_range(m, d)
    assert r == 32704
    got = ssa_ref(*map(torch.from_numpy, (q, k, v)), causal=True, q0=q0).numpy()
    for i in (0, 3, 4, 5, 60, n - 1):
        p = q0 + i
        want = _range_order(q[:, i:i + 1], k[:, :p + 1], v[:, :p + 1], r)
        np.testing.assert_array_equal(got[:, i:i + 1], want)
    # one range's all-ones partial is below 2^24 (r * d), the total past it
    assert r * d < MAX_SUM < m * d


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_wrappers_at_max_head_dim_equal_plain_and_jax(ref, causal):
    """Dh = 512 on the CPU: the three wrappers take it and return the plain
    versions' result, which equals the kernels' order and the JAX oracle."""
    t, g, n, d = 4, 2, 33, tops.MAX_HEAD_DIM
    rng = np.random.default_rng(d)
    trains = [(rng.random((t, g, n, d)) > 0.5).astype(np.float32) for _ in range(3)]
    dense = [torch.from_numpy(a).reshape(t * g, n, d) for a in trains]
    got = tops.ssa_fwd(*dense, scale=0.125, causal=causal)
    assert torch.equal(got, ssa_ref(*dense, causal=causal))
    assert torch.equal(got, _tensor_core_order(*(x.half() for x in dense), causal=causal))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.ssa_ref(*(x.numpy() for x in dense), causal=causal)))
    words = [tpk.pack(torch.from_numpy(a)).words for a in trains]
    live = tops._plane_liveness(*words, t)
    packed = tops.packed_ssa_fwd(*words, t=t, scale=0.125, causal=causal)
    sparse = tops.sparse_packed_ssa_fwd(*words, live, t=t, scale=0.125, causal=causal)
    assert torch.equal(packed.reshape(got.shape), got)
    assert torch.equal(sparse, packed)
