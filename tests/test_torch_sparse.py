"""The port's sparse spike datapath held against the JAX package's: the
occupancy maps of ``core/packing`` (pack, iand, reshape_elems, the LIF pack
epilogue), and the plain versions of the two gated kernels -- the
occupancy-gated packed GEMM and the plane-gated packed SSA -- against the
Pallas kernels in interpret mode, on operands with a stated share of dead
tiles or planes.  Tolerances: maps, words and SSA exact (integer arithmetic);
the GEMM atol 1e-5 against JAX (f32 sums in another order than XLA's) and
``torch.equal`` to the port's own packed GEMM (a skipped tile adds exactly
0).  Tests marked ``cuda`` hold the CUDA kernels against the packed kernels
and the plain versions on the card."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import lif as tlif
from repro_torch.core import packing as tpk
from repro_torch.core import spiking_attention as tsa
from repro_torch.kernels.lif_parallel import ops as tlops
from repro_torch.kernels.spike_matmul import ops as tmops
from repro_torch.kernels.spiking_attention import ops as tsops
from repro_torch.kernels.spiking_attention.ref import sparse_packed_ssa_ref

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ATOL = 1e-5
STEPS = [1, 4, 8, 32, 33, 40]
DEAD = [0.0, 0.5, 1.0]       # share of dead (64, 128) GEMM tiles or SSA planes


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import importlib

    from repro.core import packing as jpk
    from repro.core import spiking_attention as jsa
    from repro.kernels.spike_matmul import ops as jmops
    from repro.kernels.spiking_attention import ops as jsops

    jlif = importlib.import_module("repro.core.lif")
    return SimpleNamespace(pk=jpk, lif=jlif, sa=jsa, mops=jmops, sops=jsops)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spikes(seed, shape, p=0.5):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.float32)


def _sparse_spikes(seed, shape):
    """A train with dense, thin and empty stretches of the feature axis, so
    that occupancy tiles range from full to zero."""
    x = _spikes(seed, shape, p=0.3)
    d = shape[-1]
    mid = x[..., d // 3: 2 * d // 3]
    mid *= _spikes(seed + 1, mid.shape, p=0.02)
    x[..., 2 * d // 3:] = 0
    return x


def _drive(seed, shape):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 0.6, shape).astype(np.float32)
    grid = rng.random(shape) < 1 / 3
    d[grid] = np.round(d[grid] * 8) / 8
    return d


def _words(seed, t, shape, p=0.5):
    return tpk.pack(torch.from_numpy(_spikes(seed, (t,) + shape, p))).words


def _weights(seed, shape):
    """Weights at the model's own scale (``linear_init``: uniform within
    1/sqrt(fan-in)), so outputs are O(1) and atol 1e-5 bounds f32
    reassociation."""
    fan_in = int(np.prod(shape[:-1]))
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)


def _jw(words):
    return bridge.words_to_numpy(words)


def _occ(a):
    """A JAX uint32 occupancy map as int32 (the counts fit)."""
    return np.asarray(a).astype(np.int32)


# -- occupancy maps ------------------------------------------------------------------

@pytest.mark.parametrize("d", [48, 130, 384])
@pytest.mark.parametrize("t", STEPS)
def test_occupancy_map_vs_jax(ref, t, d):
    x = _sparse_spikes(t + d, (t, 3, d))
    x[:, 1] = 0                                  # a silent row: zero tiles at any D
    got, want = tpk.pack(torch.from_numpy(x), occupancy=True), ref.pk.pack(x, occupancy=True)
    assert got.occ.dtype == torch.int32 and got.occ.shape == (tpk.num_words(t), 3, -(-d // 128))
    np.testing.assert_array_equal(got.occ.numpy(), _occ(want.occ))
    np.testing.assert_array_equal(tpk.occupancy_map(got.words).numpy(),
                                  _occ(ref.pk.occupancy_map(want.words)))
    assert got.occ.sum() == tpk.spike_counts(got).sum() == x.sum()
    assert (got.occ == 0).any() and tpk.pack(torch.from_numpy(x)).occ is None


def test_occupancy_map_all_ones_and_scalar_elements(ref):
    ps = tpk.pack(torch.ones((32, 2, 130)), occupancy=True)
    assert ps.occ.tolist() == [[[32 * 128, 32 * 2]] * 2]
    words = _words(1, 4, (5,))
    np.testing.assert_array_equal(tpk.occupancy_map(words).numpy(),
                                  _occ(ref.pk.occupancy_map(_jw(words))))
    assert tpk.occupancy_nbytes(40, 1000) == ref.pk.occupancy_nbytes(40, 1000) == 64


def test_iand_refreshes_the_map_vs_jax(ref):
    skip, s = _sparse_spikes(3, (33, 4, 130)), _sparse_spikes(4, (33, 4, 130))
    got = tpk.iand(tpk.pack(torch.from_numpy(skip), occupancy=True),
                   tpk.pack(torch.from_numpy(s)))
    want = ref.pk.iand(ref.pk.pack(skip, occupancy=True), ref.pk.pack(s))
    np.testing.assert_array_equal(got.occ.numpy(), _occ(want.occ))
    assert torch.equal(got.occ, tpk.occupancy_map(got.words))
    assert tpk.iand(tpk.pack(torch.from_numpy(skip)), tpk.pack(torch.from_numpy(s))).occ is None


@pytest.mark.parametrize("shape", [(6, 130), (780,), (3, 2, 130)])
def test_reshape_elems_keeps_or_recomputes_the_map_vs_jax(ref, shape):
    x = _sparse_spikes(5, (4, 2, 3, 130))
    got = tpk.pack(torch.from_numpy(x), occupancy=True).reshape_elems(*shape)
    want = ref.pk.pack(x, occupancy=True).reshape_elems(*shape)
    np.testing.assert_array_equal(got.occ.numpy(), _occ(want.occ))
    assert torch.equal(got.occ, tpk.occupancy_map(got.words))
    ps = tpk.PackedSpikes(got.words, 4)
    assert ps.with_occupancy().occ.equal(got.occ) and got.with_occupancy() is got
    with pytest.raises(TypeError, match="int32"):
        tpk.PackedSpikes(got.words, 4, occ=got.occ.long())


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("iand", [False, True])
@pytest.mark.parametrize("t", [4, 40])
def test_lif_pack_occupancy_vs_jax(ref, t, iand, use_kernel):
    """The map is taken of the final words, IAND applied, on both routes."""
    drive = _drive(t, (t, 3, 130))
    drive[..., 100:] -= 9.0                     # a silent stretch: zero tiles
    skip = _sparse_spikes(t + 1, (t, 3, 130))
    jskip = ref.pk.pack(skip) if iand else None
    tskip = tpk.pack(torch.from_numpy(skip)) if iand else None
    want = ref.lif.lif(drive, use_kernel=use_kernel, interpret=True, iand_skip=jskip,
                       pack_output=True, pack_occupancy=True)
    got = tlif.lif(torch.from_numpy(drive), use_kernel=use_kernel, iand_skip=tskip,
                   pack_output=True, pack_occupancy=True)
    np.testing.assert_array_equal(_jw(got.words), np.asarray(want.words))
    np.testing.assert_array_equal(got.occ.numpy(), _occ(want.occ))
    assert (got.occ == 0).any()
    assert tlif.lif(torch.from_numpy(drive), use_kernel=use_kernel, iand_skip=tskip,
                    pack_output=True).occ is None


def test_pack_occupancy_requires_pack_output():
    with pytest.raises(ValueError, match="requires pack_output"):
        tlif.lif(torch.zeros((4, 8)), pack_occupancy=True)
    with pytest.raises(ValueError, match="do not tile"):
        tlops.lif_parallel_pack_fwd(torch.zeros((4, 10)), chain_len=4, lam=0.25, theta=0.5,
                                    reset="hard", occ_cols=3)


# -- K8: occupancy-gated packed GEMM ----------------------------------------------------

def _dead_tiles(xw, share, seed):
    """Zero a ``share`` of the (64-row, 128-feature) tiles of (M, K) words."""
    mt, kt = tmops.grid_tiles_shape(*xw.shape)
    dead = np.random.default_rng(seed).permutation(mt * kt)[:round(share * mt * kt)]
    xw = xw.clone()
    for i in dead:
        r, c = divmod(int(i), kt)
        xw[64 * r:64 * (r + 1), 128 * c:128 * (c + 1)] = 0
    return xw


@pytest.mark.parametrize("share", DEAD)
@pytest.mark.parametrize("m,k,c,t", [(130, 300, 70, 4), (200, 384, 40, 32), (64, 130, 33, 1)])
def test_sparse_packed_matmul_plain_vs_pallas_kernel(ref, m, k, c, t, share):
    xw = _dead_tiles(_words(m + k, t, (m, k))[0], share, m)
    w = _weights(k, (k, c))
    occ = tpk.occupancy_map(xw)
    tiles = tmops._occ_to_grid_tiles(occ, xw)
    assert abs((tiles == 0).float().mean().item() - share) < 0.15
    got = tmops.sparse_packed_spike_matmul_op(xw, torch.from_numpy(w), t=t, occ=occ)
    want = ref.mops.sparse_packed_spike_matmul_op(_jw(xw), w, t=t, occ=_occ(occ).astype(np.uint32),
                                                  interpret=True)
    assert got.shape == (t, m, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    packed = tmops.packed_spike_matmul_op(xw, torch.from_numpy(w), t=t)
    assert torch.equal(got, packed)
    assert torch.equal(tmops.sparse_packed_spike_matmul_op(xw, torch.from_numpy(w), t=t), packed)


def test_sparse_packed_matmul_plain_skips_what_the_counts_say():
    """A tile whose count is 0 contributes nothing, whatever its words."""
    xw = _words(1, 4, (70, 200))[0]
    w = torch.ones((200, 3))
    tiles = torch.ones(tmops.grid_tiles_shape(70, 200), dtype=torch.int32)
    tiles[1, 0] = 0
    got = tmops.sparse_packed_spike_matmul_fwd(xw, w, tiles, t=4)
    masked = xw.clone()
    masked[64:, :128] = 0
    assert torch.equal(got, tmops.packed_spike_matmul_op(masked, w, t=4))
    with pytest.raises(ValueError, match="tiling"):
        tmops.sparse_packed_spike_matmul_fwd(xw, w, tiles[:, :1], t=4)


@pytest.mark.parametrize("with_map", [False, True])
@pytest.mark.parametrize("m,k", [(130, 300), (64, 128), (5, 20), (257, 384)])
def test_occ_to_grid_tiles_vs_jax(ref, m, k, with_map):
    """The port's tiling is the CUDA kernel's (64 rows, 128 features); the
    JAX twin reduced to the same tiling gives the same counts."""
    xw = _dead_tiles(_words(m, 4, (m, k), p=0.05)[0], 0.5, k)
    occ = tpk.occupancy_map(xw) if with_map else None
    got = tmops._occ_to_grid_tiles(occ, xw)
    mp, kp = -(-m // 64) * 64, -(-k // 128) * 128
    xp = np.zeros((mp, kp), np.uint32)
    xp[:m, :k] = _jw(xw)
    want = ref.mops._occ_to_grid_tiles(None if occ is None else _occ(occ).astype(np.uint32),
                                       xp, mp, kp, 64, 128)
    np.testing.assert_array_equal(got.numpy(), _occ(want))
    assert got.sum() == tpk.popcount(xw).sum()


@pytest.mark.parametrize("share", DEAD)
def test_sparse_packed_conv3x3_plain_vs_pallas_kernel(ref, share):
    t = 4
    x = _spikes(9, (t, 2, 9, 7, 16), p=0.2) * (np.random.default_rng(10).random((1, 2, 9, 7, 1))
                                                 >= share)
    xw = tpk.pack(torch.from_numpy(x)).words[0]
    wt = _weights(11, (3, 3, 16, 6))
    want = ref.mops.sparse_packed_conv3x3_op(_jw(xw), wt, t=t, interpret=True)
    got = tmops.sparse_packed_conv3x3_op(xw, torch.from_numpy(wt), t=t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert torch.equal(got, tmops.packed_conv3x3_op(xw, torch.from_numpy(wt), t=t))


@pytest.mark.parametrize("m,k,c", [(0, 8, 4), (5, 0, 4), (5, 8, 0)])
def test_sparse_packed_matmul_zero_sized_dims(m, k, c):
    got = tmops.sparse_packed_spike_matmul_op(torch.zeros((m, k), dtype=torch.int32),
                                              torch.ones((k, c)), t=4)
    assert got.shape == (4, m, c) and not got.any()


# -- K9: plane-gated packed SSA ----------------------------------------------------------

def _dead_planes(words, t, share, seed):
    """Zero bit t of the q words of a ``share`` of the (b, h, t) planes."""
    b, h = words.shape[1:3]
    planes = np.random.default_rng(seed).permutation(b * h * t)[:round(share * b * h * t)]
    words = words.clone()
    for i in planes:
        bh, ti = divmod(int(i), t)
        wi, bit = divmod(ti, 32)
        words[wi, bh // h, bh % h] &= ~(1 << bit)
    return words


@pytest.mark.parametrize("share", DEAD)
@pytest.mark.parametrize("t,causal", [(4, False), (4, True), (33, False)])
def test_sparse_packed_ssa_plain_vs_pallas_kernel(ref, t, causal, share):
    shape = (2, 2, 13, 16)          # (B, H, N, Dh): N ragged
    qw = _dead_planes(_words(t, t, shape), t, share, t)
    kw, vw = _words(t + 1, t, shape), _words(t + 2, t, shape)
    want = ref.sops.sparse_packed_ssa_op(*map(_jw, (qw, kw, vw)), t=t, interpret=True,
                                         causal=causal)
    got = tsops.sparse_packed_ssa_op(qw, kw, vw, t=t, causal=causal)
    assert got.shape == (t,) + shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tsops.packed_ssa_op(qw, kw, vw, t=t, causal=causal))
    fold = lambda x: x.reshape(x.shape[0], 4, 13, 16)
    live = tsops._plane_liveness(fold(qw), fold(kw), fold(vw), t)
    assert abs(1 - live.float().mean().item() - share) < 0.2


@pytest.mark.parametrize("t", [1, 4, 33, 40])
def test_plane_liveness_vs_jax(ref, t):
    qw, kw, vw = (_words(s, t, (3, 7, 8), p=0.2) for s in (1, 2, 3))
    for ti in range(0, t, 2):                    # q of fold 1 silent at even steps
        qw[ti // 32, 1] &= ~(1 << (ti % 32))
    vw[:, 2] = 0                                 # v of fold 2 silent throughout
    got = tsops._plane_liveness(qw, kw, vw, t)
    want = np.asarray(ref.sops._plane_liveness(*map(_jw, (qw, kw, vw)), t))
    assert got.dtype == torch.int32 and got.shape == (3, t)
    np.testing.assert_array_equal(got.numpy(), want[:, :t])
    assert not want[:, t:].any() and got[0].all() and not got[2].any()
    assert not got[1, ::2].any()


def test_sparse_packed_ssa_plain_skips_what_the_liveness_says():
    t, shape = 4, (1, 2, 9, 8)
    qw, kw, vw = (_words(s, t, shape).reshape(1, 2, 9, 8) for s in (1, 2, 3))
    live = torch.ones((2, t), dtype=torch.int32)
    live[1, 2] = 0
    got = tsops.sparse_packed_ssa_fwd(qw, kw, vw, live, t=t, scale=0.125)
    want = tsops.packed_ssa_fwd(qw, kw, vw, t=t, scale=0.125)
    want[2, 1] = 0
    assert torch.equal(got, want) and want[2, 0].any()
    with pytest.raises(ValueError, match="liveness"):
        tsops.sparse_packed_ssa_fwd(qw, kw, vw, live[:, :2], t=t, scale=0.125)


@pytest.mark.parametrize("t,causal", [(4, False), (4, True), (33, False)])
def test_ssa_packed_sparse_vs_jax(ref, t, causal):
    shape = (1, 2, 13, 16)
    qw = _dead_planes(_words(5, t, shape), t, 0.5, 6)
    qw[:, :, :, :, :] &= ~1                      # plane 0 dead in the whole batch
    kw, vw = _words(7, t, shape), _words(8, t, shape)
    want = ref.sa.ssa_packed_sparse(*map(_jw, (qw, kw, vw)), t=t, causal=causal)
    got = tsa.ssa_packed_sparse(qw, kw, vw, t=t, causal=causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tsops.packed_ssa_op(qw, kw, vw, t=t, causal=causal))
    np.testing.assert_array_equal(tsa.plane_occupancy(qw, t=t).numpy(),
                                  np.asarray(ref.sa.plane_occupancy(_jw(qw), t=t)))


# -- wrappers -------------------------------------------------------------------------

def test_sparse_wrappers_never_take_the_plain_version_off_the_cpu():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tlops.lif_pack_op(torch.empty((4, 8), **meta), occupancy=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tmops.sparse_packed_spike_matmul_op(torch.empty((4, 8), dtype=torch.int32, **meta),
                                            torch.empty((8, 2), **meta), t=4)
    with pytest.raises(ValueError, match="CUDA device"):
        words = torch.empty((1, 1, 2, 5, 8), dtype=torch.int32, **meta)
        tsops.sparse_packed_ssa_op(words, words, words, t=4)


def test_sparse_cpu_wrappers_count_no_launch():
    counters = (tlops.lif_parallel_pack_fwd, tmops.sparse_packed_spike_matmul_fwd,
                tsops.sparse_packed_ssa_fwd)
    before = [f.launches for f in counters]
    tlops.lif_pack_op(torch.from_numpy(_drive(1, (4, 8))), occupancy=True)
    tmops.sparse_packed_spike_matmul_op(_words(1, 4, (3, 8))[0], torch.ones((8, 2)), t=4)
    w = _words(2, 4, (1, 1, 5, 8))
    tsops.sparse_packed_ssa_op(w, w, w, t=4)
    assert [f.launches for f in counters] == before


# -- on the card -------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("iand", [False, True])
@pytest.mark.parametrize("t,rows,d", [(4, 8 * 196, 384), (4, 3, 130), (40, 5, 48),
                                      (1, 64, 1536), (4, 7, 20)])
def test_lif_pack_occupancy_epilogue_on_card(card, t, rows, d, iand):
    drive = torch.from_numpy(_drive(t + d, (t, rows, d))).to(card)
    drive[..., d // 2:] -= 9.0                   # silent tiles too
    skip = _words(d, t, (rows, d)).to(card) if iand else None
    before = tlops.lif_parallel_pack_fwd.launches
    if iand:
        words, occ = tlops.lif_iand_pack_op(drive, skip, occupancy=True)
        want = tlops.lif_iand_pack_op(drive, skip)
    else:
        words, occ = tlops.lif_pack_op(drive, occupancy=True)
        want = tlops.lif_pack_op(drive)
    torch.cuda.synchronize()
    assert tlops.lif_parallel_pack_fwd.launches == before + 2
    assert torch.equal(words, want)
    assert torch.equal(occ, tpk.occupancy_map(words))


@pytest.mark.cuda
@pytest.mark.parametrize("share", DEAD)
@pytest.mark.parametrize("m,k,c,t", [(130, 300, 70, 4), (1568, 384, 1536, 4), (1, 1, 1, 1),
                                     (999, 1536, 33, 32), (500, 100, 50, 3)])
def test_sparse_packed_matmul_kernel_vs_packed_kernel_on_card(card, m, k, c, t, share):
    xw = _dead_tiles(_words(m, t, (m, k))[0], share, k).to(card)
    w = torch.from_numpy(np.random.default_rng(k).normal(0, 0.3, (k, c)).astype(np.float32)).to(card)
    occ = tpk.occupancy_map(xw)
    before = tmops.sparse_packed_spike_matmul_fwd.launches
    got = tmops.sparse_packed_spike_matmul_op(xw, w, t=t, occ=occ)
    torch.cuda.synchronize()
    assert tmops.sparse_packed_spike_matmul_fwd.launches == before + 1
    assert torch.equal(got, tmops.packed_spike_matmul_op(xw, w, t=t))
    assert torch.equal(got, tmops.sparse_packed_spike_matmul_op(xw, w, t=t))
    torch.backends.cuda.matmul.allow_tf32 = False
    tiles = tmops._occ_to_grid_tiles(occ, xw)
    plain = tmops.sparse_packed_spike_matmul_ref(xw, w, tiles, t=t)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("share", DEAD)
@pytest.mark.parametrize("shape,t,causal,m,ones", [
    ((1, 2, 13, 16), 4, False, None, False), ((2, 12, 196, 32), 4, True, None, False),
    ((1, 3, 33, 8), 1, False, None, False), ((1, 2, 70, 128), 4, False, None, False),
    ((1, 1, 40, 64), 33, True, None, False), ((2, 2, 65, 48), 2, False, None, False),
    ((1, 3, 33, 13), 4, False, None, False), ((1, 3, 33, 13), 4, True, None, False),
    ((1, 2, 49, 20), 4, True, None, False), ((1, 2, 1, 20), 4, False, None, False),  # N = M = 1
    ((1, 2, 1, 20), 2, True, None, False),
    ((1, 2, 57, 20), 4, False, 40, False), ((1, 2, 57, 20), 4, True, 40, False),     # N != M
    ((1, 2, 40, 20), 4, True, 57, False),
    ((1, 2, 40, 32), 33, True, None, False), ((1, 2, 40, 32), 40, True, None, False),
    ((1, 2, 40, 32), 40, False, None, False),
    ((1, 4, 196, 128), 4, False, None, True), ((1, 4, 196, 128), 4, True, None, True),
    # past Dh = 128: the wide kernel, gated by plane
    ((1, 2, 70, 129), 4, True, None, False), ((4, 4, 32, 512), 4, True, None, False),
    ((1, 2, 57, 200), 4, False, 40, False), ((1, 2, 40, 200), 4, True, 57, False),
    ((1, 1, 24, 200), 33, True, None, False),
    ((1, 2, 196, 512), 4, False, None, True), ((1, 2, 196, 512), 4, True, None, True),
])
def test_sparse_packed_ssa_kernel_vs_packed_kernel_on_card(card, shape, t, causal, m, ones,
                                                          share):
    """The gated kernel equals the ungated packed kernel (one tensor-core
    kernel, ``packed_ssa_tc_kernel``, instantiated with and without the
    liveness map) and the plain version bit for bit; all ones at Dh=128
    give the largest scores and sums."""
    kv_shape = shape[:2] + (m or shape[2], shape[3])
    qw = _words(1, t, shape)
    kw, vw = _words(3, t, kv_shape), _words(4, t, kv_shape)
    if ones:
        qw, kw, vw = (tpk.pack(torch.ones((t,) + x.shape[1:])).words for x in (qw, kw, vw))
    qw = _dead_planes(qw, t, share, 2).to(card)
    kw, vw = kw.to(card), vw.to(card)
    before = tsops.sparse_packed_ssa_fwd.launches
    got = tsops.sparse_packed_ssa_op(qw, kw, vw, t=t, causal=causal)
    torch.cuda.synchronize()
    assert tsops.sparse_packed_ssa_fwd.launches == before + 1
    assert torch.equal(got, tsops.packed_ssa_op(qw, kw, vw, t=t, causal=causal))
    fold = lambda x: x.reshape((x.shape[0], -1) + tuple(x.shape[3:]))
    qf, kf, vf = fold(qw), fold(kw), fold(vw)
    want = sparse_packed_ssa_ref(qf, kf, vf, tsops._plane_liveness(qf, kf, vf, t), t=t,
                                 scale=0.125, causal=causal)
    assert torch.equal(got, want.reshape(got.shape))
    if m is None:
        dense = [tpk.unpack(tpk.PackedSpikes(x, t)) for x in (qw, kw, vw)]
        assert torch.equal(got, tsa.ssa(*dense, causal=causal))
