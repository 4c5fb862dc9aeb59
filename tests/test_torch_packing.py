"""The port's bit-packed spike datapath held against the JAX package's:
``core/packing`` (pack, unpack, iand, spike_counts) with the words bit-equal
through the uint32 view, and the plain versions of the three packed kernels
-- the LIF pack epilogue, the packed spike GEMM and the packed SSA -- against
the Pallas kernels in interpret mode.  Tolerances: words and spikes exact; the
GEMM rtol = atol = 1e-5 (f32 sums in another order than XLA's); SSA exact
(integer arithmetic on binary operands).  Tests marked ``cuda`` hold the CUDA
kernels against their plain versions on the card."""

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

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = [1, 4, 8, 32, 33, 40]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import importlib

    from repro.core import packing as jpk
    from repro.core import spiking_attention as jsa
    from repro.kernels.lif_parallel import ops as jlops
    from repro.kernels.spike_matmul import ops as jmops
    from repro.kernels.spiking_attention import ops as jsops

    # ``from repro.core import lif`` would bind the function the package
    # re-exports over the submodule's name
    jlif = importlib.import_module("repro.core.lif")
    return SimpleNamespace(pk=jpk, lif=jlif, sa=jsa, lops=jlops, mops=jmops, sops=jsops)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spikes(seed, shape, p=0.5):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.float32)


def _drive(seed, shape):
    """Normal drive with a third of the entries on a 1/8 grid, so membranes
    land exactly on theta (the >= boundary) as well as near it."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 0.6, shape).astype(np.float32)
    grid = rng.random(shape) < 1 / 3
    d[grid] = np.round(d[grid] * 8) / 8
    return d


def _words(seed, t, shape):
    """Port words (int32) of a random spike train (T, *shape)."""
    return tpk.pack(torch.from_numpy(_spikes(seed, (t,) + shape))).words


def _jwords(words):
    return bridge.words_to_numpy(words)


# -- core/packing ----------------------------------------------------------------

@pytest.mark.parametrize("t", STEPS)
def test_pack_unpack_counts_vs_jax(ref, t):
    x = _spikes(t, (t, 3, 37))
    got, want = tpk.pack(torch.from_numpy(x)), ref.pk.pack(x)
    assert got.words.dtype == torch.int32 and got.t == t
    assert got.words.shape == want.words.shape == (tpk.num_words(t), 3, 37)
    np.testing.assert_array_equal(_jwords(got.words), np.asarray(want.words))
    np.testing.assert_array_equal(tpk.unpack(got).numpy(), np.asarray(ref.pk.unpack(want)))
    np.testing.assert_array_equal(tpk.unpack(got).numpy(), x)
    np.testing.assert_array_equal(tpk.spike_counts(got).numpy(),
                                  np.asarray(ref.pk.spike_counts(want)).astype(np.int32))
    np.testing.assert_array_equal(tpk.spike_counts(got).numpy(), x.sum(axis=0))
    if t % 32:    # the ragged tail of the last word is zero
        assert not (_jwords(got.words)[-1] >> np.uint32(t % 32)).any()


@pytest.mark.parametrize("t", STEPS)
def test_iand_vs_jax(ref, t):
    skip, s = _spikes(2 * t, (t, 5, 17)), _spikes(2 * t + 1, (t, 5, 17))
    got = tpk.iand(tpk.pack(torch.from_numpy(skip)), tpk.pack(torch.from_numpy(s)))
    want = ref.pk.iand(ref.pk.pack(skip), ref.pk.pack(s))
    np.testing.assert_array_equal(_jwords(got.words), np.asarray(want.words))
    np.testing.assert_array_equal(tpk.unpack(got).numpy(), skip * (1 - s))


def test_all_ones_word_counts_32():
    """Bit 31 set: the int32 word is negative, and the arithmetic shifts must
    not smear its sign into the count."""
    ps = tpk.pack(torch.ones((32, 4)))
    assert (ps.words == -1).all()
    assert (tpk.spike_counts(ps) == 32).all()
    assert torch.equal(tpk.unpack(ps), torch.ones((32, 4)))


def test_sizes_vs_jax(ref):
    for t in STEPS:
        assert tpk.num_words(t) == ref.pk.num_words(t)
        assert tpk.packed_nbytes(t, 1000) == ref.pk.packed_nbytes(t, 1000)
        assert tpk.dense_nbytes(t, 1000) == ref.pk.dense_nbytes(t, 1000)
    with pytest.raises(ValueError):
        tpk.num_words(0)


def test_packed_spikes_takes_int32_words_only():
    with pytest.raises(TypeError, match="int32"):
        tpk.PackedSpikes(torch.zeros((1, 4), dtype=torch.int64), t=4)
    ps = tpk.PackedSpikes(torch.zeros((1, 2, 6), dtype=torch.int32), t=4)
    assert ps.dense_shape == (4, 2, 6) and ps.reshape_elems(12).elem_shape == (12,)


def test_bridge_words_round_trip():
    a = np.array([[0, 1, 2**31, 2**32 - 1, 0x80000001]], dtype=np.uint32)
    t = bridge.words_to_torch(a)
    assert t.dtype == torch.int32 and t[0, 3].item() == -1
    np.testing.assert_array_equal(bridge.words_to_numpy(t), a)
    with pytest.raises(TypeError):
        bridge.words_to_torch(a.astype(np.int64))


# -- K4: LIF with the pack epilogue --------------------------------------------------

# The CUDA pack kernel's edges, each with its occupancy map: chunked loads
# where T != 4, a ragged last word, and rows of 48 and 200 features (ragged
# tiles, the atomic epilogue) and 2048 (whole tiles, summed in the warp), a
# third of the rows silent so that some tiles count 0:
# (t, chain_len, elems, reset, iand).
PACK_EDGES = [(33, 3, (5, 48), "hard", True), (40, 8, (3, 200), "soft", False),
              (1, 1, (2, 2048), "hard", True)]


@pytest.mark.parametrize("t,chain_len,elems,reset,iand,occ",
                         [pytest.param(t, c, (3, 100), r, i, False, id=f"{t}-{c}-{r}-{i}")
                          for i in (False, True) for r in ("hard", "soft")
                          for t, c in [(4, 1), (4, 2), (4, 4), (40, 8)]]
                         + [pytest.param(*e, True, id=f"{e[0]}-{e[1]}-D{e[2][-1]}-{e[3]}-{e[4]}")
                            for e in PACK_EDGES])
def test_lif_pack_plain_vs_pallas_kernel(ref, t, chain_len, elems, reset, iand, occ):
    """The words, and with ``occ`` their occupancy map (rows of the last
    axis's features)."""
    drive = _drive(t + chain_len, (t,) + elems)
    kw = dict(chain_len=chain_len, reset=reset)
    if occ:
        drive[:, ::3] -= 9.0                    # silent rows: zero tiles
        kw["occupancy"] = True
    if iand:
        skip = _spikes(7, (t,) + elems)
        if occ:
            skip[:, ::3] = 0.0
        jskip = ref.pk.pack(skip).words
        want = ref.lops.lif_iand_pack_op(drive, jskip, interpret=True, **kw)
        got = tlops.lif_iand_pack_op(torch.from_numpy(drive),
                                     bridge.words_to_torch(np.asarray(jskip)), **kw)
    else:
        want = ref.lops.lif_pack_op(drive, interpret=True, **kw)
        got = tlops.lif_pack_op(torch.from_numpy(drive), **kw)
    words, jwords = (got[0], want[0]) if occ else (got, want)
    assert words.shape == (tpk.num_words(t),) + elems
    np.testing.assert_array_equal(_jwords(words), np.asarray(jwords))
    if occ:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int32))
        assert (got[1] == 0).any()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("schedule", ["parallel", "serial"])
def test_lif_dispatch_pack_output_vs_jax(ref, schedule, use_kernel):
    drive, skip = _drive(50, (4, 64)), _spikes(51, (4, 64))
    want = ref.lif.lif(drive, schedule=schedule, use_kernel=use_kernel, interpret=True,
                       iand_skip=ref.pk.pack(skip), pack_output=True)
    got = tlif.lif(torch.from_numpy(drive), schedule=schedule, use_kernel=use_kernel,
                   iand_skip=tpk.pack(torch.from_numpy(skip)), pack_output=True)
    assert isinstance(got, tpk.PackedSpikes) and got.t == 4
    np.testing.assert_array_equal(_jwords(got.words), np.asarray(want.words))
    dense = tlif.lif(torch.from_numpy(drive), schedule=schedule,
                     iand_skip=torch.from_numpy(skip))
    assert torch.equal(tpk.unpack(got), dense)


def test_lif_pack_output_skip_types():
    drive = torch.zeros((4, 8))
    with pytest.raises(TypeError, match="requires a PackedSpikes"):
        tlif.lif(drive, iand_skip=torch.zeros((4, 8)), pack_output=True)
    with pytest.raises(TypeError, match="requires pack_output"):
        tlif.lif(drive, iand_skip=tpk.pack(torch.zeros((4, 8))))
    with pytest.raises(ValueError, match="time-step mismatch"):
        tlif.lif(drive, iand_skip=tpk.pack(torch.zeros((8, 8))), pack_output=True)


# -- K5: packed spike GEMM -----------------------------------------------------------

@pytest.mark.parametrize("m,k,c,t", [(130, 200, 70, 4), (7, 432, 96, 4), (300, 33, 129, 1),
                                     (50, 64, 40, 32), (9, 20, 5, 3)])
def test_packed_matmul_plain_vs_pallas_kernel(ref, m, k, c, t):
    xw = _words(m + t, t, (m, k))[0]
    w = np.random.default_rng(k).normal(0, 0.3, (k, c)).astype(np.float32)
    want = ref.mops.packed_spike_matmul_op(_jwords(xw), w, t=t, interpret=True)
    got = tmops.packed_spike_matmul_op(xw, torch.from_numpy(w), t=t)
    assert got.shape == (t, m, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = tpk.unpack(tpk.PackedSpikes(xw[None], t)).reshape(t * m, k)
    torch.testing.assert_close(got.reshape(t * m, c), dense @ torch.from_numpy(w), **TOL)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 7, 5, 6), (1, 6, 6, 16, 3)])
def test_packed_conv3x3_plain_vs_pallas_kernel(ref, n, h, w, cin, cout):
    t = 4
    xw = _words(h, t, (n, h, w, cin))[0]
    wt = np.random.default_rng(cin).normal(0, 0.3, (3, 3, cin, cout)).astype(np.float32)
    want = ref.mops.packed_conv3x3_op(_jwords(xw), wt, t=t, interpret=True)
    got = tmops.packed_conv3x3_op(xw, torch.from_numpy(wt), t=t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = tpk.unpack(tpk.PackedSpikes(xw[None], t)).reshape(t * n, h, w, cin)
    torch.testing.assert_close(got.reshape(t * n, h, w, cout),
                               tmops.conv3x3_op(dense, torch.from_numpy(wt)), **TOL)


@pytest.mark.parametrize("m,k,c", [(0, 8, 4), (5, 0, 4), (5, 8, 0)])
def test_packed_matmul_zero_sized_dims(m, k, c):
    got = tmops.packed_spike_matmul_op(torch.zeros((m, k), dtype=torch.int32),
                                       torch.ones((k, c)), t=4)
    assert got.shape == (4, m, c) and not got.any()


def test_packed_matmul_rejects_more_than_32_steps(ref):
    xw, w = torch.zeros((8, 8), dtype=torch.int32), torch.ones((8, 4))
    with pytest.raises(ValueError, match="T<=32"):
        tmops.packed_spike_matmul_op(xw, w, t=33)
    with pytest.raises(ValueError, match="T<=32"):
        ref.mops.packed_spike_matmul_op(np.zeros((8, 8), np.uint32), np.ones((8, 4), np.float32),
                                        t=33, interpret=True)


# -- K6: packed SSA --------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [4, 40])
def test_packed_ssa_plain_vs_pallas_kernel(ref, t, causal):
    shape = (1, 2, 13, 16)          # (B, H, N, Dh): N ragged
    qw, kw, vw = (_words(s, t, shape) for s in (t, t + 1, t + 2))
    want = ref.sops.packed_ssa_op(*map(_jwords, (qw, kw, vw)), t=t, interpret=True,
                                  causal=causal)
    got = tsops.packed_ssa_op(qw, kw, vw, t=t, causal=causal)
    assert got.shape == (t,) + shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dense = [tpk.unpack(tpk.PackedSpikes(x, t)) for x in (qw, kw, vw)]
    assert torch.equal(got, tsa.ssa(*dense, causal=causal))


def test_packed_ssa_takes_head_split_views(ref):
    t = 4
    xs = [tpk.pack(torch.from_numpy(_spikes(s, (t, 2, 13, 24)))) for s in (1, 2, 3)]
    views = [tsa.split_heads_packed(x, 3) for x in xs]
    assert not views[0].words.is_contiguous()
    want = ref.sa.split_heads_packed(ref.pk.pack(_spikes(1, (t, 2, 13, 24))), 3)
    np.testing.assert_array_equal(_jwords(views[0].words.contiguous()),
                                  np.asarray(want.words))
    got = tsops.packed_ssa_op(*(v.words for v in views), t=t)
    assert torch.equal(got, tsa.ssa(*(tpk.unpack(v) for v in views)))


def test_ssa_linear_packed_vs_jax(ref):
    t, shape = 4, (1, 2, 13, 16)
    words = [_words(s, t, shape) for s in (4, 5, 6)]
    want = ref.sa.ssa_linear_packed(*map(_jwords, words), t=t)
    np.testing.assert_array_equal(tsa.ssa_linear_packed(*words, t=t).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tsa.ssa_kv_state_packed(words[1], words[2], t=t).numpy(),
        np.asarray(ref.sa.ssa_kv_state_packed(_jwords(words[1]), _jwords(words[2]), t=t)))
    for chunk in (4, 16):     # the causal scan, ragged and one chunk
        np.testing.assert_array_equal(
            tsa.ssa_linear_packed(*words, t=t, causal=True, chunk=chunk).numpy(),
            np.asarray(ref.sa.ssa_linear_packed(*map(_jwords, words), t=t, causal=True,
                                                chunk=chunk)))


def test_packed_wrappers_never_take_the_plain_version_off_the_cpu():
    """Only a CPU tensor may take the plain version; any other device goes to
    the kernel path, which refuses what it cannot launch."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tlops.lif_pack_op(torch.empty((4, 8), **meta))
    with pytest.raises(ValueError, match="CUDA device"):
        tmops.packed_spike_matmul_op(torch.empty((4, 8), dtype=torch.int32, **meta),
                                     torch.empty((8, 2), **meta), t=4)
    with pytest.raises(ValueError, match="CUDA device"):
        words = torch.empty((1, 1, 2, 5, 8), dtype=torch.int32, **meta)
        tsops.packed_ssa_op(words, words, words, t=4)


def test_cpu_wrappers_count_no_launch():
    counters = (tlops.lif_parallel_pack_fwd, tmops.packed_spike_matmul_fwd,
                tsops.packed_ssa_fwd)
    before = [f.launches for f in counters]
    tlops.lif_pack_op(torch.from_numpy(_drive(1, (4, 8))))
    tmops.packed_spike_matmul_op(_words(1, 4, (3, 8))[0], torch.ones((8, 2)), t=4)
    w = _words(2, 4, (1, 1, 5, 8))
    tsops.packed_ssa_op(w, w, w, t=4)
    assert [f.launches for f in counters] == before


# -- on the card -------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("iand", [False, True])
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("t,chain_len", [(4, 1), (4, 4), (1, 1), (32, 8), (40, 40)])
def test_lif_pack_kernel_vs_plain_on_card(card, t, chain_len, reset, iand):
    drive = torch.from_numpy(_drive(70 + t, (t, 2, 517))).to(card)
    skip = _words(80, t, (2, 517)).to(card) if iand else None
    kw = dict(chain_len=chain_len, reset=reset)
    before = tlops.lif_parallel_pack_fwd.launches
    if iand:
        got = tlops.lif_iand_pack_op(drive, skip, **kw)
        want = tpk.iand(tpk.PackedSpikes(skip, t), tpk.pack(tlif.lif_parallel(drive, **kw)))
    else:
        got = tlops.lif_pack_op(drive, **kw)
        want = tpk.pack(tlif.lif_parallel(drive, **kw))
    torch.cuda.synchronize()
    assert tlops.lif_parallel_pack_fwd.launches == before + 1
    assert torch.equal(got, want.words)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,c,t", [(130, 200, 70, 4), (257, 432, 96, 4), (1, 1, 1, 1),
                                     (1568, 384, 384, 4), (300, 75, 257, 2), (999, 64, 33, 32),
                                     (500, 100, 50, 3)])
def test_packed_matmul_kernel_vs_plain_and_dense_kernel_on_card(card, m, k, c, t):
    """Within rtol 1e-5 / atol 1e-4 of the plain version, and bit-equal to the
    dense GEMM kernel on the unpacked operand (same fmaf order over k)."""
    xw = _words(m, t, (m, k))[0].to(card)
    w = torch.from_numpy(np.random.default_rng(k).normal(0, 0.3, (k, c)).astype(np.float32)).to(card)
    before = tmops.packed_spike_matmul_fwd.launches
    got = tmops.packed_spike_matmul_op(xw, w, t=t)
    torch.cuda.synchronize()
    assert tmops.packed_spike_matmul_fwd.launches == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dense = tpk.unpack(tpk.PackedSpikes(xw[None], t)).reshape(t * m, k)
    torch.testing.assert_close(got.reshape(t * m, c), dense @ w, rtol=1e-5, atol=1e-4)
    assert torch.equal(got.reshape(t * m, c), tmops.spike_matmul_op(dense, w))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t,causal", [
    ((1, 2, 13, 16), 4, False), ((1, 2, 13, 16), 40, True), ((2, 12, 196, 32), 4, False),
    ((2, 12, 196, 32), 4, True), ((1, 3, 33, 8), 1, False), ((2, 2, 65, 48), 2, True),
    ((1, 2, 70, 128), 4, False), ((1, 1, 40, 64), 33, True),
    ((1, 2, 40, 32), 33, False), ((1, 2, 40, 32), 40, False),      # multi-word T, every plane
    ((1, 2, 24, 20), 33, True), ((1, 1, 20, 128), 40, True),
    ((1, 2, 1, 20), 4, False), ((1, 4, 196, 128), 4, True),
    # past Dh = 128: the wide kernel, one plane and one 128-feature slab a block
    ((1, 2, 70, 129), 4, True), ((1, 2, 33, 200), 4, False), ((1, 1, 70, 257), 2, True),
    ((1, 2, 70, 512), 4, False), ((4, 4, 32, 512), 4, True), ((1, 1, 24, 200), 33, True),
])
def test_packed_ssa_kernel_vs_plain_on_card(card, shape, t, causal):
    qw, kw, vw = (_words(s, t, shape).to(card) for s in (1, 2, 3))
    before = tsops.packed_ssa_fwd.launches
    got = tsops.packed_ssa_op(qw, kw, vw, t=t, causal=causal)
    torch.cuda.synchronize()
    assert tsops.packed_ssa_fwd.launches == before + 1
    dense = [tpk.unpack(tpk.PackedSpikes(x, t)) for x in (qw, kw, vw)]
    assert torch.equal(got, tsa.ssa(*dense, causal=causal))
