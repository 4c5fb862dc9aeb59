"""The arithmetic the spike GEMM's tensor-core kernels (``spike_matmul.cu``)
rest on, replayed on the CPU at small M and C and the main path's K.

The kernels split each f32 weight into three bf16 pieces, hi = bf16(w), mid =
bf16(w - hi), lo = bf16(w - hi - mid), take the spikes in bf16 (exact on
{0, 1}), and for every 32-feature stage add the products of two k16 steps,
piece by piece (hi, mid, lo), into a fresh f32 partial that one f32 add puts
into the output.  These tests replay that order in torch (the products of a
k16 step summed by a CPU matmul where the tensor cores sum them their own
way) and hold it against the port's plain versions and the JAX package's
oracle and Pallas kernel (interpret mode) within the card's GEMM tolerance,
rtol 1e-5 and atol 1e-4 (f32 reassociation over up to 1728 terms), on
spikes and on the integer counts the residual='add' configs give the dense
GEMM.  The split itself is exact (``hi + mid + lo == w``), and skipping the
stages of dead occupancy tiles (the gated kernel) gives the ungated order bit
for bit.  GEMM_TOL cannot tell three pieces from two at these K; rows with
one spike can, as the card's one-hot check does.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import packing as tpk
from repro_torch.kernels.spike_matmul.ref import (
    OCC_ROWS, packed_spike_matmul_ref, spike_matmul_ref)

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

GEMM_TOL = dict(rtol=1e-5, atol=1e-4)   # chip_smoke.py's tolerance for the card
STAGE, K16 = 32, 16                     # features per partial sum, per mma step
MAIN_K = (432, 864, 1728, 384, 1536)    # the 8-384 main path's contraction lengths


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    from repro.kernels.spike_matmul import ops as jops
    from repro.kernels.spike_matmul import ref as jref

    return SimpleNamespace(ops=jops, ref=jref)


def split3(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 weights -> (hi, mid, lo) bf16, each the round-to-nearest bf16 of
    the residual left by the pieces before it."""
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def tensor_core_order(x: torch.Tensor, w: torch.Tensor,
                      dead: torch.Tensor | None = None, pieces: int = 3) -> torch.Tensor:
    """(M, K) spikes or counts x (K, C) f32 in the kernels' order.  ``dead``: a
    (ceil(M/64), ceil(K/128)) bool map of occupancy tiles whose stages are
    skipped, as the gated kernel skips them (rows grouped by 64, features by
    128).  ``pieces``: how many of hi, mid, lo are multiplied (the control
    builds of the kernel keep one or two)."""
    m, k = x.shape
    x16 = x.to(torch.bfloat16)
    assert torch.equal(x16.float(), x), "the operand is not exact in bf16"
    pieces = [p.float() for p in split3(w)[:pieces]]
    out = torch.zeros((m, w.shape[1]), dtype=torch.float32)
    for r0 in range(0, m, OCC_ROWS):
        xs, acc = x16[r0:r0 + OCC_ROWS].float(), out[r0:r0 + OCC_ROWS]
        for k0 in range(0, k, STAGE):
            if dead is not None and dead[r0 // OCC_ROWS, k0 // tpk.OCC_TILE]:
                continue
            part = torch.zeros_like(acc)
            for f in range(k0, min(k0 + STAGE, k), K16):
                for p in pieces:
                    part += xs[:, f:f + K16] @ p[f:f + K16]
            acc += part
    return out


ADD_STREAM_MAX = 17   # the residual stream's largest count at L = 8: 2L + 1 spike trains


def _operands(seed, m, k, c, rate=0.5, counts=False):
    """Random spikes (or counts 0..ADD_STREAM_MAX) and weights of the main
    path's scale, 1/sqrt(K)."""
    rng = np.random.default_rng(seed)
    if counts:
        x = rng.integers(0, ADD_STREAM_MAX + 1, (m, k)).astype(np.float32)
    else:
        x = (rng.random((m, k)) < rate).astype(np.float32)
    w = ((rng.random((k, c)) * 2 - 1) / np.sqrt(k)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,c", [(70, k, 24) for k in MAIN_K]
                         + [(33, 75, 13), (130, 200, 7)])          # ragged in every dim
def test_tensor_core_order_vs_plain_and_jax(ref, m, k, c):
    x, w = _operands(k + c, m, k, c)
    got = tensor_core_order(torch.from_numpy(x), torch.from_numpy(w))
    torch.testing.assert_close(got, spike_matmul_ref(torch.from_numpy(x), torch.from_numpy(w)),
                               **GEMM_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.ref.spike_matmul_ref(x, w)),
                               **GEMM_TOL)
    if k in (432, 75):     # the Pallas kernel itself, at the first tokenizer conv's K
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref.ops.spike_matmul_op(x, w, interpret=True)),
                                   **GEMM_TOL)


def test_packed_order_vs_jax(ref):
    """Every plane of the words through the dense order (the packed kernel's
    plane t of row m is the dense kernel's row t*M + m) against the packed
    oracle and Pallas kernel."""
    t, m, k, c = 4, 40, 384, 24
    planes, w = _operands(5, t * m, k, c)
    words = tpk.pack(torch.from_numpy(planes.reshape(t, m, k))).words[0]
    got = tensor_core_order(torch.from_numpy(planes), torch.from_numpy(w)).reshape(t, m, c)
    torch.testing.assert_close(got, packed_spike_matmul_ref(words, torch.from_numpy(w), t=t),
                               **GEMM_TOL)
    xw = bridge.words_to_numpy(words)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.ref.packed_spike_matmul_ref(xw, w, t)),
                               **GEMM_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.ops.packed_spike_matmul_op(xw, w, t=t, interpret=True)),
        **GEMM_TOL)


def test_split_is_exact_across_magnitudes():
    """hi + mid + lo == w for f32 weights of either sign from 1e-30 to 1e3,
    each piece a bf16 value; two pieces alone keep only ~16 bits."""
    rng = np.random.default_rng(0)
    mags = 10.0 ** rng.uniform(-30, 3, 20000)
    w = torch.from_numpy((mags * rng.choice([-1.0, 1.0], mags.size)).astype(np.float32))
    w = torch.cat([w, torch.tensor([0.0, 1.0, -1.0, 3.0e-30, 999.9], dtype=torch.float32)])
    hi, mid, lo = split3(w)
    assert torch.equal(hi.float() + mid.float() + lo.float(), w)
    assert torch.equal(hi.double() + mid.double() + lo.double(), w.double())
    two = ((hi.double() + mid.double() - w.double()).abs() / w.double().abs()).nan_to_num()
    assert two.max().item() > 1e-6     # why a third piece: 2 x 8 bits fall short of f32


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
def test_gated_order_equals_ungated(share):
    """Skipping the stages of dead (64-row, 128-feature) tiles, whose spikes
    are all zero, gives the ungated order bit for bit."""
    m, k, c = 150, 400, 16
    x, w = _operands(int(10 * share), m, k, c)
    mt, kt = -(-m // OCC_ROWS), -(-k // tpk.OCC_TILE)
    dead = torch.from_numpy(np.random.default_rng(1).random((mt, kt)) < share)
    rows = dead.repeat_interleave(OCC_ROWS, 0)[:m].repeat_interleave(tpk.OCC_TILE, 1)[:, :k]
    xt = torch.where(rows, 0.0, torch.from_numpy(x))
    wt = torch.from_numpy(w)
    assert torch.equal(tensor_core_order(xt, wt, dead=dead), tensor_core_order(xt, wt))


@pytest.mark.parametrize("m,k,c", [(70, 384, 24), (70, 1536, 24), (33, 75, 13)])
def test_counts_order_vs_plain_and_jax(ref, m, k, c):
    """The residual='add' configs' dense GEMM reads the residual stream,
    integer counts up to 2L + 1: exact in bf16, each product with a piece
    exact in f32, so the kernels' order stays within GEMM_TOL."""
    x, w = _operands(k + c + 1, m, k, c, counts=True)
    got = tensor_core_order(torch.from_numpy(x), torch.from_numpy(w))
    torch.testing.assert_close(got, spike_matmul_ref(torch.from_numpy(x), torch.from_numpy(w)),
                               **GEMM_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.ref.spike_matmul_ref(x, w)),
                               **GEMM_TOL)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units in the last place of ``want``."""
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"))) - want.abs()
    return ((got - want).abs() / ulp).max().item()


@pytest.mark.parametrize("k", MAIN_K)
def test_gemm_tol_is_blind_to_the_third_piece(k):
    """At the main path's K a two-piece order (hi, mid) passes GEMM_TOL on
    random spikes: the missing lo piece costs less than the f32 sum's own
    reordering.  Rows with one spike show it: three pieces give the selected
    weights exactly, two miss them by many units in the last place."""
    m, c = 64, 24
    x, w = (torch.from_numpy(a) for a in _operands(k, m, k, c))
    two = tensor_core_order(x, w, pieces=2)
    assert torch.allclose(two, spike_matmul_ref(x, w), **GEMM_TOL)
    rows = torch.arange(m) * 7 % k
    one_hot = torch.nn.functional.one_hot(rows, k).float()
    assert torch.equal(tensor_core_order(one_hot, w), w[rows])
    assert _ulps(tensor_core_order(one_hot, w, pieces=2), w[rows]) > 8
