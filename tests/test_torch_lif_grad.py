"""Gradients of the port's LIF and SSA held against the JAX package.

* ``surrogate_spike``: boxcar and ATan derivatives against JAX's custom JVP,
  ``rtol=1e-6`` (the ATan one is a division, rounded alike up to an ulp).
* The plain ``lif_parallel`` VJP (eager autograd) against JAX's jitted
  ``lif_parallel_ref_grad`` and its Pallas backward kernel (interpret mode),
  at ``rtol=1e-6`` (the JAX package's own kernel-backward tolerance) and
  ``atol=1e-7``: XLA contracts ``g - dv*u`` and ``ds*surr + dv*(1-s)`` into
  FMAs, eager PyTorch rounds each product on its own, so the two differ by
  about an ulp of those products (|g|, |dv*u| <~ 1 here: 6e-8) per chained
  step, which a cancelling sum can leave beside a much smaller result.
* ``lif_parallel_op`` and ``ssa_op`` through their autograd Functions (the
  result's ``grad_fn`` is checked: on the card the CPU fallthrough to a
  plain version does not exist, so a test that passed through it would
  prove nothing) against ``jax.vjp`` of JAX's ``lif_parallel_op`` and
  ``ssa_op``.  SSA gradients are sums of products of f32 cotangents with
  spikes in another order: ``rtol=1e-5, atol=1e-6``.
* The forward-only ops raise rather than cut the graph.

Tests marked ``cuda`` hold the LIF backward kernel against its plain version
on the card (``torch.equal``) and skip without one."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import lif as tlif
from repro_torch.kernels.lif_parallel import ops as tops
from repro_torch.kernels.lif_parallel.ref import lif_parallel_ref_grad
from repro_torch.kernels.spiking_attention import ops as tssa

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

T, N = 4, 300   # N ragged: not a multiple of the TPU kernel's 128 lanes
RTOL, ATOL = 1e-6, 1e-7
SSA_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    import jax

    from repro.core.lif import lif_parallel, surrogate_spike
    from repro.kernels.lif_parallel import kernel as jk
    from repro.kernels.lif_parallel import ops as jops
    from repro.kernels.lif_parallel.ref import lif_parallel_ref_grad as jgrad
    from repro.kernels.spiking_attention.ops import ssa_op

    return SimpleNamespace(jax=jax, lif_parallel=lif_parallel, surrogate_spike=surrogate_spike,
                           kernel=jk, ops=jops, ref_grad=jgrad, ssa_op=ssa_op)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _drive(seed, shape=(T, N)):
    """Normal drive with a third of the entries on a 1/8 grid, so membranes
    land exactly on theta and on the boxcar's edges too."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 0.6, shape).astype(np.float32)
    grid = rng.random(shape) < 1 / 3
    d[grid] = np.round(d[grid] * 8) / 8
    return d


def _cot(seed, shape=(T, N)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _vjp_torch(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    return out, dx.numpy()


@pytest.mark.parametrize("kind", ["boxcar", "atan"])
def test_surrogate_spike_grad_vs_jax(ref, kind):
    x = _drive(0) - 0.5
    g = _cot(1)
    y, vjp = ref.jax.vjp(lambda a: ref.surrogate_spike(a, 1.0, kind), x)
    out, got = _vjp_torch(lambda a: tlif.surrogate_spike(a, kind=kind), x, g)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(got, np.asarray(vjp(g)[0]), rtol=RTOL, atol=0)
    assert np.count_nonzero(got) > 0


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4])
def test_lif_parallel_grad_vs_jax_ref_grad(ref, chain_len, reset):
    drive, g = _drive(10 + chain_len), _cot(20 + chain_len)
    want = ref.ref_grad(drive, g, chain_len=chain_len, reset=reset)
    _, got = _vjp_torch(lambda d: tlif.lif_parallel(d, chain_len=chain_len, reset=reset),
                        drive, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got, lif_parallel_ref_grad(torch.from_numpy(drive), torch.from_numpy(g),
                                   chain_len=chain_len, reset=reset).numpy())


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4])
def test_lif_parallel_grad_vs_pallas_backward_kernel(ref, chain_len, reset):
    drive, g = _drive(30 + chain_len, (T, 256)), _cot(40 + chain_len, (T, 256))
    want = ref.kernel.lif_parallel_bwd(drive, g, chain_len=chain_len, lam=0.25, theta=0.5,
                                       reset=reset, width=1.0, interpret=True)
    got = tops.lif_parallel_bwd(torch.from_numpy(drive), torch.from_numpy(g),
                                chain_len=chain_len, lam=0.25, theta=0.5, reset=reset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4])
def test_lif_parallel_op_grad_vs_jax_op(ref, chain_len, reset):
    drive, g = _drive(50 + chain_len, (T, 3, 100)), _cot(60 + chain_len, (T, 3, 100))
    kw = dict(chain_len=chain_len, reset=reset)
    y, vjp = ref.jax.vjp(lambda d: ref.ops.lif_parallel_op(d, interpret=True, **kw), drive)
    out, got = _vjp_torch(lambda d: tops.lif_parallel_op(d, **kw), drive, g)
    assert _has_node(out, "_LifOp")
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(got, np.asarray(vjp(g)[0]), rtol=RTOL, atol=ATOL)


def _has_node(out, name):
    """True if the autograd graph behind ``out`` holds a node of ``name``'s
    autograd Function."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if name in type(fn).__name__:
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


def test_lif_dispatch_kernel_route_is_differentiable(ref):
    """``lif(use_kernel=True)`` goes through ``_LifOp`` and gives the plain
    chain's gradient; the plain route's graph has no ``_LifOp``."""
    drive, g = _drive(70), _cot(71)
    out, got = _vjp_torch(lambda d: tlif.lif(d, use_kernel=True), drive, g)
    assert _has_node(out, "_LifOp")
    plain, want = _vjp_torch(lambda d: tlif.lif(d), drive, g)
    assert not _has_node(plain, "_LifOp") and _has_node(plain, "SurrogateSpike")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_ssa_op_grad_vs_jax_op(ref, causal):
    rng = np.random.default_rng(80 + causal)
    shape = (2, 2, 3, 49, 16)
    q, k, v = ((rng.random(shape) > 0.5).astype(np.float32) for _ in range(3))
    g = rng.normal(size=shape).astype(np.float32)
    y, vjp = ref.jax.vjp(lambda a, b, c: ref.ssa_op(a, b, c, interpret=True, causal=causal),
                         q, k, v)
    want = vjp(g)
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tssa.ssa_op(*qkv, causal=causal)
    assert _has_node(out, "_SsaOp")
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    got = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SSA_TOL)


def test_forward_only_ops_raise_under_grad():
    drive = torch.from_numpy(_drive(90)).requires_grad_(True)
    skip = torch.ones_like(drive)
    for fn in (lambda: tops.lif_iand_op(drive, skip), lambda: tops.lif_pack_op(drive),
               lambda: tops.lif_iand_pack_op(drive, torch.zeros((1, N), dtype=torch.int32))):
        with pytest.raises(RuntimeError, match="forward-only"):
            fn()
    with torch.no_grad():
        tops.lif_iand_op(drive, skip)
        tops.lif_pack_op(drive)
    with pytest.raises(ValueError, match="boxcar"):
        tlif.lif(drive, use_kernel=True, surrogate="atan")


def test_cpu_backward_counts_no_launch():
    before = tops.lif_parallel_bwd.launches
    _vjp_torch(lambda d: tops.lif_parallel_op(d), _drive(91), _cot(92))
    assert tops.lif_parallel_bwd.launches == before


def test_backward_wrapper_rejects_bad_operands():
    d = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="cotangent shape"):
        tops.lif_parallel_bwd(d, torch.zeros((4, 9)), chain_len=4, lam=0.25, theta=0.5,
                              reset="hard")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.lif_parallel_bwd(d.to("meta"), d.to("meta"), chain_len=4, lam=0.25,
                              theta=0.5, reset="hard")


@pytest.mark.cuda
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4, 8, 16])
def test_lif_backward_kernel_bit_exact_vs_plain_on_card(card, chain_len, reset):
    t = max(16, chain_len)
    drive = torch.from_numpy(_drive(100 + chain_len, (t, 2, 517))).to(card)
    g = torch.from_numpy(_cot(110 + chain_len, (t, 2, 517))).to(card)
    before = tops.lif_parallel_bwd.launches
    got = tops.lif_parallel_bwd(drive.reshape(t, -1), g.reshape(t, -1), chain_len=chain_len,
                                lam=0.25, theta=0.5, reset=reset)
    want = lif_parallel_ref_grad(drive.reshape(t, -1), g.reshape(t, -1),
                                 chain_len=chain_len, reset=reset)
    torch.cuda.synchronize()
    assert tops.lif_parallel_bwd.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lif_op_backward_launches_the_kernel_on_card(card):
    drive = torch.from_numpy(_drive(120)).to(card).requires_grad_(True)
    fwd, bwd = tops.lif_parallel_fwd.launches, tops.lif_parallel_bwd.launches
    out = tlif.lif(drive, use_kernel=True)
    (dx,) = torch.autograd.grad(out, drive, torch.ones_like(out))
    torch.cuda.synchronize()
    assert (tops.lif_parallel_fwd.launches, tops.lif_parallel_bwd.launches) == (fwd + 1, bwd + 1)
    assert torch.equal(dx, lif_parallel_ref_grad(drive.detach(), torch.ones_like(out)))
