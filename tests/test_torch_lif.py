"""The port's LIF (plain versions and the lif_parallel kernel wrapper) held
bit-exact against the JAX package: its Pallas kernel in interpret mode and
its jnp oracle.  Tests marked ``cuda`` hold the CUDA kernel against its plain
version on the card and skip without one."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import lif as tlif
from repro_torch.kernels.lif_parallel import ops as tops

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

T, N = 4, 300   # N ragged: not a multiple of the TPU kernel's 128 lanes


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (absent where only the card's tests run)."""
    pytest.importorskip("jax")
    from repro.core.lif import lif, lif_parallel, lif_serial, lif_serial_with_state
    from repro.kernels.lif_parallel import ops as jops

    jlif = SimpleNamespace(lif=lif, lif_parallel=lif_parallel, lif_serial=lif_serial,
                           lif_serial_with_state=lif_serial_with_state)
    return SimpleNamespace(lif=jlif, ops=jops)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _drive(seed, shape=(T, N)):
    """Normal drive with a third of the entries on a 1/8 grid, so membranes
    land exactly on theta (the >= boundary) as well as near it."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 0.6, shape).astype(np.float32)
    grid = rng.random(shape) < 1 / 3
    d[grid] = np.round(d[grid] * 8) / 8
    return d


def _skip(seed, shape=(T, N)):
    return (np.random.default_rng(seed).random(shape) > 0.5).astype(np.float32)


@pytest.mark.parametrize("iand", [False, True])
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4])
def test_lif_wrapper_bit_exact_vs_pallas_kernel(ref, chain_len, reset, iand):
    drive, skip = _drive(chain_len), _skip(10 + chain_len)
    kw = dict(chain_len=chain_len, reset=reset)
    if iand:
        want = ref.ops.lif_iand_op(drive, skip, interpret=True, **kw)
        got = tops.lif_iand_op(torch.from_numpy(drive), torch.from_numpy(skip), **kw)
    else:
        want = ref.ops.lif_parallel_op(drive, interpret=True, **kw)
        got = tops.lif_parallel_op(torch.from_numpy(drive), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}


# The CUDA forward kernels' edges (chunked loads where T != 4, a word of 32
# steps, 4 f32 or 8 bf16 columns a thread): (chain_len, T, columns, reset,
# iand), N of several residues mod 8.
EDGES = [(3, 33, 203, "hard", True), (8, 40, 206, "soft", False), (1, 1, 201, "hard", False)]


@pytest.mark.parametrize("chain_len,shape,reset,iand",
                         [pytest.param(c, (T, 3, 100), r, i, id=f"{c}-{r}-{i}")
                          for i in (False, True) for r in ("hard", "soft") for c in (1, 2, 4)]
                         + [pytest.param(c, (t, n), r, i, id=f"{c}-T{t}-N{n}-{r}-{i}")
                            for c, t, n, r, i in EDGES])
def test_lif_parallel_bit_exact_vs_jax_oracle(ref, chain_len, shape, reset, iand):
    drive = _drive(20 + chain_len, shape)
    skip = _skip(30 + chain_len, shape) if iand else None
    want = ref.lif.lif_parallel(drive, chain_len=chain_len, reset=reset,
                                iand_skip=skip)
    got = tlif.lif_parallel(torch.from_numpy(drive), chain_len=chain_len, reset=reset,
                            iand_skip=None if skip is None else torch.from_numpy(skip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_serial_bit_exact_vs_jax_and_parallel(ref, reset):
    drive = _drive(40)
    want = ref.lif.lif_serial(drive, reset=reset)
    got = tlif.lif_serial(torch.from_numpy(drive), reset=reset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tlif.lif_parallel(torch.from_numpy(drive), reset=reset).numpy())


@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_serial_from_v0_vs_jax(ref, reset):
    """``lif_serial(v0=)``: the membrane before the first step, bit-exact
    against the JAX package's."""
    drive, v0 = _drive(41), _drive(42, (N,))
    want = ref.lif.lif_serial(drive, reset=reset, v0=v0)
    got = tlif.lif_serial(torch.from_numpy(drive), reset=reset, v0=torch.from_numpy(v0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("split", [0, 1, 3, 5, 8])
def test_lif_serial_with_state_split_anywhere(ref, reset, split):
    """``lif_serial_with_state`` bit-exact against the JAX package's, and a
    train split at any step and resumed from the returned membrane equals
    the unsplit run in spikes and final membrane (``torch.equal``)."""
    drive, v0 = torch.from_numpy(_drive(43, (8, N))), torch.from_numpy(_drive(44, (N,)))
    s_full, v_full = tlif.lif_serial_with_state(drive, v0, reset=reset)
    want_s, want_v = ref.lif.lif_serial_with_state(drive.numpy(), v0.numpy(), reset=reset)
    np.testing.assert_array_equal(s_full.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(v_full.numpy(), np.asarray(want_v))
    s1, v1 = tlif.lif_serial_with_state(drive[:split], v0, reset=reset)
    s2, v2 = tlif.lif_serial_with_state(drive[split:], v1, reset=reset)
    assert torch.equal(torch.cat([s1, s2]), s_full) and torch.equal(v2, v_full)
    assert torch.equal(s_full, tlif.lif_serial(drive, reset=reset, v0=v0))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("schedule", ["parallel", "serial"])
def test_lif_dispatch_bit_exact_vs_jax(ref, schedule, use_kernel):
    drive, skip = _drive(50), _skip(51)
    want = ref.lif.lif(drive, schedule=schedule, use_kernel=use_kernel,
                       iand_skip=skip, interpret=True)
    got = tlif.lif(torch.from_numpy(drive), schedule=schedule, use_kernel=use_kernel,
                   iand_skip=torch.from_numpy(skip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrapper_counts_no_launch():
    before = tops.lif_parallel_fwd.launches
    tops.lif_parallel_op(torch.from_numpy(_drive(60)))
    assert tops.lif_parallel_fwd.launches == before


def test_non_cpu_tensor_never_takes_plain_version():
    """Only a CPU tensor may take the plain version; any other device goes
    to the kernel path, which refuses what it cannot launch."""
    drive = torch.empty((T, N), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.lif_parallel_op(drive)


@pytest.mark.parametrize("dtype,n,addresses,occ_cols,want", [
    (torch.float32, 1024, (0, 4096, 8192), 0, (4, False)),        # 16 bytes = 4 f32
    (torch.bfloat16, 1024, (0, 4096, 8192), 0, (8, False)),       # 16 bytes = 8 bf16
    (torch.float32, 1026, (0, 4096), 0, (1, False)),              # N % 4 != 0
    (torch.bfloat16, 1028, (0, 4096), 0, (1, False)),             # N % 8 != 0
    (torch.float32, 1024, (4, 4096), 0, (1, False)),              # drive at an offset
    (torch.float32, 1024, (0, 4100, 8192), 0, (1, False)),        # skip at an offset
    (torch.float32, 5 * 384, (0, 4096), 384, (4, True)),          # the map summed in the warp
    (torch.bfloat16, 5 * 2048, (0, 4096), 2048, (8, True)),       # a half warp a tile
    (torch.float32, 5 * 200, (0, 4096), 200, (4, False)),         # ragged tiles: atomics
    (torch.float32, 5 * 48, (0, 4096), 48, (4, False)),           # rows shorter than a tile
    (torch.bfloat16, 5 * 196, (0, 4096), 196, (1, False)),        # D % 8 != 0
    (torch.float32, 5 * 384, (2, 4096), 384, (1, False)),         # offset: scalar, atomics
])
def test_forward_body(dtype, n, addresses, occ_cols, want):
    """The body a K1/K4 launch takes: 16 bytes of the drive a thread where N,
    D and every address allow it, else the scalar body; the map summed in the
    warp only where a warp spans whole 128-feature tiles of D."""
    assert tops.forward_body(dtype, n, addresses, occ_cols) == want


def test_wrapper_rejects_bad_chain_len():
    with pytest.raises(ValueError, match="chain_len"):
        tops.lif_parallel_op(torch.zeros((4, 8)), chain_len=3)


@pytest.mark.cuda
@pytest.mark.parametrize("iand", [False, True])
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("chain_len", [1, 2, 4])
def test_lif_kernel_bit_exact_vs_plain_on_card(card, chain_len, reset, iand):
    drive = torch.from_numpy(_drive(70 + chain_len, (T, 2, 517))).to(card)
    skip = torch.from_numpy(_skip(80, (T, 2, 517))).to(card) if iand else None
    kw = dict(chain_len=chain_len, reset=reset)
    before = tops.lif_parallel_fwd.launches
    if iand:
        got = tops.lif_iand_op(drive, skip, **kw)
        want = tlif.lif_parallel(drive, iand_skip=skip, **kw)
    else:
        got = tops.lif_parallel_op(drive, **kw)
        want = tlif.lif_parallel(drive, **kw)
    torch.cuda.synchronize()
    assert tops.lif_parallel_fwd.launches == before + 1
    assert torch.equal(got, want)
