"""Spiking-LM training of the port held against the JAX package at the trained
fixture's config (``llama3.2-1b_smoke`` spiking: d 64, L 2, 4 heads of Dh 16,
vocab 256, T 8), from the JAX package's initial weights
(``init_spiking_lm(PRNGKey(FIXTURE_SEED + 1))``) on shared numpy tokens
(4 x 64).

Tolerances, each with its reason:
* ``_shift_labels``: exact; ``cross_entropy``: ``rtol=1e-6`` (a ``logsumexp``
  and a masked mean, summed in another order than XLA's).
* ``loss_fn``: the loss within 1e-5 relative of ``jax.value_and_grad``'s,
  and each gradient leaf within 1e-4 of that leaf's largest magnitude (the
  f32 GEMM sums and their backward run in another order than XLA's; the
  spikes, and so every surrogate mask, are equal).
* the spikes of the encoding layer and of every block, each port block fed
  the JAX block's input: equal.
* the port's kernel route on the CPU (the kernel wrappers' autograd
  Functions with their plain versions inside): the loss ``torch.equal`` the
  plain route's, each gradient leaf within 1e-4 of its largest magnitude
  (the LIF backward and the SSA backward are summed in another order).

The test marked ``cuda`` holds the kernel route's step against the plain
route's on the card, with its launches counted; it skips without one."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import fixtures as tfix
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.core.lif import lif_parallel as tlif
from repro_torch.models import lm as tlm
from repro_torch.models import spiking_lm as tslm
from repro_torch.models.layers import rmsnorm_apply as trms

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

LOSS_REL, GRAD_REL, CE_RTOL = 1e-5, 1e-4, 1e-6
ORDERINGS = ["quadratic", "linear"]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: the fixture config's initial weights (numpy),
    shared tokens, and ``jax.value_and_grad(loss_fn)`` in both orderings."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import fixtures as jfix
    from repro.core.lif import lif_parallel
    from repro.models import lm as jlm
    from repro.models import spiking_lm as jslm
    from repro.models.layers import rmsnorm_apply

    cfg = jfix.fixture_config()
    params = jslm.init_spiking_lm(jax.random.PRNGKey(jfix.FIXTURE_SEED + 1), cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    out = {}
    for ordering in ORDERINGS:
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, o=ordering: jslm.loss_fn(p, b, cfg, ordering=o), has_aux=True))
        (loss, _), grads = fn(params, {"tokens": jnp.asarray(tokens)})
        out[ordering] = (float(loss), dict(flatten_with_names(
            jax.tree_util.tree_map(np.asarray, grads))))

    def layer_io(ordering):
        """The encoding spikes, then each block's (input, output) spikes."""
        emb = jnp.take(params["embed"]["table"], jnp.asarray(tokens), axis=0)
        drive = rmsnorm_apply(params["embed"]["norm"],
                              jnp.broadcast_to(emb[None], (cfg.spike_t,) + emb.shape),
                              eps=cfg.norm_eps)
        x = lif_parallel(drive, chain_len=cfg.spike_chain_len)
        enc, blocks = np.asarray(x), []
        for i in range(cfg.num_layers):
            p_l = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
            y = jslm.block_apply(p_l, x, cfg, ordering=ordering)
            blocks.append((np.asarray(x), np.asarray(y)))
            x = y
        return enc, blocks

    return SimpleNamespace(jax=jax, jnp=jnp, lm=jlm, cfg=cfg,
                           params=jax.tree_util.tree_map(np.asarray, params), tokens=tokens,
                           value_and_grad=out, layer_io=layer_io)


def _tcfg():
    return tfix.fixture_config()


def _grad_rel(got, want):
    """Largest |got - want| / max |want| over the leaves, by name."""
    got = dict(flatten_with_names(bridge.to_numpy(got)))
    assert sorted(got) == sorted(want)
    worst = {}
    for name, w in want.items():
        scale = float(np.abs(w).max())
        worst[name] = float(np.abs(got[name] - w).max()) / scale if scale else float(
            np.abs(got[name]).max())
    return worst


def test_shift_labels_vs_jax(ref):
    tokens = np.random.default_rng(0).integers(0, 256, (3, 9)).astype(np.int32)
    want = ref.lm._shift_labels(ref.jnp.asarray(tokens))
    got = tlm._shift_labels(torch.from_numpy(tokens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.float32


@pytest.mark.parametrize("masked", ["some", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_vs_jax(ref, dtype, masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.7).astype(np.float32) if masked == "some" \
        else np.zeros((3, 9), np.float32)       # max(mask.sum(), 1) keeps it finite
    jl = ref.jnp.asarray(logits).astype(getattr(ref.jnp, dtype))
    want = ref.lm.cross_entropy(jl, ref.jnp.asarray(labels), ref.jnp.asarray(mask))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = tlm.cross_entropy(tl, torch.from_numpy(labels), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=CE_RTOL)


def test_block_init_vs_jax(ref):
    """``_lin_init`` and ``block_init`` give the JAX package's tree, shapes
    and dtypes; ``init_spiking_lm`` stacks the blocks along L."""
    jax = ref.jax
    from repro.models import spiking_lm as jslm

    want = jslm.block_init(jax.random.PRNGKey(0), ref.cfg, ref.jnp.float32)
    got = tslm.block_init(torch.Generator().manual_seed(0), _tcfg(), torch.float32)
    shapes = lambda tree: {n: (tuple(x.shape), str(x.dtype).split(".")[-1])
                           for n, x in flatten_with_names(tree)}
    assert shapes(got) == shapes(want)
    stacked = tslm.init_spiking_lm(torch.Generator().manual_seed(0), _tcfg())["layers"]
    assert shapes(stacked) == {n: ((2,) + s, d) for n, (s, d) in shapes(got).items()}
    lin = tslm._lin_init(torch.Generator().manual_seed(0), 8, 3, torch.bfloat16)
    assert lin["w"].dtype == torch.bfloat16 and torch.equal(lin["norm"]["scale"],
                                                            torch.ones(3, dtype=torch.bfloat16))


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_loss_and_grad_vs_jax(ref, ordering):
    want_loss, want_grads = ref.value_and_grad[ordering]
    params = bridge.to_torch(ref.params)
    loss, grads = tfix.loss_and_grad(params, {"tokens": torch.from_numpy(ref.tokens)},
                                     _tcfg(), ordering=ordering)
    assert abs(loss.item() - want_loss) <= LOSS_REL * abs(want_loss), (loss.item(), want_loss)
    worst = _grad_rel(grads, want_grads)
    assert max(worst.values()) <= GRAD_REL, {k: v for k, v in worst.items() if v > GRAD_REL}
    _, metrics = tslm.loss_fn(params, {"tokens": torch.from_numpy(ref.tokens)}, _tcfg(),
                              ordering=ordering)
    assert torch.equal(metrics["loss"], loss)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_spikes_layer_by_layer_vs_jax(ref, ordering):
    """The encoding LIF's spikes, then each block's output spikes with the
    port block fed the JAX block's input."""
    cfg = _tcfg()
    enc, blocks = ref.layer_io(ordering)
    params = bridge.to_torch(ref.params)
    emb = params["embed"]["table"][torch.from_numpy(ref.tokens).long()]
    drive = trms(params["embed"]["norm"], emb[None].expand((cfg.spike_t,) + tuple(emb.shape)),
                 eps=cfg.norm_eps)
    np.testing.assert_array_equal(tlif(drive, chain_len=cfg.spike_chain_len).numpy(), enc)
    fired = []
    for i, (x_in, x_out) in enumerate(blocks):
        got = tslm.block_apply(tslm.layer_params(params["layers"], i), torch.tensor(x_in),
                               cfg, ordering=ordering)
        np.testing.assert_array_equal(got.numpy(), x_out, err_msg=f"block {i}")
        fired.append(float(x_out.mean()))
    assert min(fired) > 0, fired          # a silent block would hold nothing


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_kernel_route_vs_plain_route_on_cpu(ref, ordering):
    """The kernel route's autograd Functions (``_LifOp``, and ``_SsaOp`` on
    the quadratic ordering) with their plain versions inside."""
    params = bridge.to_torch(ref.params)
    batch = {"tokens": torch.from_numpy(ref.tokens)}
    plain = tfix.loss_and_grad(params, batch, _tcfg(), ordering=ordering)
    kern = tfix.loss_and_grad(params, batch, _tcfg(), ordering=ordering, use_kernel=True)
    assert torch.equal(kern[0], plain[0])
    want = dict(flatten_with_names(bridge.to_numpy(plain[1])))
    worst = _grad_rel(kern[1], want)
    assert max(worst.values()) <= GRAD_REL, worst


def test_kernel_route_graph_holds_the_kernel_functions():
    """The kernel route's graph: 1 + 7 L ``_LifOp`` nodes and L ``_SsaOp``
    nodes (quadratic), no ``_SsaOp`` on the linear ordering."""
    cfg = _tcfg()
    params = tslm.init_spiking_lm(torch.Generator().manual_seed(0), cfg)
    flat = {n: p.requires_grad_(True) for n, p in flatten_with_names(params)}
    assert flat
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(1))
    for ordering, ssa_nodes in (("quadratic", cfg.num_layers), ("linear", 0)):
        loss, _ = tslm.loss_fn(params, {"tokens": tokens}, cfg, ordering=ordering,
                               use_kernel=True)
        counts, seen, todo = {}, set(), [loss.grad_fn]
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            counts[type(fn).__name__] = counts.get(type(fn).__name__, 0) + 1
            todo.extend(f for f, _ in fn.next_functions)
        assert counts.get("_LifOpBackward", 0) == 1 + 7 * cfg.num_layers
        assert counts.get("_SsaOpBackward", 0) == ssa_nodes


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_loss_fn_kernel_route_vs_plain_route_on_card(card):
    from repro_torch.kernels.lif_parallel.ops import lif_parallel_bwd, lif_parallel_fwd
    from repro_torch.kernels.spiking_attention.ops import ssa_fwd

    cfg = _tcfg()
    params = tslm.init_spiking_lm(torch.Generator(card).manual_seed(0), cfg)
    batch = {"tokens": tfix.synthetic_batches(cfg, steps=1)[0]["tokens"].to(card)}
    counters = (lif_parallel_fwd, lif_parallel_bwd, ssa_fwd)
    before = [f.launches for f in counters]
    kern = tfix.loss_and_grad(params, batch, cfg, use_kernel=True)
    torch.cuda.synchronize()
    lifs = 1 + 7 * cfg.num_layers
    assert [f.launches - b for f, b in zip(counters, before)] == [lifs, lifs, cfg.num_layers]
    plain = tfix.loss_and_grad(params, batch, cfg)
    assert torch.equal(kern[0], plain[0])
    want = dict(flatten_with_names(bridge.to_numpy(plain[1])))
    assert max(_grad_rel(kern[1], want).values()) <= GRAD_REL
