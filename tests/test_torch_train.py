"""Training of the port held against the JAX package, on the tiny config
(d=64, L=2, H=4, T=4, 32x32 images, B=2) and its pieces.

Tolerances, each with its reason:
* ``bn_apply(train=True)``: output and running statistics ``atol=1e-6``
  (batch mean and variance summed in another order than XLA's), the output
  also ``rtol=1e-6`` (its entries reach |y| ~ 8, where an f32 ulp is 9.5e-7).
* ``apply(train=True)``: logits ``atol=1e-4`` and the new BN state
  ``atol=1e-5`` (conv and GEMM sums reordered feed the statistics); spikes
  equal block by block.
* loss ``atol=1e-5`` and every gradient leaf ``atol=1e-4`` against
  ``jax.value_and_grad`` of the JAX ``sf.apply(train=True)`` (the engine
  tests' logits tolerance; the backward sums are reordered too).  JAX runs
  its jnp route (``use_kernel=False``): its kernel route equals it by its
  own tests, and interpret-mode Pallas under autodiff is slow.  The port
  runs both routes; on the CPU its kernel route goes through the same
  autograd Functions as on the card, with their plain versions inside.
* the maxpool's gradient on tied windows, ``make_batch`` and checkpoints:
  exact.

Tests marked ``cuda`` hold the kernel route's training step against the
plain route's on the card, and the conv backward's repair of cuDNN's TF32
default; they skip without one."""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge, engine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import nn as tnn
from repro_torch.core import spikformer as tsf
from repro_torch.core.iand import is_binary
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as ttrain

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

LR = 0.05
LOGITS_ATOL, GRAD_ATOL, LOSS_ATOL, STATE_ATOL, BN_ATOL = 1e-4, 1e-4, 1e-5, 1e-5, 1e-6


def _tiny(pkg, **kw):
    return pkg.SpikformerConfig(embed_dim=64, num_layers=2, num_heads=4, t=4, **kw)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: the tiny model's numpy weights, a batch, and one
    jitted ``value_and_grad`` of the example's loss (train-mode forward,
    spikes returned) on that batch (absent where only the card's tests
    run)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import checkpoint as jckpt
    from repro.core import nn as jnn
    from repro.core import spikformer as jsf
    from repro.data import pipeline as jdata

    cfg = _tiny(jsf)
    params, state = jsf.init(jax.random.PRNGKey(0), cfg)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

    def loss_fn(p, s, img, lab):
        logits, s2, spikes = jsf.apply(p, s, img, cfg, train=True, return_spikes=True)
        ce = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(lab.shape[0]), lab])
        return ce, (s2, logits, spikes)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    sgd = jax.jit(lambda p, g: jax.tree_util.tree_map(lambda w, gw: w - LR * gw, p, g))
    images = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 3], np.int32)
    (loss, (new_state, logits, spikes)), grads = grad_fn(params, state, images, labels)
    return SimpleNamespace(jax=jax, jnp=jnp, nn=jnn, sf=jsf, data=jdata, ckpt=jckpt,
                           grad_fn=grad_fn, sgd=sgd, to_np=to_np, params=to_np(params),
                           state=to_np(state), images=images, labels=labels,
                           loss=float(loss), new_state=to_np(new_state),
                           logits=np.asarray(logits), spikes=[np.asarray(s) for s in spikes],
                           grads=to_np(grads))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _leaves_by_name(tree):
    return dict(tckpt.flatten_with_names(tree))


def _assert_trees_close(got, want, atol):
    got, want = _leaves_by_name(bridge.to_numpy(got)), _leaves_by_name(want)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0, err_msg=name)


# -- pieces ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 8, 8, 12), (4, 2, 49, 64)])
def test_bn_apply_train_vs_jax(ref, shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.3, 1.7, shape).astype(np.float32)
    c = shape[-1]
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    s = {"mean": rng.normal(size=c).astype(np.float32),
         "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    y, s2 = ref.nn.bn_apply(p, s, x, train=True)
    ty, ts2 = tnn.bn_apply(bridge.to_torch(p), bridge.to_torch(s), torch.from_numpy(x),
                           train=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=BN_ATOL, rtol=BN_ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ts2[k].numpy(), np.asarray(s2[k]), atol=BN_ATOL, rtol=0)
    ey, es = tnn.bn_apply(bridge.to_torch(p), bridge.to_torch(s), torch.from_numpy(x))
    want, _ = ref.nn.bn_apply(p, s, x, train=False)
    np.testing.assert_allclose(ey.numpy(), np.asarray(want), atol=BN_ATOL, rtol=BN_ATOL)
    assert es["mean"] is not None and np.array_equal(es["var"].numpy(), s["var"])


def test_maxpool_tie_routing_vs_jax(ref):
    """All-zero neighbourhoods give identical conv outputs, so a pooled
    window often holds equal maxima; the gradient must reach the element
    the reference's VJP picks (the first, row-major)."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2, (2, 8, 8, 3)).astype(np.float32)
    x[:, :2, :2, :] = 1.0                      # windows tied in all four places
    x[:, 2:4, 2:4, :] = 0.0                    # and all-zero windows
    g = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    _, vjp = ref.jax.vjp(ref.nn.maxpool, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tnn.maxpool(xt), xt, torch.from_numpy(g))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(vjp(g)[0]))


@pytest.mark.parametrize("img_size,classes,batch", [(16, 4, 16), (32, 10, 2), (224, 1000, 3)])
def test_make_batch_images_bit_equal_vs_jax(ref, img_size, classes, batch):
    for step in (0, 1, 7, 100_000):
        for shard, shards in ((0, 1), (1, 2)):
            kw = dict(kind="images", global_batch=batch - batch % shards, img_size=img_size,
                      num_classes=classes, seed=step % 3)
            want = ref.data.make_batch(ref.data.DataConfig(**kw), step, shard=shard,
                                       num_shards=shards)
            got = tdata.make_batch(tdata.DataConfig(**kw), step, shard=shard,
                                   num_shards=shards)
            for key in ("image", "label"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    assert dataclasses.astuple(tdata.DataConfig()) == dataclasses.astuple(ref.data.DataConfig())
    stub = dict(kind="audio_stub", seq_len=8, d_model=4, vocab_size=50)   # served since
    want = ref.data.make_batch(ref.data.DataConfig(**stub), 3)             # modality_batch
    got = tdata.make_batch(tdata.DataConfig(**stub), 3)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def _ckpt_tree():
    """Nested dicts, a tuple and f32 leaves (the bf16 leaf is cast by each
    package)."""
    rng = np.random.default_rng(9)
    tree = {"params": {"block0": {"q": {"lin": {"w": rng.normal(size=(3, 4)),
                                                "b": rng.normal(size=(4,))}}},
                       "head": {"w": rng.normal(size=(4, 2))}},
            "state": {"tok": ({"mean": rng.normal(size=(5,))}, {"var": rng.random(6)})},
            "bf16": rng.normal(size=(2, 3))}
    return bridge.to_numpy(bridge.to_torch(tree))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_cross_package(ref, tmp_path, writer):
    """A checkpoint written by one package restores in the other: the same
    leaf names, dtypes and arrays (bf16 through the bit view)."""
    tree = _ckpt_tree()
    ttree = bridge.to_torch(tree)
    ttree["bf16"] = ttree["bf16"].to(torch.bfloat16)
    jtree = ref.jax.tree_util.tree_map(ref.jnp.asarray, tree)
    jtree["bf16"] = jtree["bf16"].astype(ref.jnp.bfloat16)
    if writer == "port":
        tckpt.save(tmp_path, 5, ttree, extra_meta={"by": "port"})
        got, manifest = ref.ckpt.restore(tmp_path, ref.jax.eval_shape(lambda: jtree))
        assert got["bf16"].dtype == ref.jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(got["bf16"].astype(ref.jnp.float32)),
                                      ttree["bf16"].float().numpy())
        got = ref.to_np(got)
    else:
        ref.ckpt.save(tmp_path, 5, jtree, extra_meta={"by": "jax"})
        got, manifest = tckpt.restore(tmp_path, ttree)
        assert got["bf16"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                      np.asarray(jtree["bf16"].astype(ref.jnp.float32)))
        got = bridge.to_numpy({k: v for k, v in got.items() if k != "bf16"})
    assert manifest["step"] == 5 and manifest["meta"] == {"by": writer}
    jnames = ["/".join(str(k) for k in path) for path, _ in
              ref.jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [n for n, _ in tckpt.flatten_with_names(ttree)] == jnames
    written = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert [e["name"] for e in written["leaves"]] == jnames
    want = _leaves_by_name(bridge.to_numpy({k: v for k, v in ttree.items() if k != "bf16"}))
    got = _leaves_by_name({k: v for k, v in got.items() if k != "bf16"})
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_checkpoint_latest_and_keep_k(tmp_path):
    tree = {"x": torch.arange(4.0)}
    assert tckpt.latest_step(tmp_path) is None
    for step in range(5):
        tckpt.save(tmp_path, step, {"x": tree["x"] + step}, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000003",
                                                               "step_00000004"]
    assert tckpt.latest_step(tmp_path) == 4
    got, _ = tckpt.restore(tmp_path, tree)
    assert torch.equal(got["x"], tree["x"] + 4)
    got, _ = tckpt.restore(tmp_path, tree, step=3)
    assert torch.equal(got["x"], tree["x"] + 3)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, {"x": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore(tmp_path, {"y": torch.zeros(4)})


# -- the model's training graph ------------------------------------------------

def _port_inputs(ref):
    return (bridge.to_torch(ref.params), bridge.to_torch(ref.state),
            torch.from_numpy(ref.images), torch.from_numpy(ref.labels).long())


def test_apply_train_logits_state_and_spikes_vs_jax(ref):
    params, state, images, _ = _port_inputs(ref)
    with torch.no_grad():
        logits, new_state, spikes = tsf.apply(params, state, images, _tiny(tsf), train=True,
                                              return_spikes=True)
    np.testing.assert_allclose(logits.numpy(), ref.logits, atol=LOGITS_ATOL, rtol=0)
    _assert_trees_close(new_state, ref.new_state, STATE_ATOL)
    assert len(spikes) == len(ref.spikes) == 3
    for i, (got, want) in enumerate(zip(spikes, ref.spikes)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"spikes after stage {i}")
        assert is_binary(got)
    assert 0 < tsf.spike_sparsity(spikes) < 1
    assert tsf.num_params(params) == sum(np.asarray(x).size for x in
                                         ref.jax.tree_util.tree_leaves(ref.params))


def test_apply_train_serial_dataflow_vs_jax(ref):
    """``tick_fold=False`` (conv and linear once per time step) in train
    mode: logits, new BN state and spikes against JAX's."""
    cfg = _tiny(ref.sf, tick_fold=False)
    fwd = ref.jax.jit(lambda p, s, img: ref.sf.apply(p, s, img, cfg, train=True,
                                                      return_spikes=True))
    want_logits, want_state, want_spikes = fwd(ref.params, ref.state, ref.images)
    params, state, images, _ = _port_inputs(ref)
    with torch.no_grad():
        logits, new_state, spikes = tsf.apply(params, state, images,
                                              _tiny(tsf, tick_fold=False), train=True,
                                              return_spikes=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGITS_ATOL,
                               rtol=0)
    _assert_trees_close(new_state, ref.to_np(want_state), STATE_ATOL)
    for got, want in zip(spikes, want_spikes):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_every_gradient_vs_jax(ref, use_kernel):
    params, state, images, labels = _port_inputs(ref)
    loss, acc, grads, new_state, spikes = ttrain.loss_and_grad(
        params, state, images, labels, _tiny(tsf, use_kernel=use_kernel))
    np.testing.assert_allclose(float(loss), ref.loss, atol=LOSS_ATOL, rtol=0)
    _assert_trees_close(grads, ref.grads, GRAD_ATOL)
    _assert_trees_close(new_state, ref.new_state, STATE_ATOL)
    for got, want in zip(spikes, ref.spikes):
        np.testing.assert_array_equal(got.numpy(), want)
    nonzero = [n for n, g in _leaves_by_name(bridge.to_numpy(grads)).items()
               if np.abs(g).max() > 0]
    assert len(nonzero) > len(_leaves_by_name(ref.grads)) // 2


def test_three_sgd_steps_vs_jax_loop(ref):
    """Three steps of ``train_step`` against three of the example's loop
    (``w - lr * g`` on ``make_batch`` batches) from the same weights.

    From the loop's weights and BN state at every step, ``train_step``
    gives the loop's loss (``atol=1e-5``), spikes (equal) and new state
    (``atol=1e-5``).  Its gradients are held leaf by leaf at the first step
    only (``test_loss_and_every_gradient_vs_jax``): the boxcar surrogate is
    discontinuous at |u - theta| = width/2, and at the third step of this
    loop ten membranes (tokenizer stage 0 and three block LIFs) lie within
    1e-5 of that edge, inside the forward's reassociation error, so either
    package's gradient is as right as the other's there and they differ by
    up to 1e-2.  The free-running trajectories part for the same reason;
    their losses are held at ``rtol=1e-3``."""
    dcfg = ref.data.DataConfig(kind="images", global_batch=2, img_size=32, num_classes=10)
    jp, js = ref.params, ref.state
    tp, ts = bridge.to_torch(ref.params), bridge.to_torch(ref.state)
    cfg = _tiny(tsf, use_kernel=True)
    for step in range(3):
        b = ref.data.make_batch(dcfg, step)
        image, label = torch.from_numpy(b["image"]), torch.from_numpy(b["label"]).long()
        loss, _, _, new_state, spikes = ttrain.loss_and_grad(
            bridge.to_torch(ref.to_np(jp)), bridge.to_torch(ref.to_np(js)), image, label, cfg)
        (jl, (js, _, jspikes)), g = ref.grad_fn(jp, js, b["image"], b["label"])
        jp = ref.sgd(jp, g)
        np.testing.assert_allclose(float(loss), float(jl), atol=LOSS_ATOL, rtol=0,
                                   err_msg=f"loss at step {step}")
        _assert_trees_close(new_state, ref.to_np(js), STATE_ATOL)
        for got, want in zip(spikes, jspikes):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tp, ts, tl, acc = ttrain.train_step(tp, ts, image, label, cfg, lr=LR)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3, atol=0,
                                   err_msg=f"free-running loss at step {step}")
        assert 0.0 <= float(acc) <= 1.0
        assert all(not p.requires_grad for p in ttrain.leaves(tp))


def test_train_spikformer_on_cpu_checkpoint_into_plan(tmp_path):
    """The entry point on the CPU: a few steps of a tiny config, a checkpoint
    at the end, and ``compile_plan(checkpoint=)`` on fresh trees giving the
    trained model's eval logits."""
    cfg = tsf.SpikformerConfig(embed_dim=32, num_layers=1, num_heads=2, t=4, img_size=16,
                               num_classes=4)
    out = ttrain.train_spikformer(cfg, steps=3, batch=4, device="cpu", ckpt_dir=tmp_path,
                                  eval_batches=2, verbose=False)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["all_spike"] and out["ckpt"].name == "step_00000003"
    fresh_p, fresh_s = tsf.init(torch.Generator().manual_seed(123), cfg)
    plan = engine.compile_plan(fresh_p, fresh_s, cfg, backend="cuda+packed", device="cpu",
                               checkpoint=str(tmp_path))
    images = torch.rand((3, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    want, _ = tsf.apply(out["params"], out["state"], images, cfg)
    np.testing.assert_allclose(engine.apply(plan, images).numpy(), want.numpy(),
                               atol=LOGITS_ATOL, rtol=0)


def test_train_spikformer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.train_spikformer("spike-iand-former_smoke", steps=1, batch=2)


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_conv_weight_gradient_ignores_global_tf32_on_card(card):
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((8, 28, 28, 96), generator=gen).round().to(card).requires_grad_(True)
    p = {"w": (torch.rand((3, 3, 96, 192), generator=gen) - 0.5).to(card).requires_grad_(True)}
    g = torch.randn((8, 28, 28, 192), generator=gen).to(card)
    saved = torch.backends.cudnn.allow_tf32
    grads = {}
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            grads[tf32] = torch.autograd.grad(tnn.conv_apply(p, x), (x, p["w"]), g)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_step_kernel_route_vs_plain_route_on_card(card):
    from repro_torch.kernels.lif_parallel.ops import lif_parallel_bwd, lif_parallel_fwd
    from repro_torch.kernels.spiking_attention.ops import ssa_fwd

    cfg = _tiny(tsf)
    params, state = tsf.init(torch.Generator().manual_seed(0), cfg, device=card)
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(3)).to(card)
    labels = torch.tensor([1, 3], device=card)
    before = (lif_parallel_fwd.launches, lif_parallel_bwd.launches, ssa_fwd.launches)
    kern = ttrain.loss_and_grad(params, state, images, labels,
                                dataclasses.replace(cfg, use_kernel=True))
    torch.cuda.synchronize()
    after = (lif_parallel_fwd.launches, lif_parallel_bwd.launches, ssa_fwd.launches)
    lifs = 4 + 7 * cfg.num_layers
    assert tuple(a - b for a, b in zip(after, before)) == (lifs, lifs, cfg.num_layers)
    plain = ttrain.loss_and_grad(params, state, images, labels, cfg)
    assert torch.equal(kern[0], plain[0])
    for name, g in _leaves_by_name(kern[2]).items():
        want = _leaves_by_name(plain[2])[name]
        assert torch.allclose(g, want, rtol=1e-4, atol=1e-5), name
        assert bool(((g != 0) | (want == 0)).all()), name
