"""Learning parity: the port's training entry point
(``launch/train.py::train_spikformer``) learns what the JAX package's
example learns.  The config is ``examples/train_spikformer.py``'s (embed 48,
2 layers, 4 heads, 16x16 images, 4 classes, T 4, IAND residuals, pools
(F, F, T, T)); both runs take 300 SGD steps of batch 16 at lr 0.05 from the
JAX example's own initial weights (``sf.init(PRNGKey(0))``, carried across
by ``bridge.to_torch``) on the same ``make_batch`` stream, then measure
held-out accuracy on its 20 batches from step 100,000 on.

The band, fixed before any run: the port's held-out accuracy within
ACC_BAND (0.10) of the JAX run's, and both above chance (0.25) by at least
half of the JAX run's margin over chance.  A step-by-step match is not
asked: the two packages' f32 sums differ in order, a spike at threshold can
flip, and 300 steps of SGD carry such a flip on."""

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import spikformer as tsf
from repro_torch.launch.train import train_spikformer

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

STEPS, BATCH, LR, EVAL_BATCHES = 300, 16, 0.05, 20
CHANCE, ACC_BAND = 0.25, 0.10
CONFIG = dict(embed_dim=48, num_layers=2, num_heads=4, t=4, img_size=16, num_classes=4,
              residual="iand", tokenizer_pools=(False, False, True, True))


def _jax_example():
    """``examples/train_spikformer.py``'s run: (initial params, initial BN
    state, held-out accuracy), the trees as numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import spikformer as sf
    from repro.data.pipeline import DataConfig, make_batch

    cfg = sf.SpikformerConfig(**CONFIG)
    params, state = sf.init(jax.random.PRNGKey(0), cfg)
    init = jax.tree_util.tree_map(np.asarray, (params, state))
    dcfg = DataConfig(kind="images", global_batch=BATCH, img_size=16, num_classes=4)

    def loss_fn(p, s, img, lab):
        logits, s2 = sf.apply(p, s, img, cfg, train=True)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(lab.shape[0]), lab]), s2

    @jax.jit
    def step(p, s, img, lab):
        (_, s2), g = jax.value_and_grad(loss_fn, has_aux=True)(p, s, img, lab)
        return jax.tree_util.tree_map(lambda w, gw: w - LR * gw, p, g), s2

    for i in range(STEPS):
        b = make_batch(dcfg, i)
        params, state = step(params, state, jnp.asarray(b["image"]), jnp.asarray(b["label"]))
    accs = []
    for i in range(EVAL_BATCHES):
        b = make_batch(dcfg, 100_000 + i)
        logits, _ = sf.apply(params, state, jnp.asarray(b["image"]), cfg, train=False)
        accs.append(float(jnp.mean((jnp.argmax(logits, -1) == jnp.asarray(b["label"])))))
    return init[0], init[1], sum(accs) / len(accs)


def test_train_spikformer_learns_as_the_jax_example():
    params, state, jax_acc = _jax_example()
    cfg = tsf.SpikformerConfig(**CONFIG)
    run = train_spikformer(cfg, steps=STEPS, batch=BATCH, lr=LR, device="cpu",
                           eval_batches=EVAL_BATCHES, verbose=False,
                           init=(bridge.to_torch(params), bridge.to_torch(state)))
    floor = CHANCE + (jax_acc - CHANCE) / 2
    print(f"held-out accuracy after {STEPS} steps: port {run['heldout_acc']:.4f}, JAX "
          f"{jax_acc:.4f} (band {ACC_BAND}, floor {floor:.4f}); port loss "
          f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}")
    assert jax_acc > CHANCE
    assert run["heldout_acc"] >= floor and jax_acc >= floor
    assert abs(run["heldout_acc"] - jax_acc) <= ACC_BAND, (run["heldout_acc"], jax_acc)
    assert run["all_spike"]
    assert run["losses"][-1] < run["losses"][0]
