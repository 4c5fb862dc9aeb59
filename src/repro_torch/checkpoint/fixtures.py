"""A deterministic trained spiking-LM checkpoint for the sparse routes and
their benchmarks, the counterpart of the JAX package's
``checkpoint/fixtures.py``.

The sparse datapath's claims (skip rates, tokens/s) mean little on seeded
weights: those have neither the temporal front-loading nor the dead feature
zones of a trained model.  This module trains ``llama3.2-1b_smoke`` for one
epoch of full-batch SGD on a fixed synthetic corpus, seeded throughout, and
saves it in the shared checkpoint layout (:mod:`repro_torch.checkpoint.
checkpoint`).  It runs on the card unless it is asked for the CPU
(``device="cpu"``); on the card every LIF and the causal SSA take the kernel
route (``loss_fn(use_kernel=True)``), on the CPU the plain route.

The port's fixture is its own: the JAX package draws its corpus and its
initial weights with ``jax.random``, this module with numpy
(``default_rng(FIXTURE_SEED)``, the same bigram rule) and ``torch.Generator``,
and a card-trained fixture differs from a CPU-trained one in the last bits
of its sums, which SGD carries on.  So :func:`trained_lm_fixture` memoises
under a directory of this checkout that names the device
(``build/fixtures/<arch>-seed<seed>-<device>``), never the JAX package's
cache, and the manifest says which corpus and device built it.
:func:`train_fixture_params` also takes the JAX package's initial weights
(``init=``) and corpus (``batches=``), which the parity tests hand it.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.bridge import leaves, rebuild
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.engine.plan import resolve_device

FIXTURE_ARCH = "llama3.2-1b_smoke"
FIXTURE_SEED = 0
FIXTURE_STEPS = 60          # one epoch over the synthetic corpus
FIXTURE_BATCH = 4
FIXTURE_SEQ = 64
FIXTURE_LR = 0.5            # full-batch SGD at smoke scale; loss must drop
FOLLOW_P = 0.75             # the bigram rule's share: next = (3 * prev + 7) mod V
CORPUS = (f"numpy default_rng({FIXTURE_SEED}): uniform tokens, with p={FOLLOW_P} "
          "the next is (3*prev+7) mod V")

_FIXTURE_ROOT = Path(__file__).resolve().parents[3] / "build" / "fixtures"


def fixture_config(*, spike_t: int = 8):
    """The fixture's ``ArchConfig``: the smoke-scale spiking LM.  ``spike_t``
    changes no parameter shape, so one trained checkpoint serves every T."""
    from repro_torch.models.lm import get_config

    return get_config(FIXTURE_ARCH).replace(spiking=True, spike_t=spike_t, num_heads=4,
                                            head_dim=None)


def synthetic_batches(cfg, *, steps: int = FIXTURE_STEPS, batch: int = FIXTURE_BATCH,
                      seq: int = FIXTURE_SEQ):
    """The fixed synthetic corpus: ``steps`` batches ``{"tokens": (B, S)
    int32}`` drawn once from ``default_rng(FIXTURE_SEED)``.  Each token is
    uniform, except that with p = FOLLOW_P the token after base token ``b``
    is ``(3 b + 7) mod V`` (the rule reads the drawn base token, as the JAX
    package's does), so one epoch of SGD has structure to fit."""
    rng = np.random.default_rng(FIXTURE_SEED)
    v = cfg.vocab_size
    out = []
    for _ in range(steps):
        base = rng.integers(0, v, (batch, seq), dtype=np.int64)
        follow = (3 * base[:, :-1] + 7) % v
        use = rng.random(follow.shape) < FOLLOW_P
        toks = base.copy()
        toks[:, 1:] = np.where(use, follow, base[:, 1:])
        out.append({"tokens": torch.from_numpy(toks.astype(np.int32))})
    return out


def loss_and_grad(params, batch, cfg, *, ordering: str = "quadratic",
                  use_kernel: bool = False):
    """``loss_fn`` and its gradient: (0-d loss, gradient tree shaped like
    ``params``, stacked along L as the parameters are)."""
    from repro_torch.models.spiking_lm import loss_fn

    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(rebuild(params, iter(flat)), batch, cfg, ordering=ordering,
                          use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), rebuild(params, iter(grads))


def sgd_step(params, batch, cfg, *, lr: float = FIXTURE_LR, ordering: str = "quadratic",
             use_kernel: bool = False):
    """One full-batch SGD step ``p - lr * g``: (new params, loss)."""
    loss, grads = loss_and_grad(params, batch, cfg, ordering=ordering, use_kernel=use_kernel)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves(params), leaves(grads))]
    return rebuild(params, iter(new)), loss


def train_fixture_params(cfg=None, *, ordering: str = "quadratic", device=None, init=None,
                         batches=None, lr: float = FIXTURE_LR):
    """Train the fixture from scratch: one pass of SGD at ``lr`` over the
    corpus, on the card (kernel route) unless ``device="cpu"`` (plain
    route).  ``init``: a params tree to start from (numpy or tensors, e.g.
    the JAX package's initial weights), else ``init_spiking_lm`` from
    ``FIXTURE_SEED + 1``; ``batches``: the corpus, else
    :func:`synthetic_batches`.  Returns (params, history), ``history`` the
    per-step losses."""
    from repro_torch.models.spiking_lm import _param_dtype, init_spiking_lm

    cfg = cfg or fixture_config()
    dev = resolve_device(device)
    if init is None:
        params = init_spiking_lm(torch.Generator(dev).manual_seed(FIXTURE_SEED + 1), cfg)
    else:
        params = bridge.to_torch(init, dev, _param_dtype(cfg))
    history = []
    for batch in synthetic_batches(cfg) if batches is None else batches:
        batch = {"tokens": torch.as_tensor(batch["tokens"], device=dev)}
        params, loss = sgd_step(params, batch, cfg, lr=lr, ordering=ordering,
                                use_kernel=dev.type == "cuda")
        history.append(float(loss))
    return params, history


def _device_label(device) -> str:
    """``cpu``, or ``cuda-`` and the card's name: the fixture's directory
    and manifest name the device that trained it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return "cuda-" + re.sub(r"[^A-Za-z0-9]+", "_", torch.cuda.get_device_name(dev)).strip("_")


def _default_dir(device) -> str:
    return str(_FIXTURE_ROOT / f"{FIXTURE_ARCH}-seed{FIXTURE_SEED}-{_device_label(device)}")


def trained_lm_fixture(ckpt_dir=None, *, force: bool = False, device=None):
    """The one-epoch trained spiking-LM checkpoint, trained if absent (on the
    card unless ``device="cpu"``).  Returns ``(ckpt_dir, cfg)``; serve it
    with ``compile_plan(init_spiking_lm(...), None, cfg, checkpoint=ckpt_dir)``."""
    cfg = fixture_config()
    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or _default_dir(dev)
    if force or ckpt.latest_step(ckpt_dir) is None:
        params, history = train_fixture_params(cfg, device=dev)
        ckpt.save(ckpt_dir, len(history), params,
                  extra_meta={"arch": FIXTURE_ARCH, "seed": FIXTURE_SEED,
                              "loss_first": history[0], "loss_last": history[-1],
                              "corpus": CORPUS, "device": _device_label(dev),
                              "route": "kernel" if dev.type == "cuda" else "plain"})
    return ckpt_dir, cfg
