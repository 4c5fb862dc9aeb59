"""Train the Spike-(IAND-)Former: plain SGD on the synthetic oriented
gratings, the counterpart of the JAX package's ``examples/train_spikformer.py``.

Every step runs the model's training graph (``sf.apply(train=True)``: BN on
batch statistics, surrogate gradients), cross-entropy on ``log_softmax``,
and the update ``p - lr * g``.  :func:`train_spikformer` runs the kernel
route (``cfg.use_kernel``): each LIF runs the forward LIF kernel and, in
the backward pass, the LIF backward kernel, and each SSA the attention
kernel; :func:`train_step` takes the route of the config it is given.  It
runs on the card unless the caller asks for the CPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch spike-iand-former-8-384 --steps 3 --batch 16
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch spike-iand-former_smoke --steps 20 --batch 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.bridge import leaves, rebuild
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.spike_iand_former import get_vision_config
from repro_torch.core import spikformer as sf
from repro_torch.core.iand import is_binary
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.engine.plan import resolve_device


def loss_and_grad(params, state, image, label, cfg):
    """Forward in train mode and backward.  Returns (loss, accuracy,
    gradient tree shaped like ``params``, new BN state, spikes per block);
    loss and accuracy are 0-d tensors."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        logits, new_state, spikes = sf.apply(rebuild(params, iter(flat)), state, image, cfg,
                                             train=True, return_spikes=True)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp[torch.arange(label.shape[0], device=label.device), label].mean()
        grads = torch.autograd.grad(loss, flat)
    acc = (logits.argmax(dim=-1) == label).float().mean()
    return (loss.detach(), acc, rebuild(params, iter(grads)), new_state,
            [s.detach() for s in spikes])


def train_step(params, state, image, label, cfg, *, lr: float):
    """One SGD step.  Returns (new params, new BN state, loss, accuracy)."""
    loss, acc, grads, new_state, _ = loss_and_grad(params, state, image, label, cfg)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves(params), leaves(grads))]
    return rebuild(params, iter(new)), new_state, loss, acc


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_spikformer(arch_or_cfg, *, steps: int, batch: int, lr: float = 0.05,
                     seed: int = 0, device=None, ckpt_dir=None,
                     eval_batches: int = 20, log_every: int = 25,
                     verbose: bool = True, init=None) -> dict:
    """Train a vision config (a registry name or a ``SpikformerConfig``) for
    ``steps`` SGD steps of ``batch`` images on the kernel route (the
    config's ``use_kernel`` set), then measure held-out accuracy
    on ``eval_batches`` batches (steps 100000 on of the data stream) in eval
    mode.  Weights come from ``sf.init(torch.Generator().manual_seed(seed))``,
    or from ``init``, a ``(params, state)`` pair of trees (e.g. the JAX
    package's initial weights through ``bridge.to_torch``), data from
    ``DataConfig(kind="images", seed=seed)``.  ``ckpt_dir``: save
    ``{"params", "state"}`` there after the last step (the JAX package's
    layout, which ``engine.compile_plan(checkpoint=)`` reads).

    Returns a dict: ``losses`` and ``accs`` per step, ``step_ms`` (host
    clock, each step ending in a device sync), ``img_per_s`` over the steps
    after the first, ``heldout_acc``, ``all_spike`` and ``sparsity`` of the
    last held-out batch, ``params``, ``state``, ``cfg``, ``device`` and
    ``ckpt`` (the saved step directory or None)."""
    cfg = get_vision_config(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg
    cfg = dataclasses.replace(cfg, use_kernel=True)
    dev = resolve_device(device)
    if init is None:
        params, state = sf.init(torch.Generator().manual_seed(seed), cfg, device=dev)
    else:
        params, state = (rebuild(tree, iter([x.to(dev) for x in leaves(tree)]))
                         for tree in init)
    dcfg = DataConfig(kind="images", seed=seed, global_batch=batch, img_size=cfg.img_size,
                      num_classes=cfg.num_classes)

    def data(step):
        b = make_batch(dcfg, step)
        return (torch.from_numpy(b["image"]).to(dev),
                torch.from_numpy(b["label"]).long().to(dev))

    losses, accs, step_ms = [], [], []
    for i in range(steps):
        image, label = data(i)
        _sync(dev)
        t0 = time.perf_counter()
        params, state, loss, acc = train_step(params, state, image, label, cfg, lr=lr)
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        accs.append(float(acc))
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"[train] step {i:4d}  loss {losses[-1]:.4f}  acc {accs[-1]:.3f}  "
                  f"{step_ms[-1]:.1f} ms")

    heldout, spikes = [], None
    with torch.no_grad():
        for i in range(eval_batches):
            image, label = data(100_000 + i)
            logits, _, spikes = sf.apply(params, state, image, cfg, train=False,
                                         return_spikes=True)
            heldout.append(float((logits.argmax(dim=-1) == label).float().mean()))
    saved = None
    if ckpt_dir is not None:
        saved = ckpt.save(ckpt_dir, steps, {"params": params, "state": state},
                          extra_meta={"lr": lr, "batch": batch, "seed": seed})
    timed = step_ms[1:] or step_ms
    out = {"losses": losses, "accs": accs, "step_ms": step_ms,
           "img_per_s": 1e3 * batch * len(timed) / sum(timed) if timed else 0.0,
           "heldout_acc": sum(heldout) / len(heldout) if heldout else None,
           "all_spike": all(is_binary(s) for s in spikes) if spikes else None,
           "sparsity": sf.spike_sparsity(spikes) if spikes else None,
           "params": params, "state": state, "cfg": cfg, "device": dev, "ckpt": saved}
    if verbose:
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"[train] {steps} steps of {batch} images on {where}: "
              f"{out['img_per_s']:.1f} img/s after the first step")
        if heldout:
            print(f"[train] held-out accuracy: {out['heldout_acc']:.3f} over "
                  f"{eval_batches} batches; all-spike property: {out['all_spike']}; "
                  f"spike sparsity: {out['sparsity']:.1%}")
        if saved is not None:
            print(f"[train] checkpoint: {saved}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="spike-iand-former-8-384")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain "
                         "versions on the host)")
    ap.add_argument("--ckpt-dir", default=None, help="save a checkpoint there at the end")
    ap.add_argument("--eval-batches", type=int, default=20)
    args = ap.parse_args()
    train_spikformer(args.arch, steps=args.steps, batch=args.batch, lr=args.lr,
                     seed=args.seed, device=args.device, ckpt_dir=args.ckpt_dir,
                     eval_batches=args.eval_batches)


if __name__ == "__main__":
    main()
