"""Training launchers: the generic production trainer of the LM families
(:func:`train`, the port of the JAX package's ``launch/train.py``) and the
Spike-(IAND-)Former's SGD trainer (:func:`train_spikformer`, the counterpart
of the JAX package's ``examples/train_spikformer.py``).

:func:`train` wires an arch config to the deterministic data pipeline
(:func:`data_config_for`, the ``Prefetcher``), ``lm.make_train_step`` with
AdamW, checkpoints in the JAX package's layout, the step watchdog, heartbeat
files and, on request, int8 error-feedback gradient compression.  Its fault
tolerance is the reference's: it resumes from ``LATEST`` when one exists
(params, optimizer state, step; the data stream is a pure function of the
step, so a resume is exact), logs straggler steps and forces a checkpoint
after ``max_straggler_events`` of them, beats a heartbeat file per step, and
``stop_after`` stops early with a checkpoint while the schedule stays pinned
to ``steps``.  The steps run eagerly (the JAX package jits them), each one's
loss read back to the host, which synchronises with the device.

:func:`train_spikformer` runs plain SGD on the synthetic oriented gratings:
every step runs the model's training graph (``sf.apply(train=True)``: BN on
batch statistics, surrogate gradients), cross-entropy on ``log_softmax``,
and the update ``p - lr * g``, on the kernel route (``cfg.use_kernel``):
each LIF runs the forward LIF kernel and, in the backward pass, the LIF
backward kernel, and each SSA the attention kernel; :func:`train_step`
takes the route of the config it is given.

Both run on the card unless the caller asks for the CPU.  The command line
dispatches on ``--arch``: an LM arch goes to :func:`train` (the reference's
defaults: 100 steps, batch 8, 128 tokens, lr 3e-4, a checkpoint every 50
steps), a vision config to :func:`train_spikformer` (3 steps, batch 16, lr
0.05; the default arch).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch spike-iand-former-8-384 --steps 3 --batch 16
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch spike-iand-former_smoke --steps 20 --batch 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b_smoke \\
        --device cpu --steps 20 --batch 4 --seq-len 64 [--ckpt-dir DIR] [--compress-grads]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.bridge import leaves, rebuild, resolve_device, to_torch
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.spike_iand_former import get_vision_config, list_vision_configs
from repro_torch.core import spikformer as sf
from repro_torch.core.iand import is_binary
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_batch
from repro_torch.distributed.compression import init_residuals, tree_error_feedback
from repro_torch.distributed.fault_tolerance import HeartbeatFile, StepWatchdog, WatchdogConfig
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer


def data_config_for(cfg, batch: int, seq_len: int, seed: int) -> DataConfig:
    kind = {"text": "tokens", "audio_stub": "audio_stub",
            "vision_stub": "vision_stub"}[cfg.modality]
    return DataConfig(
        seed=seed, vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=batch, kind=kind, d_model=cfg.d_model,
        num_prefix_tokens=cfg.num_prefix_tokens)


def train(arch: str, *, steps: int, batch: int, seq_len: int,
          ckpt_dir: str | None = None, ckpt_every: int = 50, lr: float = 3e-4,
          seed: int = 0, compress_grads: bool = False, log_every: int = 10,
          host_id: int = 0, heartbeat_dir: str | None = None,
          max_straggler_events: int = 5, stop_after: int | None = None,
          device=None, init=None, watchdog: StepWatchdog | None = None):
    """Train ``arch`` for ``steps`` AdamW steps of ``batch`` x ``seq_len``
    tokens (or frames, or image prefix plus tokens) and return ``(state,
    losses)``: the final ``{"params", "opt_state", "step"}`` (plus
    ``"ef_residual"`` under ``compress_grads``) and the loss of every step
    this call ran.  ``stop_after``: exit (with a checkpoint) after this step
    -- simulates a preemption while keeping the schedule pinned to
    ``steps``.

    As in the JAX package, the optimizer is AdamW from
    ``OptimizerConfig(lr, total_steps=steps, warmup_steps=max(1, steps //
    20), state_dtype=cfg.opt_state_dtype)`` whatever ``cfg.opt_kind`` says,
    and its learning rate at step 0 is 0.  ``device``: the card unless
    ``"cpu"`` is asked for.  ``init``: a params tree to start from (e.g. the
    JAX package's ``init_lm`` weights through ``bridge.to_torch(...,
    dtype=None)``), else ``T.init_lm(seed, cfg)``.  ``watchdog``: the
    ``StepWatchdog`` that clocks the steps (host clock, each step ending in
    its loss read) and flags stragglers, else one of ``WatchdogConfig()``;
    its ``times`` hold the step times after the call."""
    cfg = lm.get_config(arch)
    dev = resolve_device(device)
    opt = make_optimizer(OptimizerConfig(
        lr=lr, total_steps=steps, warmup_steps=max(1, steps // 20),
        state_dtype=cfg.opt_state_dtype))

    params = T.init_lm(seed, cfg, device=dev) if init is None else to_torch(init, dev, None)
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if compress_grads:
        state["ef_residual"] = init_residuals(params)
    del params

    base_step = lm.make_train_step(cfg, opt)

    def train_step(state, batch_):
        if not compress_grads:
            return base_step(state, batch_)
        # error-feedback int8 compression on the (simulated cross-pod) grads
        (_, metrics), grads = lm.value_and_grad(state["params"], batch_, cfg)
        with torch.no_grad():
            g_hat, new_res = tree_error_feedback(grads, state["ef_residual"])
            del grads
            new_params, new_opt = opt.update(
                g_hat, state["opt_state"], state["params"], step=state["step"])
        metrics["grad_norm"] = opt.last_grad_norm(new_opt)
        return ({"params": new_params, "opt_state": new_opt,
                 "step": state["step"] + 1, "ef_residual": new_res}, metrics)

    start_step = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, manifest = ckpt.restore(ckpt_dir, state)
        start_step = manifest["step"]
        print(f"[train] resumed from step {start_step}")

    dcfg = data_config_for(cfg, batch, seq_len, seed)
    pf = Prefetcher(dcfg, start_step=start_step)
    wd = watchdog if watchdog is not None else StepWatchdog(WatchdogConfig())
    hb = HeartbeatFile(heartbeat_dir, host_id) if heartbeat_dir else None
    saver = ckpt.AsyncSaver()

    losses = []
    end_step = min(steps, stop_after) if stop_after is not None else steps
    try:
        for _ in range(start_step, end_step):
            step_i, np_batch = pf.next()
            batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
            wd.start_step()
            state, metrics = train_step(state, batch_dev)
            loss = float(metrics["loss"])
            losses.append(loss)
            ev = wd.end_step(step_i)
            if ev is not None:
                print(f"[train] STRAGGLER step {step_i}: "
                      f"{ev['step_time_s']:.2f}s ({ev['factor']:.1f}x median)")
                if len(wd.straggler_events) >= max_straggler_events and ckpt_dir:
                    print("[train] repeated stragglers -> forcing checkpoint")
                    saver.save_async(ckpt_dir, step_i + 1, state)
            if hb:
                hb.beat(step_i)
            if step_i % log_every == 0:
                print(f"[train] step {step_i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if ckpt_dir and (step_i + 1) % ckpt_every == 0:
                saver.save_async(ckpt_dir, step_i + 1, state)
        if ckpt_dir:
            saver.wait()
            ckpt.save(ckpt_dir, end_step, state)
    finally:
        pf.stop()
    return state, losses


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


LM_DEFAULTS = {"steps": 100, "batch": 8, "seq_len": 128, "lr": 3e-4, "ckpt_every": 50}
VISION_DEFAULTS = {"steps": 3, "batch": 16, "lr": 0.05, "eval_batches": 20}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="spike-iand-former-8-384",
                    help="an LM arch (the generic trainer) or a vision config")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None, help="LM archs only")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain "
                         "versions on the host)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="LM: resume from and checkpoint into it; vision: save there at the end")
    ap.add_argument("--ckpt-every", type=int, default=None, help="LM archs only")
    ap.add_argument("--compress-grads", action="store_true", help="LM archs only")
    ap.add_argument("--heartbeat-dir", default=None, help="LM archs only")
    ap.add_argument("--eval-batches", type=int, default=None, help="vision configs only")
    args = ap.parse_args(argv)

    is_lm = args.arch in lm.list_archs()
    if not is_lm and args.arch not in list_vision_configs():
        ap.error(f"unknown arch {args.arch!r}: not an LM arch ({', '.join(lm.list_archs())}) "
                 f"nor a vision config ({', '.join(list_vision_configs())})")
    family = "LM archs" if is_lm else "vision configs"
    foreign = (("eval_batches",) if is_lm
               else ("seq_len", "ckpt_every", "compress_grads", "heartbeat_dir"))
    for name in foreign:
        if getattr(args, name) not in (None, False):
            ap.error(f"--{name.replace('_', '-')} does not apply to {family}")
    defaults = LM_DEFAULTS if is_lm else VISION_DEFAULTS
    kw = {k: getattr(args, k) if getattr(args, k) is not None else v for k, v in defaults.items()}

    if is_lm:
        _, losses = train(args.arch, ckpt_dir=args.ckpt_dir, seed=args.seed,
                          compress_grads=args.compress_grads, heartbeat_dir=args.heartbeat_dir,
                          device=args.device, **kw)
        print(f"[train] done: first-10 mean {np.mean(losses[:10]):.4f} -> "
              f"last-10 mean {np.mean(losses[-10:]):.4f}")
    else:
        train_spikformer(args.arch, seed=args.seed, device=args.device, ckpt_dir=args.ckpt_dir,
                         **kw)


if __name__ == "__main__":
    main()
