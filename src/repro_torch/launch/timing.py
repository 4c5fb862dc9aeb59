"""Time one checkout of the port, so that two checkouts can be compared in
turns within one run on the card.

Three measurements:

``serve``  slot batches of a live model (``launch/serve.py::live_model``:
           seeded weights with every BatchNorm leaf perturbed, so that every
           block fires)
           through each kernel route's compiled plan, after ``--warmup``
           batches: each batch on the host clock from its call to its host
           copy, as ``serve_plan`` serves it; prints one line per route with
           the median, the quartiles, the mean and the extremes.
``train``  SGD steps of ``train_spikformer`` (the kernel route) after
           ``--warmup`` steps: each step on the host clock, ending in a
           device sync; the same statistics.
``lm``     decode steps of the live spiking LM (``live_lm_params``) on each
           kernel route: a slot batch of prompts prefilled, then ``--steps``
           greedy decode steps after ``--warmup``, each on the host clock
           from its call to the host copy of its tokens, as
           ``serve_lm_plan`` steps; the same statistics.
``ssa``    the dense SSA entry point ``ssa_fwd`` on random binary operands
           of shape (G, N, Dh): held ``torch.equal`` to its plain version,
           then CUDA events over back-to-back calls (as ``chip_smoke.py``
           times a kernel) and the device time per launch of the kernels
           the call runs under ``torch.profiler``.

Run it as a file, so that ``--src`` decides which checkout's
``repro_torch`` is imported (another checkout's ``src`` directory, or by
default the one holding this file)::

    python src/repro_torch/launch/timing.py serve --batches 20
    python src/repro_torch/launch/timing.py train --steps 20
    python src/repro_torch/launch/timing.py lm --steps 20
    python src/repro_torch/launch/timing.py --src ../other/src ssa --g 384 --n 64 --dh 32

Every line printed starts with ``[timing]`` and names the ``repro_torch``
it ran.  It runs on the card unless ``--device cpu`` asks for the host.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

ROUTES = ("cuda", "cuda+packed", "cuda+packed+sparse")   # the kernel routes


def spread(xs: list[float]) -> dict[str, float]:
    """Median, quartiles (``statistics.quantiles``, exclusive method),
    mean and extremes of ``xs``."""
    q1, med, q3 = statistics.quantiles(xs, n=4) if len(xs) > 1 else (xs[0],) * 3
    return {"median": med, "q1": q1, "q3": q3, "mean": statistics.fmean(xs),
            "min": min(xs), "max": max(xs)}


def time_serve(arch: str, batches: int, warmup: int, slots: int, device,
               routes=ROUTES) -> dict[str, dict[str, float]]:
    """ms per slot batch of ``slots`` images of the live ``arch`` on each of
    ``routes``, over ``batches`` batches after ``warmup``: each batch timed
    from its call to its host copy (which waits for the device), the
    batches drawn in turn from 4 slot batches of images."""
    from repro_torch import engine
    from repro_torch.launch.serve import live_model

    out = {}
    for backend in routes:
        plan, images = live_model(arch, 4 * slots, backend, device)
        step = engine.make_apply_fn(plan)
        times = []
        with torch.inference_mode():
            for i in range(warmup + batches):
                batch = images[(i % 4) * slots:(i % 4 + 1) * slots]
                t0 = time.perf_counter()
                step(plan.params, batch).cpu()
                times.append(1e3 * (time.perf_counter() - t0))
        out[backend] = spread(times[warmup:])
        del plan, images, step
    return out


def time_train(arch: str, steps: int, warmup: int, batch: int, device) -> dict[str, float]:
    """ms per SGD step of ``train_spikformer`` on ``arch``, over the
    ``steps`` after the first ``warmup``."""
    from repro_torch.launch.train import train_spikformer

    out = train_spikformer(arch, steps=warmup + steps, batch=batch, device=device,
                           eval_batches=0, verbose=False)
    return spread(out["step_ms"][warmup:])


def time_lm(arch: str, steps: int, warmup: int, slots: int, prompt: int, device,
            routes=ROUTES) -> dict[str, dict[str, float]]:
    """ms per decode step of ``slots`` sequences of the live spiking ``arch``
    on each of ``routes``, after a prefill of ``prompt``-token prompts and
    ``warmup`` steps; each step from its call to the host copy of its
    greedy tokens."""
    from repro_torch import engine
    from repro_torch.launch.serve import live_lm_params, spiking_lm_config

    cfg = spiking_lm_config(arch)
    params = live_lm_params(cfg, device)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (slots, prompt), generator=gen).to(device)
    out = {}
    for backend in routes:
        plan = engine.compile_plan(params, None, cfg, backend=backend, device=device)
        step = engine.make_decode_step_fn(plan)
        times = []
        with torch.inference_mode():
            logits, state = engine.make_prefill_fn(plan)(plan.params, tokens)
            tok = logits[:, -1].argmax(-1)
            for _ in range(warmup + steps):
                t0 = time.perf_counter()
                logits, state = step(plan.params, state, tok)
                tok = logits.argmax(-1)
                tok.cpu()
                times.append(1e3 * (time.perf_counter() - t0))
        out[backend] = spread(times[warmup:])
        del plan, step, state, logits
    return out


def time_ssa(g: int, n: int, dh: int, reps: int, device) -> dict[str, float | None]:
    """``ssa_fwd`` on binary (g, n, dh) operands: ``events_ms`` (CUDA events
    over ``reps`` back-to-back calls after 3 warm-ups; host clock on the
    CPU) and ``device_ms`` (device time per call under ``torch.profiler``,
    None on the CPU)."""
    from repro_torch.kernels.spiking_attention import ops
    from repro_torch.kernels.spiking_attention.ref import ssa_ref

    gen = torch.Generator().manual_seed(0)
    q, k, v = ((torch.rand((g, n, dh), generator=gen) > 0.5).float().to(device)
               for _ in range(3))
    run = lambda: ops.ssa_fwd(q, k, v, scale=0.125)
    if not torch.equal(run(), ssa_ref(q, k, v, scale=0.125)):
        raise AssertionError("ssa_fwd differs from its plain version")
    for _ in range(3):
        run()
    if q.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        return {"events_ms": 1e3 * (time.perf_counter() - t0) / reps, "device_ms": None}
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end) / reps

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and "ssa" in e.key)
    return {"events_ms": events_ms, "device_ms": device_us / 1e3 / reps or None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' times the plain versions)")
    sub = ap.add_subparsers(dest="what", required=True)
    sv = sub.add_parser("serve", help="ms per slot batch on each kernel route")
    sv.add_argument("--arch", default="spike-iand-former-8-384")
    sv.add_argument("--batches", type=int, default=20)
    sv.add_argument("--warmup", type=int, default=2)
    sv.add_argument("--slots", type=int, default=8)
    sv.add_argument("--routes", default=",".join(ROUTES),
                    help="comma-separated backends (default: the three kernel routes)")
    tr = sub.add_parser("train", help="ms per SGD step")
    tr.add_argument("--arch", default="spike-iand-former-8-384")
    tr.add_argument("--steps", type=int, default=20)
    tr.add_argument("--warmup", type=int, default=2)
    tr.add_argument("--batch", type=int, default=16)
    lm = sub.add_parser("lm", help="ms per decode step of the spiking LM")
    lm.add_argument("--arch", default="llama3.2-1b")
    lm.add_argument("--steps", type=int, default=20)
    lm.add_argument("--warmup", type=int, default=2)
    lm.add_argument("--slots", type=int, default=4)
    lm.add_argument("--prompt", type=int, default=32)
    lm.add_argument("--routes", default=",".join(ROUTES),
                    help="comma-separated backends (default: the three kernel routes)")
    ss = sub.add_parser("ssa", help="ms per ssa_fwd call")
    ss.add_argument("--g", type=int, default=384)
    ss.add_argument("--n", type=int, default=196)
    ss.add_argument("--dh", type=int, default=32)
    ss.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    sys.path.insert(0, args.src)
    import repro_torch
    from repro_torch.engine.plan import resolve_device

    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    head = f"[timing] {Path(repro_torch.__file__).parent} on {where}:"
    if args.what == "serve":
        routes = tuple(args.routes.split(","))
        for route, st in time_serve(args.arch, args.batches, args.warmup, args.slots, dev,
                                    routes).items():
            print(f"{head} serve {args.arch} backend={route} slot batch {args.slots}, "
                  f"{args.batches} batches after {args.warmup} warm-up: ms per slot batch "
                  + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))
    elif args.what == "lm":
        for route, st in time_lm(args.arch, args.steps, args.warmup, args.slots, args.prompt,
                                 dev, tuple(args.routes.split(","))).items():
            print(f"{head} lm {args.arch} backend={route} {args.slots} slots, prompt "
                  f"{args.prompt}, {args.steps} decode steps after {args.warmup} warm-up: ms "
                  "per step " + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))
    elif args.what == "train":
        s = time_train(args.arch, args.steps, args.warmup, args.batch, dev)
        print(f"{head} train {args.arch} batch {args.batch}, {args.steps} steps after "
              f"{args.warmup} warm-up: ms per step " + ", ".join(f"{k} {v:.3f}"
                                                                 for k, v in s.items()))
    else:
        s = time_ssa(args.g, args.n, args.dh, args.reps, dev)
        dev_ms = "not measured" if s["device_ms"] is None else f"{s['device_ms']:.5f}"
        print(f"{head} ssa_fwd G={args.g} N={args.n} Dh={args.dh}: torch.equal the plain "
              f"version; ms per call: events {s['events_ms']:.5f}, device {dev_ms}")


if __name__ == "__main__":
    main()
