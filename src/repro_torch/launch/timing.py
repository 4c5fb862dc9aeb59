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
``prefill`` prefills of the live spiking LM on each kernel route: ms per
           prefill by CUDA events, and the device ms per prefill of its SSA,
           spike GEMM and LIF kernels, each the median of ``--reps``
           profiles that trace a warm-up prefill before the kept one (as
           ``chip_smoke.py`` profiles).
``ssa``    an SSA entry point on random binary operands of shape (G, N,
           Dh), causal or not: ``ssa_fwd`` (``--route dense``), or
           ``packed_ssa_fwd`` / ``sparse_packed_ssa_fwd`` (``packed`` /
           ``sparse``) on the same spikes as the spiking LM's T = 4 planes
           of G / 4 folds; held ``torch.equal`` to its plain version, then CUDA
           events over back-to-back calls (as ``chip_smoke.py`` times a
           kernel) and the device time per launch of the kernels the call
           runs under ``torch.profiler``.

Run it as a file, so that ``--src`` decides which checkout's
``repro_torch`` is imported (another checkout's ``src`` directory, or by
default the one holding this file)::

    python src/repro_torch/launch/timing.py serve --batches 20
    python src/repro_torch/launch/timing.py train --steps 20
    python src/repro_torch/launch/timing.py lm --steps 20
    python src/repro_torch/launch/timing.py --src ../other/src prefill --slots 4 --prompt 32
    python src/repro_torch/launch/timing.py --src ../other/src ssa --g 384 --n 64 --dh 32
    python src/repro_torch/launch/timing.py ssa --g 64 --n 32,2048 --dh 512 --causal --route dense,packed,sparse

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


# kinds of the port's kernels, by a part of their names in the library
KERNEL_KINDS = {"ssa": "ssa", "gemm": "spike_matmul", "lif": "lif_"}


def time_prefill(arch: str, slots: int, prompt: int, reps: int, device,
                 routes=ROUTES) -> dict[str, dict[str, float | None]]:
    """Prefills of ``slots`` ``prompt``-token prompts through the live spiking
    ``arch`` on each of ``routes``: ``events_ms`` (CUDA events over ``reps``
    back-to-back prefills after a warm-up; host clock on the CPU) and, for
    each kind of KERNEL_KINDS, ``<kind>_ms``: its kernels' device ms per
    prefill, the median of ``reps`` profiles, each of which traces a warm-up
    prefill and keeps the one after it (``schedule(warmup=1, active=1)``);
    None on the CPU."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import engine
    from repro_torch.launch.serve import live_lm_params, spiking_lm_config

    cfg = spiking_lm_config(arch)
    params = live_lm_params(cfg, device)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (slots, prompt), generator=gen).to(device)
    on_card = device.type == "cuda"
    out = {}
    for backend in routes:
        plan = engine.compile_plan(params, None, cfg, backend=backend, device=device)
        prefill = engine.make_prefill_fn(plan)
        run = lambda: prefill(plan.params, tokens)
        with torch.inference_mode():
            run()
            if on_card:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    run()
                end.record()
                torch.cuda.synchronize()
                st = {"events_ms": start.elapsed_time(end) / reps}
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    run()
                st = {"events_ms": 1e3 * (time.perf_counter() - t0) / reps}
            kinds = {kind: [] for kind in KERNEL_KINDS}
            for _ in range(reps if on_card else 0):
                kept = {}

                def ready(prof):
                    kept["events"] = [e for e in prof.key_averages()
                                      if e.device_type == torch.autograd.DeviceType.CUDA
                                      and "(anonymous namespace)::" in e.key]

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=ready) as prof:
                    for _ in range(2):      # the traced warm-up prefill, then the kept one
                        run()
                        torch.cuda.synchronize()
                        prof.step()
                for kind, part in KERNEL_KINDS.items():
                    kinds[kind].append(sum(e.self_device_time_total for e in kept["events"]
                                           if part in e.key.split("::")[1]) / 1e3)
        for kind, xs in kinds.items():
            st[f"{kind}_ms"] = statistics.median(xs) if xs else None
        out[backend] = st
        del plan, prefill, run
    return out


SSA_ROUTES = {"dense": "ssa_fwd", "packed": "packed_ssa_fwd", "sparse": "sparse_packed_ssa_fwd"}
SSA_PLANES = 4   # time steps of the packed routes' words (the spiking LM's T)


def time_ssa(g: int, n: int, dh: int, reps: int, device, *, route: str = "dense",
             causal: bool = False) -> dict[str, float | None]:
    """The entry point ``SSA_ROUTES[route]`` on binary (g, n, dh) operands
    (packed and sparse: the same spikes as SSA_PLANES planes of g /
    SSA_PLANES folds):
    ``events_ms`` (CUDA events over ``reps`` back-to-back calls after 3
    warm-ups; host clock on the CPU) and ``device_ms`` (device time per call
    under ``torch.profiler``, None on the CPU)."""
    from repro_torch.core import packing
    from repro_torch.kernels.spiking_attention import ops
    from repro_torch.kernels.spiking_attention.ref import ssa_ref

    gen = torch.Generator().manual_seed(0)
    q, k, v = ((torch.rand((g, n, dh), generator=gen) > 0.5).float().to(device)
               for _ in range(3))
    want = ssa_ref(q, k, v, scale=0.125, causal=causal)
    if route == "dense":
        run = lambda: ops.ssa_fwd(q, k, v, scale=0.125, causal=causal)
    else:
        t = SSA_PLANES
        if g % t:
            raise ValueError(f"--g {g} is not a multiple of {t} planes")
        words = [packing.pack(x.reshape(t, g // t, n, dh)).words for x in (q, k, v)]
        live = ops._plane_liveness(*words, t)
        run = ((lambda: ops.packed_ssa_fwd(*words, t=t, scale=0.125, causal=causal))
               if route == "packed" else
               (lambda: ops.sparse_packed_ssa_fwd(*words, live, t=t, scale=0.125,
                                                  causal=causal)))
    if not torch.equal(run().reshape(want.shape), want):
        raise AssertionError(f"{SSA_ROUTES[route]} differs from its plain version")
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
    pf = sub.add_parser("prefill", help="ms per prefill of the spiking LM, and its kernels' "
                        "device ms")
    pf.add_argument("--arch", default="llama3.2-1b")
    pf.add_argument("--slots", type=int, default=4)
    pf.add_argument("--prompt", type=int, default=32)
    pf.add_argument("--reps", type=int, default=5)
    pf.add_argument("--routes", default=",".join(ROUTES),
                    help="comma-separated backends (default: the three kernel routes)")
    ss = sub.add_parser("ssa", help="ms per call of an SSA entry point")
    ss.add_argument("--g", type=int, default=384)
    ss.add_argument("--n", default="196", help="token count, or a comma-separated list")
    ss.add_argument("--dh", type=int, default=32)
    ss.add_argument("--reps", type=int, default=20)
    ss.add_argument("--route", default="dense",
                    help=f"one of {', '.join(SSA_ROUTES)}, or a comma-separated list")
    ss.add_argument("--causal", action="store_true")
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
    elif args.what == "prefill":
        for route, st in time_prefill(args.arch, args.slots, args.prompt, args.reps, dev,
                                      tuple(args.routes.split(","))).items():
            kinds = ", ".join(f"{kind} " + ("not measured" if st[f"{kind}_ms"] is None
                                            else f"{st[f'{kind}_ms']:.5f}")
                              for kind in KERNEL_KINDS)
            print(f"{head} prefill {args.arch} backend={route} {args.slots} slots, prompt "
                  f"{args.prompt}, {args.reps} reps: ms per prefill: events "
                  f"{st['events_ms']:.5f}; device, median of {args.reps} profiles: {kinds}")
    elif args.what == "train":
        s = time_train(args.arch, args.steps, args.warmup, args.batch, dev)
        print(f"{head} train {args.arch} batch {args.batch}, {args.steps} steps after "
              f"{args.warmup} warm-up: ms per step " + ", ".join(f"{k} {v:.3f}"
                                                                 for k, v in s.items()))
    else:
        routes = args.route.split(",")
        unknown = [r for r in routes if r not in SSA_ROUTES]
        if unknown:
            ap.error(f"--route: {unknown} not in {tuple(SSA_ROUTES)}")
        for n in (int(x) for x in args.n.split(",")):
            for route in routes:
                s = time_ssa(args.g, n, args.dh, args.reps, dev, route=route,
                             causal=args.causal)
                dev_ms = "not measured" if s["device_ms"] is None else f"{s['device_ms']:.5f}"
                planes = "" if route == "dense" else f" T={SSA_PLANES}"
                print(f"{head} {SSA_ROUTES[route]} G={args.g} N={n} Dh={args.dh}{planes}"
                      f"{' causal' if args.causal else ''}: torch.equal the plain version; ms "
                      f"per call: events {s['events_ms']:.5f}, device {dev_ms}")


if __name__ == "__main__":
    main()
