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
``lif``    the LIF kernels (K1 ``lif_parallel_fwd``, K4
           ``lif_parallel_pack_fwd`` with and without its occupancy map,
           K7 ``lif_parallel_bwd``) at the launches of one forward (K7: of
           one training step) of each form in LIF_FORMS: the 8-384 serving
           forward at slot batch 8, the spiking LM's prefill (4 x 32
           tokens), decode step (4 slots) and training step (4 x 64), and
           the bf16 drives; each launch held ``torch.equal`` to its plain
           version, then CUDA events over back-to-back calls and the device
           time per launch under ``torch.profiler`` (the map's memset
           apart), summed over the form's launches beside its byte bound.

Run it as a file, so that ``--src`` decides which checkout's
``repro_torch`` is imported (another checkout's ``src`` directory, or by
default the one holding this file)::

    python src/repro_torch/launch/timing.py serve --batches 20
    python src/repro_torch/launch/timing.py train --steps 20
    python src/repro_torch/launch/timing.py lm --steps 20
    python src/repro_torch/launch/timing.py --src ../other/src prefill --slots 4 --prompt 32
    python src/repro_torch/launch/timing.py --src ../other/src ssa --g 384 --n 64 --dh 32
    python src/repro_torch/launch/timing.py ssa --g 64 --n 32,2048 --dh 512 --causal --route dense,packed,sparse
    python src/repro_torch/launch/timing.py --src ../other/src lif --reps 20

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


HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at 700 W
LIF_T = 4                   # time steps of every LIF on the main paths
# The LIFs of one 8-384 forward: per image (neurons, IAND fused, launches,
# feature width D of the occupancy map): the tokenizer's four, then per
# block q, k, v, attn, the IAND of proj, fc1, the IAND of fc2.
VISION_LIFS = ((112 * 112 * 48, False, 1, 48), (56 * 56 * 96, False, 1, 96),
                (28 * 28 * 192, False, 1, 192), (196 * 384, False, 1 + 4 * 8, 384),
                (196 * 384, True, 2 * 8, 384), (196 * 1536, False, 8, 1536))


def _lm_lifs(tokens: int, train: bool = False):
    """The LIFs of one llama3.2-1b-width spiking LM forward over ``tokens``
    tokens (d_model 2048, d_ff 8192, 16 layers): the embedding's and per
    block q, k, v, attn, proj, fc1, fc2 (proj and fc2 fuse the IAND when
    serving)."""
    if train:
        return ((tokens * 2048, False, 1 + 6 * 16, 2048), (tokens * 8192, False, 16, 8192))
    return ((tokens * 2048, False, 1 + 4 * 16, 2048), (tokens * 2048, True, 2 * 16, 2048),
            (tokens * 8192, False, 16, 8192))


# form -> (kernel, dtype, per forward (neurons, iand, launches, D)); "K4+map"
# is K4 with its occupancy map of D-feature rows (the sparse route's form)
LIF_FORMS = {
    "K1 8-384": ("K1", torch.float32, tuple((8 * n, i, c, d) for n, i, c, d in VISION_LIFS)),
    "K4 8-384": ("K4", torch.float32, tuple((8 * n, i, c, d) for n, i, c, d in VISION_LIFS)),
    "K4+map 8-384": ("K4+map", torch.float32,
                     tuple((8 * n, i, c, d) for n, i, c, d in VISION_LIFS)),
    "K7 8-384 train": ("K7", torch.float32,
                       tuple((16 * n, False, c, d) for n, _, c, d in VISION_LIFS)),
    "K1 LM prefill": ("K1", torch.float32, _lm_lifs(4 * 32)),
    "K4 LM prefill": ("K4", torch.float32, _lm_lifs(4 * 32)),
    "K4+map LM prefill": ("K4+map", torch.float32, _lm_lifs(4 * 32)),
    "K1 LM decode": ("K1", torch.float32, _lm_lifs(4)),
    "K4 LM decode": ("K4", torch.float32, _lm_lifs(4)),
    "K4+map LM decode": ("K4+map", torch.float32, _lm_lifs(4)),
    "K1 LM train": ("K1", torch.float32, _lm_lifs(4 * 64, train=True)),
    "K1 8-384 bf16": ("K1", torch.bfloat16, tuple((8 * n, i, c, d) for n, i, c, d in VISION_LIFS)),
    "K4 8-384 bf16": ("K4", torch.bfloat16, tuple((8 * n, i, c, d) for n, i, c, d in VISION_LIFS)),
    "K7 8-384 train bf16": ("K7", torch.bfloat16,
                            tuple((16 * n, False, c, d) for n, _, c, d in VISION_LIFS)),
}


def _lif_case(kernel: str, dtype, n: int, iand: bool, cols: int, reps: int, device,
              seed: int) -> dict[str, float | None]:
    """One launch of ``kernel`` (``LIF_FORMS``' kernel names) on a seeded
    (LIF_T, n) drive: held ``torch.equal`` to its plain version, then
    ``events_ms`` (CUDA events over ``reps`` calls after 3 warm-ups; host
    clock on the CPU), ``device_ms`` (its kernel's device time per call
    under ``torch.profiler``) and ``memset_ms`` (the device memsets per
    call), both None on the CPU or where three profiles in a row missed some
    of the ``reps`` kernels, and its ``bytes``: each input read and each
    output written once."""
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops
    from repro_torch.kernels.lif_parallel.ref import (
        lif_pack_ref, lif_parallel_ref, lif_parallel_ref_grad)

    t, size = LIF_T, torch.finfo(dtype).bits // 8
    gen = torch.Generator(device).manual_seed(seed)
    drive = torch.randn((t, n), generator=gen, device=device)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8      # membranes exactly on theta too
    drive = drive.to(dtype)
    spikes = (torch.rand((t, n), generator=gen, device=device) > 0.5).to(dtype)
    kw = dict(chain_len=t, lam=0.25, theta=0.5, reset="hard")
    words = packing.num_words(t) * n * 4
    if kernel == "K1":
        skip = spikes if iand else None
        run = lambda: ops.lif_parallel_fwd(drive, skip=skip, **kw)
        plain = lambda: lif_parallel_ref(drive, skip=skip, **kw)
        nbytes = size * t * n * (3 if iand else 2)
    elif kernel == "K7":
        g = spikes - 0.5
        run = lambda: ops.lif_parallel_bwd(drive, g, **kw)
        plain = lambda: lif_parallel_ref_grad(drive, g, chain_len=t)
        nbytes = 3 * size * t * n
    else:
        skip = packing.pack(spikes.float()).words if iand else None
        occ_cols = cols if kernel == "K4+map" else 0
        run = lambda: ops.lif_parallel_pack_fwd(drive, skip_words=skip, occ_cols=occ_cols, **kw)

        def plain():
            w = lif_pack_ref(drive, skip_words=skip, **kw)
            return (w, packing.occupancy_map(w.reshape(w.shape[0], -1, cols))) if occ_cols else w

        nbytes = size * t * n + words * (2 if iand else 1)
        if occ_cols:
            nbytes += packing.num_words(t) * (n // cols) * -(-cols // packing.OCC_TILE) * 4
    got, want = run(), plain()
    same = (all(map(torch.equal, got, want)) if isinstance(got, tuple)
            else torch.equal(got, want))
    if not same:
        raise AssertionError(f"{kernel} {dtype} N={n} iand={iand}: differs from its plain "
                             "version")
    del got, want
    for _ in range(3):
        run()
    out = {"bytes": nbytes, "device_ms": None, "memset_ms": None}
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        out["events_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        return out
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    out["events_ms"] = start.elapsed_time(end) / reps

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):          # the profiler at times drops kernels: retake an incomplete one
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        mine = [e for e in events if "lif_" in e.key]
        if sum(e.count for e in mine) == reps:
            out["device_ms"] = sum(e.self_device_time_total for e in mine) / 1e3 / reps
            out["memset_ms"] = sum(e.self_device_time_total for e in events
                                   if "memset" in e.key.lower()) / 1e3 / reps
            break
    return out


def time_lif(forms, reps: int, device, log=None) -> dict[str, dict[str, float | None]]:
    """Each form of ``forms`` (keys of LIF_FORMS): its launches of one forward
    (K7: of one training step) measured by :func:`_lif_case`, summed with
    their counts: ``launches``, ``events_ms``, ``device_ms``, ``memset_ms``
    (None on the CPU) and ``bound_ms``, the bytes over the card's memory
    rate (the LIF's few operations an element are far below the f32 peak).
    ``log(line)`` gets one line per launch shape."""
    out = {}
    for form in forms:
        kernel, dtype, cases = LIF_FORMS[form]
        st = {"launches": 0, "events_ms": 0.0, "device_ms": 0.0, "memset_ms": 0.0,
              "bound_ms": 0.0}
        for i, (n, iand, count, cols) in enumerate(cases):
            c = _lif_case(kernel, dtype, n, iand, cols, reps, device, seed=i)
            bound = c["bytes"] / HBM_BYTES_PER_S * 1e3
            st["launches"] += count
            st["events_ms"] += count * c["events_ms"]
            st["bound_ms"] += count * bound
            for k in ("device_ms", "memset_ms"):
                st[k] = None if c[k] is None or st[k] is None else st[k] + count * c[k]
            if log:
                dev_ms = ("not measured" if c["device_ms"] is None else
                          f"{c['device_ms']:.5f} (memset {c['memset_ms']:.5f})")
                log(f"lif {form} N={n} iand={iand} D={cols} x{count}: torch.equal the plain "
                    f"version; ms per launch: events {c['events_ms']:.5f}, device {dev_ms}, "
                    f"bound {bound:.5f}")
        out[form] = st
    return out


def lif_line(form: str, st: dict[str, float | None]) -> str:
    """One form's line of :func:`time_lif`'s results."""
    fmt = lambda k: "not measured" if st[k] is None else f"{st[k]:.5f}"
    share = ("not measured" if st["device_ms"] is None
             else f"{st['bound_ms'] / st['device_ms']:.1%}")
    return (f"lif {form}: {st['launches']} launches; ms per forward: events "
            f"{st['events_ms']:.5f}, device {fmt('device_ms')} (memset {fmt('memset_ms')}), "
            f"bound {st['bound_ms']:.5f} (bytes), device share {share}")


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
    lf = sub.add_parser("lif", help="ms per forward of every form of the LIF kernels")
    lf.add_argument("--reps", type=int, default=20)
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
    elif args.what == "lif":
        for form, st in time_lif(LIF_FORMS, args.reps, dev,
                                 log=lambda x: print(f"{head} {x}")).items():
            print(f"{head} {lif_line(form, st)}")
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
