#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing falls back to the CPU):
  1. card and build: the card's name and power limit, and the build of every
     CUDA kernel from the sources in this checkout (``nvcc``, sm_90a);
  2. kernels vs plain: each kernel (K1-K3 of the dense path, K4-K6 of the
     packed path) at the shapes its path gives it (spike-iand-former-8-384,
     slot batch 8), held against its plain PyTorch version on the same inputs,
     and timed beside it, beside one library call computing the same function
     (where there is one), and beside its bound;
  3. model: the two main paths -- ``serve_vision`` of spike-iand-former-8-384,
     3 slot batches of 8 images, on backend="cuda" (dense spikes, K1-K3) and on
     backend="cuda+packed" (spikes bit-packed along time, K4-K6) -- each with
     every launch counter set to 0 just before and read just after; the dense
     logits held against the backend="torch" plan, the packed logits against
     the backend="torch+packed" plan and beside the dense CUDA plan's, spike
     and word mismatches counted layer by layer;
  4. the other vision configs once each at full size through the dense plans,
     and the IAND ones through the packed plans too.
The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
line of per-kernel numbers, and ``{"ok": true, "device": {...}}``.  In the
JSON line ``launches`` is the count over the whole main-path run of the
kernel's path (warm-up forward included) and ``launches_per_forward`` that
count over the forwards.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ARCH = "spike-iand-former-8-384"
SLOTS, REQUESTS = 8, 24
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at 700 W
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores, same source
GEMM_TOL = dict(rtol=1e-5, atol=1e-4)   # f32 sums of up to 1728 terms, reordered
LOGITS_ATOL = 1e-3


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelReport:
    """Per-kernel sums over the main path's cases, each weighted by how many
    times one forward launches it."""

    def __init__(self, name, source, replaces):
        self.entry = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": None,
                      "launches_per_forward": None, "max_abs_err": 0.0,
                      "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
                      "library_ms": None}
        self._bound = {"bytes": 0.0, "operations": 0.0}

    def add(self, label, count, err, ms, plain_ms, nbytes, flops, library_ms=None):
        b, by = bound_ms(nbytes, flops)
        e = self.entry
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += count * ms
        e["plain_ms"] += count * plain_ms
        e["bound_ms"] += count * b
        self._bound[by] += count * b
        if library_ms is not None:
            e["library_ms"] = (e["library_ms"] or 0.0) + count * library_ms
        e["bound_by"] = max(self._bound, key=self._bound.get)
        lib = f" library {library_ms:.4f} ms" if library_ms is not None else ""
        log(f"  {self.entry['name']} {label} x{count}/forward: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms,{lib} bound {b:.4f} ms ({by}), "
            f"max_abs_err {err:.3g}")


def phase_card_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")
    return smi


def phase_kernels(dev, gen):
    """Kernels vs plain at the 8-384 main path's shapes, slot batch 8."""
    from repro_torch.core import lif as tlif
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import ssa_ref

    t, b, ntok, d, hid, heads = 4, SLOTS, 196, 384, 1536, 12
    reports = {}

    # -- K1: LIF (+IAND) ---------------------------------------------------
    rep = KernelReport("lif_parallel", "src/repro_torch/kernels/lif_parallel/csrc/lif_parallel.cu",
                       "src/repro/kernels/lif_parallel/kernel.py:144")
    big = b * 112 * 112 * 48
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8      # membranes exactly on theta too
    skip = (torch.rand((t, big), generator=gen) > 0.5).float().to(dev)
    for iand in (False, True):
        for reset in ("hard", "soft"):
            for chain in (1, 2, 4):
                sk = skip if iand else None
                got = lif_ops.lif_parallel_fwd(drive, chain_len=chain, lam=0.25,
                                               theta=0.5, reset=reset, skip=sk)
                want = tlif.lif_parallel(drive, chain_len=chain, reset=reset, iand_skip=sk)
                if not torch.equal(got, want):
                    fail(f"lif_parallel iand={iand} reset={reset} chain_len={chain}: "
                         f"{(got != want).sum().item()} mismatches")
    log(f"K1 lif_parallel: torch.equal at N={big} for iand x reset x chain_len 1/2/4")
    cases = [(b * 112 * 112 * 48, False, 1), (b * 56 * 56 * 96, False, 1 + 8),
             (b * 28 * 28 * 192, False, 1), (b * ntok * d, False, 1 + 4 * 8),
             (b * ntok * d, True, 2 * 8)]
    for n, iand, count in cases:
        x, sk = drive[:, :n].contiguous(), (skip[:, :n].contiguous() if iand else None)
        run = lambda: lif_ops.lif_parallel_fwd(x, chain_len=t, lam=0.25, theta=0.5,
                                               reset="hard", skip=sk)
        plain = lambda: tlif.lif_parallel(x, iand_skip=sk)
        got, want = run(), plain()
        if not torch.equal(got, want):
            fail(f"lif_parallel N={n} iand={iand}: not equal to the plain version")
        nbytes = 4 * t * n * (3 if iand else 2)
        rep.add(f"N={n} iand={iand}", count, 0.0, time_ms(run), time_ms(plain), nbytes,
                5 * t * n)
    reports["K1"] = rep
    del drive, skip

    # -- K2: spike GEMM ----------------------------------------------------
    rep = KernelReport("spike_matmul", "src/repro_torch/kernels/spike_matmul/csrc/spike_matmul.cu",
                       "src/repro/kernels/spike_matmul/kernel.py:164")
    m_blk = t * b * ntok
    cases = [(t * b * 112 * 112, 9 * 48, 96, 1), (t * b * 56 * 56, 9 * 96, 192, 1),
             (t * b * 28 * 28, 9 * 192, 384, 1), (m_blk, d, d, 4 * 8),
             (m_blk, d, hid, 8), (m_blk, hid, d, 8)]
    for m, k, c, count in cases:
        x = (torch.rand((m, k), generator=gen) > 0.5).float().to(dev)
        w = ((torch.rand((k, c), generator=gen) * 2 - 1) / k ** 0.5).to(dev)
        run = lambda: mm_ops.spike_matmul_fwd(x, w)
        plain = lambda: mm_ops.spike_matmul_ref(x, w)
        got, want = run(), plain()
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        if not torch.allclose(got, want, **GEMM_TOL):
            fail(f"spike_matmul {m}x{k}x{c}: max abs err {err:.3g}, max rel {rel:.3g} "
                 f"outside {GEMM_TOL}")
        log(f"  spike_matmul {m}x{k}x{c}: max abs err {err:.3g}, max rel err {rel:.3g} "
            f"(tolerance {GEMM_TOL})")
        rep.add(f"{m}x{k}x{c}", count, err, time_ms(run), time_ms(plain),
                4 * (m * k + k * c + m * c), 2 * m * k * c,
                library_ms=time_ms(lambda: torch.matmul(x, w)))
        del x, w, got, want
    reports["K2"] = rep

    # -- K3: SSA -----------------------------------------------------------
    rep = KernelReport("ssa", "src/repro_torch/kernels/spiking_attention/csrc/ssa.cu",
                       "src/repro/kernels/spiking_attention/kernel.py:62")
    g, dh = t * b * heads, d // heads
    q, k, v = ((torch.rand((g, ntok, dh), generator=gen) > 0.5).float().to(dev)
               for _ in range(3))
    run = lambda: ssa_ops.ssa_fwd(q, k, v, scale=0.125)
    plain = lambda: ssa_ref(q, k, v, scale=0.125)
    if not torch.equal(run(), plain()):
        fail("ssa: not equal to the plain version")
    log(f"K3 ssa: torch.equal at G={g}, N={ntok}, Dh={dh}")
    library = lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v) * 0.125
    rep.add(f"G={g} N={ntok} Dh={dh}", 8, 0.0, time_ms(run), time_ms(plain),
            4 * 4 * g * ntok * dh, 4 * g * ntok * ntok * dh, library_ms=time_ms(library))
    reports["K3"] = rep
    reports.update(_packed_kernels(dev, gen))
    return reports


def _packed_kernels(dev, gen):
    """K4-K6 at the packed path's shapes (8-384, slot batch 8, T=4: one word
    per neuron)."""
    from repro_torch.core import packing
    from repro_torch.kernels.lif_parallel import ops as lif_ops
    from repro_torch.kernels.lif_parallel.ref import lif_pack_ref
    from repro_torch.kernels.spike_matmul import ops as mm_ops
    from repro_torch.kernels.spike_matmul.ref import packed_spike_matmul_ref
    from repro_torch.kernels.spiking_attention import ops as ssa_ops
    from repro_torch.kernels.spiking_attention.ref import packed_ssa_ref

    t, b, ntok, d, hid, heads = 4, SLOTS, 196, 384, 1536, 12
    words = lambda shape: packing.pack(
        (torch.rand((t,) + shape, generator=gen) > 0.5).float()).words.to(dev)
    unpack = lambda w: packing.unpack(packing.PackedSpikes(w, t))
    reports = {}

    # -- K4: LIF with the pack epilogue (+IAND) ----------------------------
    rep = KernelReport("lif_pack", "src/repro_torch/kernels/lif_parallel/csrc/lif_parallel.cu",
                       "src/repro/kernels/lif_parallel/kernel.py:174")
    big = b * 112 * 112 * 48
    drive = torch.randn((t, big), generator=gen).to(dev)
    drive[:, ::3] = torch.round(drive[:, ::3] * 8) / 8      # membranes exactly on theta too
    skip = words((big,))
    for iand in (False, True):
        for reset in ("hard", "soft"):
            for chain in (1, 2, 4):
                sk = skip if iand else None
                got = lif_ops.lif_parallel_pack_fwd(drive, chain_len=chain, lam=0.25,
                                                    theta=0.5, reset=reset, skip_words=sk)
                want = lif_pack_ref(drive, chain_len=chain, reset=reset, skip_words=sk)
                if not torch.equal(got, want):
                    fail(f"lif_pack iand={iand} reset={reset} chain_len={chain}: "
                         f"{(got != want).sum().item()} word mismatches")
    log(f"K4 lif_pack: torch.equal at N={big} for iand x reset x chain_len 1/2/4")
    cases = [(b * 112 * 112 * 48, False, 1), (b * 56 * 56 * 96, False, 1 + 8),
             (b * 28 * 28 * 192, False, 1), (b * ntok * d, False, 1 + 4 * 8),
             (b * ntok * d, True, 2 * 8)]
    for n, iand, count in cases:
        x, sk = drive[:, :n].contiguous(), (skip[:, :n].contiguous() if iand else None)
        run = lambda: lif_ops.lif_parallel_pack_fwd(x, chain_len=t, lam=0.25, theta=0.5,
                                                    reset="hard", skip_words=sk)
        plain = lambda: lif_pack_ref(x, chain_len=t, skip_words=sk)
        if not torch.equal(run(), plain()):
            fail(f"lif_pack N={n} iand={iand}: not equal to the plain version")
        nbytes = 4 * t * n + 4 * n * (2 if iand else 1)
        rep.add(f"N={n} iand={iand}", count, 0.0, time_ms(run), time_ms(plain), nbytes,
                5 * t * n)
    reports["K4"] = rep
    del drive, skip

    # -- K5: packed spike GEMM --------------------------------------------
    rep = KernelReport("packed_spike_matmul",
                       "src/repro_torch/kernels/spike_matmul/csrc/spike_matmul.cu",
                       "src/repro/kernels/spike_matmul/kernel.py:136")
    m_blk = b * ntok
    cases = [(b * 112 * 112, 9 * 48, 96, 1), (b * 56 * 56, 9 * 96, 192, 1),
             (b * 28 * 28, 9 * 192, 384, 1), (m_blk, d, d, 4 * 8),
             (m_blk, d, hid, 8), (m_blk, hid, d, 8)]
    for m, k, c, count in cases:
        xw = words((m, k))[0]
        w = ((torch.rand((k, c), generator=gen) * 2 - 1) / k ** 0.5).to(dev)
        run = lambda: mm_ops.packed_spike_matmul_fwd(xw, w, t=t)
        plain = lambda: packed_spike_matmul_ref(xw, w, t=t)
        got, want = run(), plain()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **GEMM_TOL):
            fail(f"packed_spike_matmul {m}x{k}x{c}: max abs err {err:.3g} outside {GEMM_TOL}")
        dense = unpack(xw[None]).reshape(t * m, k)
        same_as_k2 = torch.equal(got.reshape(t * m, c), mm_ops.spike_matmul_fwd(dense, w))
        log(f"  packed_spike_matmul {m}x{k}x{c} T={t}: max abs err {err:.3g} "
            f"(tolerance {GEMM_TOL}); equal to K2 on the unpacked operand: {same_as_k2}")
        if not same_as_k2:
            fail(f"packed_spike_matmul {m}x{k}x{c}: differs from K2 on the unpacked operand")
        rep.add(f"{m}x{k}x{c}", count, err, time_ms(run), time_ms(plain),
                4 * (m * k + k * c + t * m * c), 2 * t * m * k * c,
                library_ms=time_ms(lambda: torch.matmul(dense, w)))
        del xw, w, got, want, dense
    log("  K5 library_ms is torch.matmul on the unpacked (T*M, K) f32 operand")
    reports["K5"] = rep

    # -- K6: packed SSA ----------------------------------------------------
    rep = KernelReport("packed_ssa", "src/repro_torch/kernels/spiking_attention/csrc/ssa.cu",
                       "src/repro/kernels/spiking_attention/kernel.py:164")
    g, dh = b * heads, d // heads
    qw, kw, vw = (words((g, ntok, dh)) for _ in range(3))
    for causal in (False, True):
        got = ssa_ops.packed_ssa_fwd(qw, kw, vw, t=t, scale=0.125, causal=causal)
        if not torch.equal(got, packed_ssa_ref(qw, kw, vw, t=t, scale=0.125, causal=causal)):
            fail(f"packed_ssa causal={causal}: not equal to the plain version")
    log(f"K6 packed_ssa: torch.equal at G={g}, N={ntok}, Dh={dh}, T={t}, causal and not")
    run = lambda: ssa_ops.packed_ssa_fwd(qw, kw, vw, t=t, scale=0.125)
    plain = lambda: packed_ssa_ref(qw, kw, vw, t=t, scale=0.125)
    q, k, v = (unpack(x).reshape(t * g, ntok, dh) for x in (qw, kw, vw))
    library = lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v) * 0.125
    rep.add(f"G={g} N={ntok} Dh={dh} T={t}", 8, 0.0, time_ms(run), time_ms(plain),
            4 * 3 * g * ntok * dh + 4 * t * g * ntok * dh, 4 * t * g * ntok * ntok * dh,
            library_ms=time_ms(library))
    log("  K6 library_ms is two torch.bmm on the unpacked f32 operands")
    reports["K6"] = rep
    return reports


def _counters():
    from repro_torch.kernels.lif_parallel.ops import lif_parallel_fwd, lif_parallel_pack_fwd
    from repro_torch.kernels.spike_matmul.ops import packed_spike_matmul_fwd, spike_matmul_fwd
    from repro_torch.kernels.spiking_attention.ops import packed_ssa_fwd, ssa_fwd

    return {"K1": lif_parallel_fwd, "K2": spike_matmul_fwd, "K3": ssa_fwd,
            "K4": lif_parallel_pack_fwd, "K5": packed_spike_matmul_fwd, "K6": packed_ssa_fwd}


def _per_forward(num_layers, packed=False):
    """Launches per forward of each kernel on the dense or the packed path:
    a LIF per tokenizer stage and 7 per block, a GEMM per spike conv stage and
    6 per block, an SSA per block; the other path's kernels never launch."""
    counts = (4 + 7 * num_layers, 3 + 6 * num_layers, num_layers)
    path, other = (("K4", "K5", "K6"), ("K1", "K2", "K3")) if packed else \
        (("K1", "K2", "K3"), ("K4", "K5", "K6"))
    return {**dict(zip(path, counts)), **dict.fromkeys(other, 0)}


def _serve_counted(backend, dev, want_per_forward):
    """serve_vision of the main path on ``backend`` with every launch counter
    set to 0 just before and read just after; fails unless each kernel of the
    path launched exactly its count per forward and no other kernel did."""
    from repro_torch.launch.serve import serve_vision

    counters = _counters()
    for f in counters.values():
        f.launches = 0
    served = serve_vision(ARCH, num_requests=REQUESTS, slots=SLOTS, backend=backend,
                          device=dev)
    launches = {k: f.launches for k, f in counters.items()}
    for key, n in launches.items():
        want = served["forwards"] * want_per_forward[key]
        if n != want or (want_per_forward[key] and n == 0):
            fail(f"{backend}: {key} launched {n} times in {served['forwards']} forwards, "
                 f"expected {want_per_forward[key]} per forward")
    log(f"main path on backend={backend}: {served['forwards']} forwards (warm-up "
        f"included), launches {launches} = {want_per_forward} per forward")
    return served, launches


def _check_logits(label, got, want, atol=LOGITS_ATOL):
    if not all(torch.isfinite(x).all() for x in (got, want)):
        fail(f"{label}: non-finite logits")
    diff = (got - want).abs().max().item()
    agree = sum(int(a == b) for a, b in zip(got.argmax(-1), want.argmax(-1)))
    log(f"logits {label}: max abs diff {diff:.3g} (atol {atol}), argmax agrees on "
        f"{agree}/{got.shape[0]}")
    if diff > atol:
        fail(f"{label}: logits differ by {diff:.3g} > {atol}")
    return diff


def _serve_line(label, r, cfg, smi):
    log(f"serve {ARCH} backend={label}: {r['img_per_s']:.2f} img/s, "
        f"{1e3 * r['seconds'] * SLOTS / REQUESTS:.3f} ms per slot batch of {SLOTS} "
        f"({REQUESTS} images, {cfg.img_size}x{cfg.img_size}) on {smi}")


def phase_model(dev, smi):
    """The dense main path (K1-K3), then the packed one (K4-K6)."""
    from repro_torch import engine
    from repro_torch.engine import execute
    from repro_torch.launch.serve import seeded_model, serve_vision

    plan, images = seeded_model(ARCH, num_requests=REQUESTS, backend="cuda", device=dev)
    cfg = plan.cfg
    want = _per_forward(cfg.num_layers)
    if engine.plan_stats(plan)["lif_dispatches"] != want["K1"]:
        fail("plan_stats lif_dispatches disagrees with the launch accounting")
    served, launches = _serve_counted("cuda", dev, want)
    plain = serve_vision(ARCH, num_requests=REQUESTS, slots=SLOTS, backend="torch",
                         device=dev, verbose=False)
    if served["logits"].shape != (REQUESTS, cfg.num_classes):
        fail(f"logits shape {tuple(served['logits'].shape)}")
    _check_logits("cuda vs backend=torch plan on the card", served["logits"], plain["logits"])

    # layer by layer on the first slot batch: every cuda layer gets the plain
    # plan's input spikes
    ref_plan, _ = seeded_model(ARCH, num_requests=1, backend="torch", device=dev)
    batch = images[:SLOTS]
    with torch.inference_mode():
        x = execute._tokenizer_exec(ref_plan.meta, ref_plan.params["tokenizer"], batch)
        y = execute._tokenizer_exec(plan.meta, plan.params["tokenizer"], batch)
        rows = [("tokenizer", (x != y).sum().item(), x.numel())]
        for i, (rb, cb) in enumerate(zip(ref_plan.params["blocks"], plan.params["blocks"])):
            y = execute._block_exec(plan.meta, cb, x)
            x = execute._block_exec(ref_plan.meta, rb, x)
            rows.append((f"block{i}", (x != y).sum().item(), x.numel()))
    for name, bad, total in rows:
        log(f"  spike mismatches {name}: {bad} of {total}")

    # -- the packed main path ----------------------------------------------
    pplan, _ = seeded_model(ARCH, num_requests=1, backend="cuda+packed", device=dev)
    if engine.plan_stats(pplan)["bits_per_spike"] != 32 / cfg.t:
        fail("plan_stats bits_per_spike of the packed plan")
    want_packed = _per_forward(cfg.num_layers, packed=True)
    packed, packed_launches = _serve_counted("cuda+packed", dev, want_packed)
    packed_plain = serve_vision(ARCH, num_requests=REQUESTS, slots=SLOTS,
                                backend="torch+packed", device=dev, verbose=False)
    _check_logits("cuda+packed vs backend=torch+packed plan on the card",
                  packed["logits"], packed_plain["logits"])
    vs_dense = (packed["logits"] - served["logits"]).abs().max().item()
    log(f"logits cuda+packed vs the dense cuda plan: max abs diff {vs_dense:.3g} "
        f"(equal: {torch.equal(packed['logits'], served['logits'])})")

    # word by word on the first slot batch: every cuda+packed layer gets the
    # torch+packed plan's input words
    ref_pplan, _ = seeded_model(ARCH, num_requests=1, backend="torch+packed", device=dev)
    with torch.inference_mode():
        x = execute._tokenizer_exec_packed(ref_pplan.meta, ref_pplan.params["tokenizer"],
                                           batch)
        y = execute._tokenizer_exec_packed(pplan.meta, pplan.params["tokenizer"], batch)
        rows = [("tokenizer", (x.words != y.words).sum().item(), x.words.numel())]
        for i, (rb, cb) in enumerate(zip(ref_pplan.params["blocks"], pplan.params["blocks"])):
            y = execute._block_exec_packed(pplan.meta, cb, x)
            x = execute._block_exec_packed(ref_pplan.meta, rb, x)
            rows.append((f"block{i}", (x.words != y.words).sum().item(), x.words.numel()))
    for name, bad, total in rows:
        log(f"  word mismatches {name}: {bad} of {total}")

    for label, r in (("cuda", served), ("torch", plain), ("cuda+packed", packed),
                     ("torch+packed", packed_plain)):
        _serve_line(label, r, cfg, smi)
    forwards = {**dict.fromkeys(("K1", "K2", "K3"), served["forwards"]),
                **dict.fromkeys(("K4", "K5", "K6"), packed["forwards"])}
    totals = {k: launches[k] for k in ("K1", "K2", "K3")}
    totals.update({k: packed_launches[k] for k in ("K4", "K5", "K6")})
    return totals, forwards


def phase_other_configs(dev):
    from repro_torch import engine
    from repro_torch.configs.spike_iand_former import get_vision_config, list_vision_configs
    from repro_torch.launch.serve import seeded_model

    counters = _counters()
    for arch in list_vision_configs():
        if arch == ARCH:
            continue
        cfg = get_vision_config(arch)
        backends = ["torch", "cuda"]
        if cfg.residual == "iand":
            backends += ["torch+packed", "cuda+packed"]
        else:
            log(f"{arch}: residual={cfg.residual!r}, so no packed plan (the ADD "
                "residual sums spike trains into non-binary tensors)")
        logits = {}
        for backend in backends:
            plan, images = seeded_model(arch, num_requests=2, backend=backend, seed=1,
                                        device=dev)
            before = {k: f.launches for k, f in counters.items()}
            logits[backend] = engine.apply(plan, images)
            torch.cuda.synchronize(dev)
            grown = {k: f.launches - before[k] for k, f in counters.items()}
            want = _per_forward(cfg.num_layers, packed="packed" in backend)
            if backend.startswith("cuda") and grown != want:
                fail(f"{arch} {backend}: launches {grown}, expected {want}")
        for kernels, plain in (("cuda", "torch"), ("cuda+packed", "torch+packed")):
            if kernels in logits:
                _check_logits(f"{arch} {kernels} vs {plain} {tuple(logits[kernels].shape)}",
                              logits[kernels], logits[plain])
        if "cuda+packed" in logits:
            diff = (logits["cuda+packed"] - logits["cuda"]).abs().max().item()
            log(f"{arch}: cuda+packed vs cuda max abs diff {diff:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: this smoke test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[chip_smoke] no src/repro_torch beside {Path(__file__).name}: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()

    log("phase 1: card and build")
    smi = phase_card_and_build()
    log("phase 2: kernels vs plain at the spike-iand-former-8-384 main path's shapes")
    reports = phase_kernels(dev, torch.Generator().manual_seed(0))
    log(f"phase 3: serve {ARCH} on backend=cuda and on backend=cuda+packed, "
        f"{REQUESTS // SLOTS} slot batches of {SLOTS} each")
    launches, forwards = phase_model(dev, smi)
    log("phase 4: the other vision configs at full size, 2 images each")
    phase_other_configs(dev)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    for key, rep in reports.items():
        rep.entry["launches"] = launches[key]
        rep.entry["launches_per_forward"] = launches[key] / forwards[key]
    print(smi)
    print(json.dumps({"kernels": [r.entry for r in reports.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
