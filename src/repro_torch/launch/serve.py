"""Serving (PyTorch port): the generic LM's greedy server, and through the
deploy engine vision slot batches and the spiking LM in synchronous slots or
continuously batched.

With no mode flag the CLI runs :func:`serve`, the JAX package's generic
prompt-fed greedy server over ``models.transformer`` (any text arch of
``repro_torch.configs``; default ``llama3.2-1b_smoke``, 8 requests, prompt
32, 16 new tokens, 4 slots), its prompt feed and generation timed apart:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b_smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b

``--vision`` compiles the Spike-(IAND-)Former into a folded/fused deploy
plan once at startup -- BN folded into the weight reads, AND-NOT residuals
fused into the LIF epilogues, the CUDA kernels or the plain PyTorch versions
as the plan's backend -- then classifies synchronous slot batches of images.
Throughput is timed after one warm-up forward at the slot-batch shape (the
first forward also builds the kernels), as the JAX launcher times it after
compilation.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --vision \
        --arch spike-iand-former-8-384 --requests 24 --slots 8 --backend cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --vision \
        --arch spike-iand-former_smoke --backend torch --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --vision \
        --arch spike-iand-former_smoke --backend cuda+packed --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --vision \
        --arch spike-iand-former_smoke --backend cuda+packed+sparse --device cpu

``--backend`` ``torch+packed`` / ``cuda+packed`` carry the spikes between
layers bit-packed along time (``repro_torch.core.packing``);
``torch+packed+sparse`` / ``cuda+packed+sparse`` also skip all-zero word
tiles and dead bitplanes, located by the occupancy maps the LIF pack
epilogues attach (the logits are those of the packed plan).

``--spiking-lm --continuous`` serves the same plan with continuous batching
(``launch.scheduler``): a bounded admission queue, each admitted prompt
prefilled alone and its ``DecodeState`` paged into a freed slot of one live
batched state, finished requests retired mid-flight; ``--prompt-lens``,
``--max-new-spread``, ``--max-pending`` and ``--prefill-chunk`` shape the
workload and the admission.

    PYTHONPATH=src python -m repro_torch.launch.serve --spiking-lm --continuous \
        --arch llama3.2-1b_smoke --device cpu --prompt-lens 4,6,9 \
        --max-new-spread 4 --slots 2

``--spiking-lm`` greedy-decodes synchronous slot batches of prompts from a
compiled LM deploy plan of ``spiking_lm_config(--arch)`` (RMSNorm gains
folded into the GEMM weights, the embedding norm into the table, causal SSA
on the plan's backend, ``--ordering quadratic|linear``).  Decode is
incremental: one prefill scores a slot batch's prompts and initialises the
O(d^2)-per-head ``DecodeState``, then one ``decode_step`` per new token, at
a cost flat in context length.  The weights are drawn from a seeded
``torch.Generator`` on the plan's device, the prompts by ``token_batch``.

    PYTHONPATH=src python -m repro_torch.launch.serve --spiking-lm \
        --arch llama3.2-1b --backend cuda+packed
    PYTHONPATH=src python -m repro_torch.launch.serve --spiking-lm \
        --arch llama3.2-1b_smoke --requests 3 --prompt-len 8 --max-new 4 \
        --slots 2 --backend torch --device cpu

``--mesh DxM`` serves from a mesh-sharded plan (``compile_plan(mesh=)``) on
every rank of a ``torch.distributed`` world started by ``torchrun`` (gloo;
on the card all ranks share it): slot batches fan out over the data axis,
heads (vision: every unit's columns) shard over the model axis, and under a
packed backend every cross-rank spike edge moves int32 bitplane words.  The
shape is elastic: a world smaller than the mesh shrinks the data axis and
the slot count proportionally (``fault_tolerance.plan_remesh``), and only
rank 0 prints.

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --spiking-lm \
        --arch llama3.2-1b_smoke --backend torch+packed --mesh 2x2 --requests 4 \
        --prompt-len 8 --max-new 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import engine
from repro_torch.configs.spike_iand_former import get_vision_config
from repro_torch.core import spikformer as sf
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.engine.plan import resolve_device
from repro_torch.launch.mesh import world
from repro_torch.launch.scheduler import ContinuousScheduler, Request
from repro_torch.launch.scheduler import greedy as greedy_sample
from repro_torch.models import lm, transformer as T
from repro_torch.models.lm import get_config


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_mesh(spec):
    """``--mesh dxm`` -> (data, model), e.g. "2x1" -> (2, 1)."""
    if spec is None or isinstance(spec, tuple):
        return spec
    d, m = (int(s) for s in spec.lower().split("x"))
    return (d, m)


def _elastic_mesh(shape, slots: int, *, verbose: bool = True):
    """The serving mesh that fits the live fleet (the ranks of the world):
    ``distributed.fault_tolerance.plan_remesh`` shrinks the data axis and
    the slot count proportionally when the fleet is short (capacity
    degrades, the service stays up); only a fleet too small for one model
    group falls back to single-rank serving.  Returns (shape, slots)."""
    from repro_torch.distributed.fault_tolerance import plan_remesh

    fleet, _ = world()
    plan = plan_remesh(tuple(shape), fleet, slots)
    if plan.action == "continue":
        return tuple(shape), slots
    if plan.action == "remesh":
        if verbose:
            print(f"[serve] mesh {tuple(shape)} needs {shape[0] * shape[1]} ranks, have "
                  f"{fleet}: degrading to {plan.new_shape} ({plan.new_global_batch} slots) "
                  "-- capacity shrinks, service stays up")
        return plan.new_shape, max(1, plan.new_global_batch)
    if verbose:
        print(f"[serve] mesh {tuple(shape)} infeasible on {fleet} rank(s) (the model axis "
              "alone does not fit): falling back to single-rank serving")
    return (1, 1), slots


def _resolve_mesh(mesh, slots: int, verbose: bool):
    """(mesh shape or None, slots) for a serving call's ``mesh`` argument."""
    mesh = parse_mesh(mesh)
    if mesh is None:
        return None, slots
    return _elastic_mesh(mesh, slots, verbose=verbose)


def _data_par(plan) -> int:
    """The data-parallel degree a plan's batches shard over (1 unsharded)."""
    meta = plan.meta
    return 1 if meta.sharding is None else meta.mesh.axis(meta.sharding.data_axis).size


def _where(plan) -> str:
    dev = plan.meta.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    mesh = plan.meta.mesh
    if mesh is not None:
        where += f", {'x'.join(str(n) for n in mesh.shape)} mesh of {world()[0]} rank(s)"
    return where


def seeded_model(arch: str, *, num_requests: int, backend: str = "cuda",
                 device=None, seed: int = 0, mesh=None):
    """(plan, images) for a vision config: the plan compiled from random
    weights drawn by ``sf.init`` from ``torch.Generator().manual_seed(seed)``,
    and ``num_requests`` images in [0, 1) drawn next from the same generator,
    so one seed gives the same model and inputs whatever the backend (and
    ``mesh``, passed to ``compile_plan``)."""
    dev = resolve_device(device)
    cfg = get_vision_config(arch)
    gen = torch.Generator().manual_seed(seed)
    params, state = sf.init(gen, cfg)
    images = torch.rand((num_requests, cfg.img_size, cfg.img_size, cfg.in_channels),
                        generator=gen)
    plan = engine.compile_plan(params, state, cfg, backend=backend, device=dev, mesh=mesh)
    return plan, images.to(dev)


def _perturb_bn(tree, rng):
    """Every BatchNorm leaf of a (params or state) tree perturbed as the
    reference's engine tests perturb it (``tests/test_engine.py::_perturb_bn``):
    mean + N(0, 0.2), var x U(0.5, 1.5), scale x U(0.7, 1.3), bias + N(0, 0.2),
    drawn from ``rng`` in the tree's insertion order."""
    if isinstance(tree, dict):
        return {k: (_perturb_bn(v, rng) if isinstance(v, dict) else _perturb_leaf(k, v, rng))
                for k, v in tree.items()}
    return tree


def _perturb_leaf(name, leaf, rng):
    a = leaf.cpu().numpy()
    noise = {"mean": lambda: a + rng.normal(0, 0.2, a.shape),
             "var": lambda: a * rng.uniform(0.5, 1.5, a.shape),
             "scale": lambda: a * rng.uniform(0.7, 1.3, a.shape),
             "bias": lambda: a + rng.normal(0, 0.2, a.shape)}.get(name)
    return leaf if noise is None else torch.from_numpy(noise().astype(a.dtype))


def live_model(arch: str, num_requests: int, backend: str, device=None, seed: int = 0,
               mesh=None):
    """(plan, images) of a model whose blocks fire: the parameters of
    ``sf.init(torch.Generator().manual_seed(seed), cfg)`` with every BN leaf
    perturbed (``_perturb_bn``, drawn from ``np.random.default_rng(seed + 1)``,
    params then state), compiled with ``engine.compile_plan``; the images are
    drawn next from the same generator, as ``seeded_model`` draws them.  With
    fresh BN (mean 0, var 1, scale 1, bias 0) the seeded model's block LIFs
    never fire.  ``mesh`` is passed to ``compile_plan``."""
    cfg = get_vision_config(arch)
    gen = torch.Generator().manual_seed(seed)
    params, state = sf.init(gen, cfg)
    images = torch.rand((num_requests, cfg.img_size, cfg.img_size, cfg.in_channels),
                        generator=gen)
    rng = np.random.default_rng(seed + 1)
    params = _perturb_bn(params, rng)
    state = _perturb_bn(state, rng)
    dev = resolve_device(device)
    plan = engine.compile_plan(params, state, cfg, backend=backend, device=dev, mesh=mesh)
    return plan, images.to(dev)


def serve_plan(plan, images: torch.Tensor, *, slots: int = 4, verbose: bool = True) -> dict:
    """Classify ``images`` (on the plan's device) in slot batches of
    ``slots`` through ``plan``: one warm-up forward at the slot-batch shape
    (it also builds the kernels), then the timed loop.  On a sharded plan
    every rank calls it alike, and each slot batch is padded to a multiple
    of the data degree (the padded rows' logits are dropped).

    Returns a dict with ``classes`` (per-request argmax), ``logits`` (on the
    host), ``forwards`` (forward passes run, warm-up included), ``seconds``
    (served loop, host clock, each batch ending in its host copy) and
    ``img_per_s``.
    """
    dev = plan.meta.device
    step = engine.make_apply_fn(plan)
    num_requests = images.shape[0]
    data_par = _data_par(plan)

    with torch.inference_mode():
        step(plan.params, _pad_batch(images[:slots], data_par)[0])   # warm-up: builds the kernels
        _sync(dev)
        forwards, logits = 1, []
        t0 = time.perf_counter()
        for start in range(0, num_requests, slots):
            batch, b = _pad_batch(images[start:start + slots], data_par)
            out = step(plan.params, batch)[:b]
            forwards += 1
            logits.append(out.cpu())               # the host copy syncs the batch
            if verbose:
                print(f"[serve] slot batch {start // slots}: classified "
                      f"{out.shape[0]} images")
        dt = time.perf_counter() - t0
    logits = torch.cat(logits)
    stats = {"classes": logits.argmax(dim=-1).tolist(), "logits": logits,
             "forwards": forwards, "seconds": dt, "img_per_s": num_requests / dt}
    if verbose:
        ps = engine.plan_stats(plan)
        where = _where(plan)
        spikes = ", packed spikes" if ps["packed"] else ""
        spikes += ", sparse skipping" if ps["sparse"] else ""
        print(f"[serve] {num_requests} images in {dt:.4f}s "
              f"({stats['img_per_s']:.1f} img/s, {1e3 * dt * slots / num_requests:.2f} "
              f"ms per slot batch of {slots} on {where}; deploy plan: "
              f"{ps['folded_conv_bn'] + ps['folded_linear_bn']} folded BN pairs, "
              f"{ps['fused_lif_iand_dispatches']} fused LIF+IAND dispatches, "
              f"backend={ps['backend']}{spikes})")
    return stats


def serve_vision(arch: str, *, num_requests: int, slots: int = 4,
                 backend: str = "cuda", mesh=None, device=None, seed: int = 0,
                 verbose: bool = True) -> dict:
    """Serve ``num_requests`` random images of a vision config in slot
    batches of ``slots`` through the plan of :func:`seeded_model`
    (:func:`serve_plan` says what the result holds).  ``mesh`` ("dxm" or
    (data, model)) compiles a mesh-sharded plan and fans the slot batches
    over the data axis, degrading elastically (:func:`_elastic_mesh`) on a
    world too small for it."""
    mesh, slots = _resolve_mesh(mesh, slots, verbose)
    plan, images = seeded_model(arch, num_requests=num_requests, backend=backend,
                                device=device, seed=seed, mesh=mesh)
    return serve_plan(plan, images, slots=slots, verbose=verbose)


# -- the generic LM --------------------------------------------------------------

def serve_batch(serve_step, params, cfg, prompts: torch.Tensor, max_new: int):
    """Greedy-decode one slot batch of ``prompts`` (B, S) on their device as
    the JAX package's ``serve`` does: a decode cache of ``S + max_new``
    slots, the prompt fed token by token through ``serve_step`` (one code
    path for prompt and generation), then ``max_new`` greedy tokens, the
    first drawn from the last prompt position.  The prompt feed and the
    generation are timed apart, the device synchronised before each clock
    read.  Returns (tokens (B, max_new), the logits after the prompt
    (B, V), prompt seconds, generation seconds)."""
    dev = prompts.device
    b, prompt_len = prompts.shape
    cache = T.cache_init(cfg, b, prompt_len + max_new, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        logits, cache = serve_step(params, cache, {"token": prompts[:, t:t + 1]}, t)
    _sync(dev)
    t1 = time.perf_counter()
    after_prompt = logits[:, -1]
    tok = greedy_sample(after_prompt)
    outs = [tok]
    for i in range(max_new - 1):
        logits, cache = serve_step(params, cache, {"token": tok[:, None]}, prompt_len + i)
        tok = greedy_sample(logits[:, -1])
        outs.append(tok)
    gen = torch.stack(outs, dim=1)
    _sync(dev)
    return gen, after_prompt, t1 - t0, time.perf_counter() - t1


def serve(arch: str, *, num_requests: int, prompt_len: int, max_new: int, slots: int = 4,
          seed: int = 0, verbose: bool = True, return_stats: bool = False, device=None):
    """The JAX package's generic prompt-fed greedy server: ``arch``'s
    parameters from ``init_lm(seed)`` on the device (the card unless
    ``device="cpu"``), ``num_requests`` prompts of ``prompt_len`` tokens from
    ``token_batch`` at ``seed``, step 0, served in synchronous slot batches
    of ``slots`` by :func:`serve_batch`, after one warm-up step per batch
    size.  Returns ``done`` (request, its ``max_new`` tokens) pairs in order,
    and with ``return_stats`` also the JAX package's ``stats`` (prompt feed
    and generation timed apart)."""
    cfg = get_config(arch)
    assert cfg.modality == "text", "serving demo targets text archs"
    dev = resolve_device(device)
    params = T.init_lm(seed, cfg, device=dev)
    serve_step = lm.make_serve_step(cfg)
    dcfg = DataConfig(seed=seed, vocab_size=cfg.vocab_size, seq_len=prompt_len,
                      global_batch=num_requests)
    prompts = torch.from_numpy(make_batch(dcfg, 0)["tokens"]).to(dev)

    for b in _warm_sizes(slots, num_requests):
        serve_step(params, T.cache_init(cfg, b, prompt_len + max_new, device=dev),
                   {"token": torch.zeros((b, 1), dtype=torch.long, device=dev)}, 0)
    _sync(dev)

    done, prefill_s, decode_s = [], 0.0, 0.0
    for start in range(0, num_requests, slots):
        gen, _, t_prompt, t_gen = serve_batch(serve_step, params, cfg,
                                              prompts[start:start + slots], max_new)
        prefill_s += t_prompt
        decode_s += t_gen
        gen = gen.cpu().numpy()
        done += [(start + j, gen[j]) for j in range(gen.shape[0])]
        if verbose:
            print(f"[serve] slot batch {start // slots}: generated {gen.shape[0]}x{max_new} tokens")
    tot = num_requests * max_new
    fed = num_requests * prompt_len
    stats = {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "prompt_tokens": fed,
        "new_tokens": tot,
        "prefill_tokens_per_s": fed / prefill_s if prefill_s else float("inf"),
        "decode_tokens_per_s": tot / decode_s if decode_s else float("inf"),
    }
    if verbose:
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"[serve] {num_requests} requests on {where}: prefill {fed} prompt tokens in "
              f"{prefill_s:.2f}s ({stats['prefill_tokens_per_s']:.1f} tok/s), decode {tot} new "
              f"tokens in {decode_s:.2f}s ({stats['decode_tokens_per_s']:.1f} tok/s)")
    if return_stats:
        return done, stats
    return done


# -- spiking LM -----------------------------------------------------------------

def spiking_lm_config(arch: str):
    """Spiking deploy flavour of a text arch config, as the JAX package adapts
    it: T = 4 time steps and 4 heads sized for binary spike trains (the
    llama3.2-1b width: Dh = 2048 / 4 = 512)."""
    cfg = get_config(arch)
    if cfg.modality != "text":
        raise ValueError(f"spiking-LM serving targets text archs; {arch} is {cfg.modality}")
    return cfg.replace(spiking=True, spike_t=4, num_heads=4, head_dim=None)


def _pad_batch(x: torch.Tensor, mult: int):
    """Pad the leading (request) axis to a multiple of ``mult`` (the data
    degree of a sharded plan) by repeating the last row; returns (padded,
    true_size).  The padded rows are dead weight, dropped from the outputs."""
    b = x.shape[0]
    r = (-b) % mult
    if r:
        x = torch.cat([x, x[-1:].expand((r,) + tuple(x.shape[1:]))], dim=0)
    return x, b


def _warm_sizes(slots: int, num_requests: int) -> set[int]:
    """Every batch size the slot loop will see: the full slot batch and the
    ragged last one."""
    sizes = {min(slots, num_requests)}
    if num_requests % slots:
        sizes.add(num_requests % slots)
    return sizes


def _warm_padded_sizes(slots: int, num_requests: int, data_par: int = 1) -> set[int]:
    """The batch sizes that actually run: :func:`_warm_sizes` padded to the
    data degree (two ragged sizes that pad alike warm once)."""
    return {b + ((-b) % data_par) for b in _warm_sizes(slots, num_requests)}


def _compile_lm_serving(arch: str, *, backend, ordering, mesh, seed, device):
    """The setup of spiking-LM serving: config, weights drawn from
    ``torch.Generator(device).manual_seed(seed)`` on the plan's device, and
    the one plan compile (``mesh`` as resolved by :func:`_elastic_mesh`) --
    returns (cfg, plan).  The weights are dropped when this returns; the
    plan keeps its folded copies."""
    from repro_torch.models import spiking_lm as slm

    dev = resolve_device(device)
    cfg = spiking_lm_config(arch)
    params = slm.init_spiking_lm(torch.Generator(dev).manual_seed(seed), cfg)
    plan = engine.compile_plan(params, None, cfg, backend=backend, ordering=ordering,
                               device=dev, mesh=mesh)
    return cfg, plan


# The seeded LM's AND-NOT residual loses about half its spikes at each of its
# 2L joins (a branch LIF fires on some 30-50% of a row that still spikes), so
# at llama3.2-1b depth the stream falls silent before the last blocks (at
# d_model 1024 on the CPU, from block 13 on).  live_lm_params keeps every
# block firing, for the checks that need it: the RMSNorm gains of the two
# units that feed the joins (proj, fc2) are LIVE_BRANCH_GAIN, so their LIFs
# fire less and each join removes fewer spikes.
LIVE_BRANCH_GAIN = 0.5


def live_lm_params(cfg, device=None, seed: int = 0):
    """The parameters of ``init_spiking_lm(torch.Generator(device).manual_seed(
    seed), cfg)`` with the proj and fc2 RMSNorm gains of every block set to
    :data:`LIVE_BRANCH_GAIN`: a spiking LM whose residual stream, and so every
    block, still fires at full depth."""
    from repro_torch.models import spiking_lm as slm

    params = slm.init_spiking_lm(torch.Generator(resolve_device(device)).manual_seed(seed), cfg)
    for unit in ("proj", "fc2"):
        params["layers"][unit]["norm"]["scale"].fill_(LIVE_BRANCH_GAIN)
    return params


class _Marks:
    """Time marks on the plan's device: CUDA events on the card (read after a
    synchronise), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def serve_lm_plan(plan, prompts, *, slots: int = 4, max_new: int = 16,
                  verbose: bool = True) -> dict:
    """Greedy-decode ``prompts`` (N, S) through an LM ``plan`` in synchronous
    slot batches of ``slots``: per batch one prefill, whose last position
    gives the first new token, then ``max_new - 1`` decode steps.  One
    warm-up prefill and step per batch size come first (they also build the
    kernels).  On a sharded plan every rank calls it alike, and each slot
    batch is padded to a multiple of the data degree (padded rows dropped).

    Returns a dict: ``done`` (the JAX package's result: (request, its
    ``max_new`` tokens) pairs in order), ``tokens`` (N, max_new) and
    ``logits`` (N, max_new, V), the logits each token was drawn from, on the
    host; ``prefills`` and ``steps`` run (warm-up included); ``prefill_ms``
    and ``step_ms``, each served prefill's and step's time on the device
    (CUDA events; the host clock on the CPU); ``seconds``, the served loop
    on the host clock, and ``tok_per_s``, new tokens over it."""
    dev = plan.meta.device
    prefill = engine.make_prefill_fn(plan)
    step = engine.make_decode_step_fn(plan)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long).to(dev)
    num_requests, prompt_len = prompts.shape
    data_par = _data_par(plan)
    out = {"done": [], "prefills": 0, "steps": 0, "prefill_ms": [], "step_ms": []}
    tokens, logits_kept = [], []
    with torch.inference_mode():
        for bp in sorted(_warm_padded_sizes(slots, num_requests, data_par)):
            _, st = prefill(plan.params, torch.zeros((bp, prompt_len), dtype=torch.long,
                                                     device=dev))
            step(plan.params, st, torch.zeros((bp,), dtype=torch.long, device=dev))
            out["prefills"] += 1
            out["steps"] += 1
        _sync(dev)
        t0 = time.perf_counter()
        for start in range(0, num_requests, slots):
            seq, b = _pad_batch(prompts[start:start + slots], data_par)
            marks = _Marks(dev)
            marks.mark()
            logits, state = prefill(plan.params, seq)
            marks.mark()
            drawn = [logits[:, -1]]
            tok = greedy_sample(drawn[0])
            outs = [tok]
            for _ in range(max_new - 1):
                logits, state = step(plan.params, state, tok)
                marks.mark()
                drawn.append(logits)
                tok = greedy_sample(logits)
                outs.append(tok)
            out["prefills"] += 1
            out["steps"] += max_new - 1
            gen = torch.stack(outs, dim=1)[:b].cpu()      # the host copy syncs the batch
            ms = marks.intervals_ms()
            out["prefill_ms"].append(ms[0])
            out["step_ms"] += ms[1:]
            tokens.append(gen)
            logits_kept.append(torch.stack(drawn, dim=1)[:b].cpu())
            out["done"] += [(start + j, gen[j].numpy()) for j in range(gen.shape[0])]
            if verbose:
                print(f"[serve] slot batch {start // slots}: generated "
                      f"{gen.shape[0]}x{max_new} tokens")
        out["seconds"] = time.perf_counter() - t0
    out["tokens"], out["logits"] = torch.cat(tokens), torch.cat(logits_kept)
    out["tok_per_s"] = num_requests * max_new / out["seconds"]
    if verbose:
        ps = engine.plan_stats(plan)
        where = _where(plan)
        spikes = ", packed spikes" if ps["packed"] else ""
        spikes += ", sparse skipping" if ps["sparse"] else ""
        steps = out["step_ms"]
        print(f"[serve] {num_requests} requests, {num_requests * max_new} new tokens in "
              f"{out['seconds']:.3f}s ({out['tok_per_s']:.1f} tok/s on {where}; prefill "
              f"{sum(out['prefill_ms']) / len(out['prefill_ms']):.2f} ms, step "
              f"{sum(steps) / max(len(steps), 1):.2f} ms; LM plan: "
              f"{ps['folded_linear_rmsnorm']} folded Linear+RMSNorm units, "
              f"{ps['fused_lif_iand_dispatches']} fused LIF+IAND dispatches, "
              f"ordering={ps['attn_ordering']}, backend={ps['backend']}{spikes}; "
              f"prefill+step decode, {ps['decode_state_bytes']} B state/seq, flat in "
              "context)")
    return out


def serve_spiking_lm(arch: str, *, num_requests: int, prompt_len: int, max_new: int,
                     slots: int = 4, backend: str = "cuda", ordering: str = "quadratic",
                     mesh=None, seed: int = 0, device=None, verbose: bool = True) -> dict:
    """Serve ``spiking_lm_config(arch)`` from a compiled deploy plan, greedy
    decode: the JAX package's arguments, on the card unless ``device="cpu"``.
    The weights come from ``seed`` (see :func:`_compile_lm_serving`), the
    ``num_requests`` prompts of ``prompt_len`` tokens from ``token_batch`` at
    ``seed``, step 0, as in the JAX package; :func:`serve_lm_plan` says what
    the result holds (its ``done`` is the JAX function's result).  ``mesh``
    serves from a mesh-sharded plan on every rank of the world
    (:func:`_elastic_mesh`)."""
    mesh, slots = _resolve_mesh(mesh, slots, verbose)
    cfg, plan = _compile_lm_serving(arch, backend=backend, ordering=ordering, mesh=mesh,
                                    seed=seed, device=device)
    dcfg = DataConfig(seed=seed, vocab_size=cfg.vocab_size, seq_len=prompt_len,
                      global_batch=num_requests)
    prompts = make_batch(dcfg, 0)["tokens"]
    return serve_lm_plan(plan, prompts, slots=slots, max_new=max_new, verbose=verbose)


def serving_requests(prompts, *, prompt_lens, max_new, max_new_spread: int = 0,
                     eos_id: int | None = None):
    """Request list for continuous serving from an (N, S_max) prompt batch:
    request ``i`` takes the first ``prompt_lens[i % len(prompt_lens)]`` tokens
    of row ``i`` (mixed prompt lengths) and decodes
    ``max_new - (i % (max_new_spread + 1))`` tokens (ragged completion; spread
    0 is uniform).  Deterministic, so a reference path can rebuild the same
    workload."""
    prompts = np.asarray(prompts)
    lens = [int(s) for s in prompt_lens]
    return [Request(rid=i, prompt=prompts[i, :lens[i % len(lens)]].astype(np.int64),
                    max_new=max(1, max_new - (i % (max_new_spread + 1))), eos_id=eos_id)
            for i in range(prompts.shape[0])]


def serve_continuous_plan(plan, requests, *, slots: int = 4, max_pending: int | None = None,
                          prefill_chunk: int | None = None, verbose: bool = True):
    """Serve ``requests`` (:class:`repro_torch.launch.scheduler.Request`) through
    an LM ``plan`` with a ``ContinuousScheduler``, closed loop: every prompt
    length (or chunk bucket) and the step are warmed first (on the card this
    also builds the kernels), then the timed run.

    Returns ``(done, stats)``: ``done`` the JAX package's result, (request id,
    its tokens as an int64 array) per completed request in completion order;
    ``stats`` the scheduler's ``stats()`` plus ``wall_s`` (the served run on
    the host clock), ``warm_prefill_shapes``, ``warm_step_shapes``,
    ``stall_s`` (the admission work of each tick that admitted) and
    ``requests`` (the completed ``Request`` records, with their times)."""
    requests = list(requests)
    dev = plan.meta.device
    sched = ContinuousScheduler(
        plan, slots=slots,
        max_pending=max_pending if max_pending is not None else max(len(requests), 1),
        prefill_chunk=prefill_chunk)
    warmed = sched.warm(sorted({r.prompt_len for r in requests}))
    _sync(dev)
    t0 = time.perf_counter()
    completed = sched.run(requests)
    dt = time.perf_counter() - t0
    done = [(r.rid, np.asarray(r.tokens, np.int64)) for r in completed]
    stats = sched.stats()
    stats.update(wall_s=dt, warm_prefill_shapes=warmed, warm_step_shapes=1,
                 stall_s=list(sched.stall_s), requests=completed)
    if verbose:
        ps = engine.plan_stats(plan)
        where = _where(plan)
        spikes = ", packed spikes" if ps["packed"] else ""
        spikes += ", sparse skipping" if ps["sparse"] else ""
        print(f"[serve] continuous: {len(completed)}/{len(requests)} requests, "
              f"{stats['new_tokens']} new tokens in {dt:.3f}s "
              f"({stats['new_tokens'] / dt:.1f} tok/s on {where}; {stats['steps']} steps at "
              f"{slots} slots, occupancy {stats['slot_occupancy']:.2f}, queue high-water "
              f"{stats['queue_high_water']}, {warmed} prefill shape(s) + 1 step shape; "
              f"backend={ps['backend']}{spikes}, ordering={ps['attn_ordering']})")
    return done, stats


def serve_spiking_lm_continuous(arch: str, *, num_requests: int, prompt_len: int,
                                max_new: int, slots: int = 4, backend: str = "cuda",
                                ordering: str = "quadratic", mesh=None, seed: int = 0,
                                prompt_lens=None, max_new_spread: int = 0,
                                max_pending: int | None = None,
                                prefill_chunk: int | None = None, device=None,
                                verbose: bool = True, return_stats: bool = False):
    """Serve ``spiking_lm_config(arch)`` with continuous batching (greedy
    decode): the JAX package's arguments, on the card unless
    ``device="cpu"``; ``mesh`` serves from a mesh-sharded plan on every rank
    of the world (slots a multiple of its data degree, :func:`_elastic_mesh`).

    The plan, weights and sampler are :func:`serve_spiking_lm`'s; only the
    scheduling differs: a ``ContinuousScheduler`` pages each admitted
    prompt's ``DecodeState`` into a freed slot of one live batched state and
    retires finished sequences mid-flight (:func:`serve_continuous_plan`).
    ``prompt_lens`` (default ``[prompt_len]``) cycles mixed prompt lengths
    over the requests, as the multiset given (repeats keep their share;
    only warming dedupes); the prompts are ``token_batch`` rows at ``seed``,
    step 0, of the longest length.  ``max_new_spread`` staggers the
    per-request decode lengths (ragged completion).  ``prefill_chunk``
    admits by decode-interleaved chunked prefill.  Returns the list of
    (request id, tokens), and with ``return_stats`` the stats too."""
    mesh, slots = _resolve_mesh(mesh, slots, verbose)
    cfg, plan = _compile_lm_serving(arch, backend=backend, ordering=ordering, mesh=mesh,
                                    seed=seed, device=device)
    # the requested mixture as given: a set here would turn "32,32,64" (2:1)
    # into a 1:1 cycle
    lens = [int(s) for s in (prompt_lens or [prompt_len])]
    dcfg = DataConfig(seed=seed, vocab_size=cfg.vocab_size, seq_len=max(lens),
                      global_batch=num_requests)
    prompts = make_batch(dcfg, 0)["tokens"]
    reqs = serving_requests(prompts, prompt_lens=lens, max_new=max_new,
                            max_new_spread=max_new_spread)
    done, stats = serve_continuous_plan(plan, reqs, slots=slots, max_pending=max_pending,
                                        prefill_chunk=prefill_chunk, verbose=verbose)
    return (done, stats) if return_stats else done


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--vision", action="store_true",
                      help="serve a vision Spikformer via the deploy engine")
    mode.add_argument("--spiking-lm", action="store_true",
                      help="greedy-decode a spiking LM from a compiled deploy plan")
    ap.add_argument("--arch", default=None,
                    help="default: llama3.2-1b_smoke (no mode flag: the generic LM), "
                         "spike-iand-former-8-384 (--vision), llama3.2-1b (--spiking-lm)")
    ap.add_argument("--requests", type=int, default=None,
                    help="default: 8 (the generic LM, --spiking-lm), 24 (--vision)")
    ap.add_argument("--slots", type=int, default=None,
                    help="default: 4 (the generic LM, --spiking-lm), 8 (--vision)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ordering", default="quadratic", choices=["quadratic", "linear"],
                    help="causal-SSA dataflow of the LM plan")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching decode service (--spiking-lm): admission "
                         "queue with backpressure, per-slot DecodeState paging, ragged "
                         "completion and eviction; one step shape per slot count")
    ap.add_argument("--prompt-lens", default=None, metavar="L1,L2,...",
                    help="mixed prompt lengths for --continuous (cycled over the "
                         "requests; default: --prompt-len)")
    ap.add_argument("--max-new-spread", type=int, default=0,
                    help="stagger per-request decode lengths by up to this many tokens "
                         "(--continuous: ragged completion)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission-queue bound for --continuous (backpressure; "
                         "default: the request count)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="C",
                    help="decode-interleaved chunked admission for --continuous: one "
                         "resumable C-token prefill chunk per scheduler tick (default: "
                         "one-shot prefill)")
    ap.add_argument("--backend", default="cuda",
                    choices=["torch", "cuda", "torch+packed", "cuda+packed",
                             "torch+packed+sparse", "cuda+packed+sparse"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the host)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve from a mesh-sharded plan, e.g. 2x1 (data-parallel fan-out) "
                         "or 2x2 (+ tensor-parallel heads), on the ranks of a torchrun "
                         "world (gloo); packed backends move int32 spike words between "
                         "ranks, and a short world degrades capacity instead of failing")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group("gloo")          # torchrun's env:// rendezvous
    verbose = world()[1] == 0                    # rank 0 prints
    try:
        _main(args, verbose)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args, verbose: bool) -> None:
    if args.spiking_lm and args.continuous:
        lens = [int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens else None
        serve_spiking_lm_continuous(
            args.arch or "llama3.2-1b", num_requests=args.requests or 8,
            prompt_len=args.prompt_len, max_new=args.max_new, slots=args.slots or 4,
            backend=args.backend, ordering=args.ordering, seed=args.seed, prompt_lens=lens,
            max_new_spread=args.max_new_spread, max_pending=args.max_pending,
            prefill_chunk=args.prefill_chunk, mesh=args.mesh, device=args.device,
            verbose=verbose)
        return
    if args.spiking_lm:
        serve_spiking_lm(args.arch or "llama3.2-1b", num_requests=args.requests or 8,
                         prompt_len=args.prompt_len, max_new=args.max_new,
                         slots=args.slots or 4, backend=args.backend, ordering=args.ordering,
                         mesh=args.mesh, seed=args.seed, device=args.device, verbose=verbose)
        return
    if args.vision:
        serve_vision(args.arch or "spike-iand-former-8-384", num_requests=args.requests or 24,
                     slots=args.slots or 8, backend=args.backend, mesh=args.mesh,
                     device=args.device, seed=args.seed, verbose=verbose)
        return
    serve(args.arch or "llama3.2-1b_smoke", num_requests=args.requests or 8,
          prompt_len=args.prompt_len, max_new=args.max_new, slots=args.slots or 4,
          seed=args.seed, device=args.device, verbose=verbose)


if __name__ == "__main__":
    main()
