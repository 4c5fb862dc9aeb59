"""Vision serving through the deploy engine (PyTorch port).

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
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import engine
from repro_torch.configs.spike_iand_former import get_vision_config
from repro_torch.core import spikformer as sf
from repro_torch.engine.plan import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded_model(arch: str, *, num_requests: int, backend: str = "cuda",
                 device=None, seed: int = 0):
    """(plan, images) for a vision config: the plan compiled from random
    weights drawn by ``sf.init`` from ``torch.Generator().manual_seed(seed)``,
    and ``num_requests`` images in [0, 1) drawn next from the same generator,
    so one seed gives the same model and inputs whatever the backend."""
    dev = resolve_device(device)
    cfg = get_vision_config(arch)
    gen = torch.Generator().manual_seed(seed)
    params, state = sf.init(gen, cfg)
    images = torch.rand((num_requests, cfg.img_size, cfg.img_size, cfg.in_channels),
                        generator=gen)
    plan = engine.compile_plan(params, state, cfg, backend=backend, device=dev)
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


def live_model(arch: str, num_requests: int, backend: str, device=None, seed: int = 0):
    """(plan, images) of a model whose blocks fire: the parameters of
    ``sf.init(torch.Generator().manual_seed(seed), cfg)`` with every BN leaf
    perturbed (``_perturb_bn``, drawn from ``np.random.default_rng(seed + 1)``,
    params then state), compiled with ``engine.compile_plan``; the images are
    drawn next from the same generator, as ``seeded_model`` draws them.  With
    fresh BN (mean 0, var 1, scale 1, bias 0) the seeded model's block LIFs
    never fire."""
    cfg = get_vision_config(arch)
    gen = torch.Generator().manual_seed(seed)
    params, state = sf.init(gen, cfg)
    images = torch.rand((num_requests, cfg.img_size, cfg.img_size, cfg.in_channels),
                        generator=gen)
    rng = np.random.default_rng(seed + 1)
    params = _perturb_bn(params, rng)
    state = _perturb_bn(state, rng)
    dev = resolve_device(device)
    plan = engine.compile_plan(params, state, cfg, backend=backend, device=dev)
    return plan, images.to(dev)


def serve_plan(plan, images: torch.Tensor, *, slots: int = 4, verbose: bool = True) -> dict:
    """Classify ``images`` (on the plan's device) in slot batches of
    ``slots`` through ``plan``: one warm-up forward at the slot-batch shape
    (it also builds the kernels), then the timed loop.

    Returns a dict with ``classes`` (per-request argmax), ``logits`` (on the
    host), ``forwards`` (forward passes run, warm-up included), ``seconds``
    (served loop, host clock, each batch ending in its host copy) and
    ``img_per_s``.
    """
    dev = plan.meta.device
    step = engine.make_apply_fn(plan)
    num_requests = images.shape[0]

    with torch.inference_mode():
        step(plan.params, images[:slots])          # warm-up: builds the kernels
        _sync(dev)
        forwards, logits = 1, []
        t0 = time.perf_counter()
        for start in range(0, num_requests, slots):
            out = step(plan.params, images[start:start + slots])
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
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
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
                 backend: str = "cuda", device=None, seed: int = 0,
                 verbose: bool = True) -> dict:
    """Serve ``num_requests`` random images of a vision config in slot
    batches of ``slots`` through the plan of :func:`seeded_model`
    (:func:`serve_plan` says what the result holds)."""
    plan, images = seeded_model(arch, num_requests=num_requests, backend=backend,
                                device=device, seed=seed)
    return serve_plan(plan, images, slots=slots, verbose=verbose)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vision", action="store_true", required=True,
                    help="serve a vision Spikformer via the deploy engine")
    ap.add_argument("--arch", default="spike-iand-former-8-384")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--backend", default="cuda",
                    choices=["torch", "cuda", "torch+packed", "cuda+packed",
                             "torch+packed+sparse", "cuda+packed+sparse"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the host)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    serve_vision(args.arch, num_requests=args.requests, slots=args.slots,
                 backend=args.backend, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
