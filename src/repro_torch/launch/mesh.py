"""Host meshes over a ``torch.distributed`` world, and the collectives of their
axes.

The JAX package runs a sharded plan in one process over the devices of a
``jax.sharding.Mesh``.  The port runs it SPMD: every rank is a process, a
"device" of the mesh is a rank of the default process group, and every rank
calls the same functions with the same arguments.  :func:`make_host_mesh`
lays a ``(data, model)`` mesh over the world with
``torch.distributed.device_mesh.init_device_mesh``; each axis
(:class:`MeshAxis`) carries this rank's place on it and the process group of
the ranks that differ from it along that axis only.

A world larger than the mesh holds several replicas of it (a leading
``replica`` dim of consecutive rank blocks), each computing the same result:
the JAX package leaves the devices past the mesh idle, but here every rank
runs the program and returns its result.  A world smaller than the mesh
shrinks it to the largest feasible shape with a warning
(:func:`feasible_mesh_shape`), as the JAX package does on too few devices,
and a world of one process (``torch.distributed`` not initialised) gives the
trivial mesh.

Transport is gloo, on the CPU and on the card alike (the card host has one
H100, so all ranks share ``cuda:0``, and NCCL refuses two ranks on one
device).  The collectives hand gloo the tensors where they lie: its CUDA path
(taken by the card's torch build, which ``chip_smoke.py`` phase 12 probes)
copies them through host memory itself.
Every collective reports itself -- operation, dtype, shape, group size and
ring wire bytes -- to an active graph recorder
(``engine.analysis.OpRecorder``), as the kernel wrappers report launches.
"""

from __future__ import annotations

import datetime
import math
import pickle
import tempfile
import time
import traceback
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes, _get_current_dispatch_mode_stack

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) when
    ``torch.distributed`` is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def feasible_mesh_shape(shape: tuple[int, ...], n: int) -> tuple[int, ...]:
    """Largest mesh shape elementwise <= ``shape`` whose total fits ``n``
    ranks.

    Axes are capped left to right, so the LEFTMOST axes absorb the shrink
    first -- with ``(data, model)`` ordering that keeps the model axis (its
    degree is dictated by model memory), as
    ``distributed.fault_tolerance.plan_remesh`` does.  E.g. ``(2, 2)`` on 2
    ranks becomes ``(1, 2)``, not ``(1, 1)``.
    """
    if n < 1:
        raise ValueError(f"need at least one device, got n={n}")
    new = list(shape)
    for i in range(len(new)):
        rest = math.prod(new[i + 1:])
        new[i] = max(1, min(new[i], n // max(1, rest)))
    return tuple(new)


def _tiling_shape(shape: tuple[int, ...], n: int) -> tuple[int, ...]:
    """Largest shape elementwise <= ``shape`` whose total divides ``n`` (so
    that whole replicas of the mesh tile the world), preferring the
    rightmost (model) axes, as :func:`feasible_mesh_shape` does."""
    best = None
    for cand in _shapes_below(shape):
        if n % math.prod(cand) == 0:
            key = tuple(reversed(cand))
            if best is None or key > tuple(reversed(best)):
                best = cand
    return best


def _shapes_below(shape):
    if not shape:
        yield ()
        return
    for head in range(1, shape[0] + 1):
        for rest in _shapes_below(shape[1:]):
            yield (head,) + rest


# -- the recorder hook --------------------------------------------------------------

# ring-algorithm wire bytes of one collective within its group, as the JAX
# package's ``analysis.collective_report`` prices them
_WIRE = {
    "all_gather": lambda size, inb, outb: (size - 1) * outb,
    "reduce_scatter": lambda size, inb, outb: (size - 1) * inb,
    "psum": lambda size, inb, outb: 2 * (size - 1) * inb,
    "broadcast": lambda size, inb, outb: (size - 1) * inb,
}


def _report(op: str, axis: "MeshAxis", x: torch.Tensor, out: torch.Tensor, kind: str) -> None:
    if not torch._C._len_torch_dispatch_stack():
        return
    inb, outb = x.numel() * x.element_size(), out.numel() * out.element_size()
    entry = {"primitive": op, "axis": axis.name, "kind": kind,
             "dtype": str(x.dtype).removeprefix("torch."),
             "shape": tuple(int(s) for s in out.shape), "axis_size": axis.size,
             "wire_bytes": int(_WIRE[op](axis.size, inb, outb))}
    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "record_collective", None)
        if record is not None:
            record(entry)


@dataclass(eq=False)
class MeshAxis:
    """One axis of a host mesh as this rank sees it: its ``size``, this
    rank's index ``rank`` on it, and ``group``, the process group of the
    ranks along it (None on a one-process world).  The collectives are the
    identity at size 1 and record nothing there.  ``kind`` labels what a
    collective moves for the recorder: ``"edge"`` for an activation edge of
    the walkers (what ``analysis.collective_report`` holds against the
    pricing), ``"output"`` for a result assembled over the batch shards,
    ``"state"`` for decode state paged between ranks."""

    name: str
    size: int
    rank: int
    group: Any = None

    def _run(self, fn, x: torch.Tensor, out_shape) -> torch.Tensor:
        """Run the collective ``fn(out, x)`` into a new ``out`` beside ``x``,
        out of sight of any dispatch mode (the recorder sees the collective
        as one entry, :func:`_report`)."""
        with _disable_current_modes():
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            fn(out, x.contiguous())
            return out

    def all_gather(self, x: torch.Tensor, dim: int = -1, *, kind: str = "edge") -> torch.Tensor:
        """Tiled all-gather along ``dim``: shard i's block lands at block i,
        the single-device order of that dim."""
        if self.size == 1:
            return x
        xt = x.movedim(dim, 0)

        def run(o, s):
            # the list form: gloo has taken it in every release
            dist.all_gather(list(o.chunk(self.size)), s, group=self.group)

        out = self._run(run, xt, (self.size * xt.shape[0],) + tuple(xt.shape[1:]))
        out = out.movedim(0, dim).contiguous()
        _report("all_gather", self, x, out, kind)
        return out

    def all_reduce(self, x: torch.Tensor, *, kind: str = "edge") -> torch.Tensor:
        """Sum over the axis (a new tensor; ``x`` is left as it was)."""
        if self.size == 1:
            return x

        def run(o, s):
            o.copy_(s)
            dist.all_reduce(o, group=self.group)

        out = self._run(run, x, tuple(x.shape))
        _report("psum", self, x, out, kind)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int = -1, *,
                       kind: str = "edge") -> torch.Tensor:
        """Sum over the axis, each rank keeping its block of ``dim`` (tiled)."""
        if self.size == 1:
            return x
        xt = x.movedim(dim, 0)
        if xt.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: dim of size {xt.shape[0]} does not split "
                             f"over {self.size} ranks")
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        out = self._run(lambda o, s: scatter(o, s, group=self.group), xt,
                        (xt.shape[0] // self.size,) + tuple(xt.shape[1:]))
        out = out.movedim(0, dim).contiguous()
        _report("reduce_scatter", self, x, out, kind)
        return out

    def broadcast(self, x: torch.Tensor, src: int, *, kind: str = "state") -> torch.Tensor:
        """The tensor of the rank at index ``src`` on this axis, on every rank
        of it (``x`` gives the shape and dtype elsewhere)."""
        if self.size == 1:
            return x

        def run(o, s):
            o.copy_(s)
            dist.broadcast(o, src=dist.get_global_rank(self.group, src), group=self.group)

        out = self._run(run, x, tuple(x.shape))
        _report("broadcast", self, x, out, kind)
        return out

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``dim`` (its size must split evenly): the
        inverse of :meth:`all_gather`."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"axis {self.name!r} of size {self.size} must divide the "
                             f"dim of size {n}")
        return x.narrow(dim, self.rank * (n // self.size), n // self.size)


@dataclass(eq=False)
class HostMesh:
    """A mesh over the ranks of the world, as this rank sees it: its
    ``shape`` and ``axis_names`` (the shape actually laid out, after any
    shrink), ``device_mesh`` (the ``DeviceMesh``, None on a one-process
    world) and one :class:`MeshAxis` per name."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device_mesh: Any
    axes: dict

    def axis(self, name: str) -> MeshAxis:
        return self.axes[name]

    def __repr__(self) -> str:
        return f"HostMesh({dict(zip(self.axis_names, self.shape))})"


_MESHES: dict = {}


def make_host_mesh(shape=(1, 1), axes=("data", "model")) -> HostMesh:
    """A host mesh of ``shape`` over the world, every rank calling it alike.

    A world smaller than the mesh shrinks it to the largest feasible shape
    (leftmost/data axes first, :func:`feasible_mesh_shape`) with a warning,
    and a world that whole replicas of the shape do not tile shrinks it to
    the largest shape that does, again with a warning.  A world larger than
    the mesh holds ``world // size`` replicas of it.  Meshes are built once
    per (shape, axes) in a process: ``init_device_mesh`` is collective."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n, _ = world()
    fit = shape
    if math.prod(fit) > n:
        fit = feasible_mesh_shape(fit, n)
        warnings.warn(f"requested mesh {shape} needs {math.prod(shape)} ranks but the world "
                      f"has {n}; shrinking to the largest feasible shape {fit}",
                      stacklevel=2)
    if n % math.prod(fit):
        tiled = _tiling_shape(fit, n)
        warnings.warn(f"mesh {fit} does not tile a world of {n} ranks; shrinking to "
                      f"{tiled}, whose replicas do", stacklevel=2)
        fit = tiled
    key = (fit, axes, n, id(dist.group.WORLD) if n > 1 else None)
    if key not in _MESHES:
        _MESHES[key] = _build(fit, axes, n)
    return _MESHES[key]


def _build(shape, axes, n) -> HostMesh:
    if n == 1:
        return HostMesh(shape, axes, None, {a: MeshAxis(a, 1, 0) for a in axes})
    from torch.distributed.device_mesh import init_device_mesh

    replicas = n // math.prod(shape)
    names = (("replica",) if replicas > 1 else ()) + axes
    dims = ((replicas,) if replicas > 1 else ()) + shape
    dm = init_device_mesh("cpu", dims, mesh_dim_names=names)
    return HostMesh(shape, axes, dm,
                    {a: MeshAxis(a, s, dm.get_local_rank(a), dm.get_group(a))
                     for a, s in zip(axes, shape)})


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The production mesh: 256 ranks as (data=16, model=16), or 2 pods x 256
    as (pod=2, data=16, model=16), whose ``pod`` axis is pure data
    parallelism.  Raises unless the world has exactly that many ranks."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, _ = world()
    if n != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{math.prod(shape)} ranks, this one has {n}")
    return make_host_mesh(shape, axes)


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


# -- local worlds ------------------------------------------------------------------


def spawn_world(fn, nprocs: int, args=(), *, timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on a fresh gloo world of ``nprocs`` local
    processes and return each rank's result, in rank order.

    ``fn`` must be importable by a child (a module-level function) and its
    result picklable.  The world meets through a ``FileStore`` in a fresh
    temporary directory (no port is taken); each rank runs one CPU thread.
    The world must end within ``timeout`` seconds, or every rank is killed
    and ``TimeoutError`` raised; a rank that raises fails the call with its
    traceback.  Collectives time out after ``timeout`` seconds too, so a
    rank blocked on a failed peer ends."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, tmp, timeout, args))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [(Path(tmp) / f"rank{r}.err") for r in range(nprocs)]
        text = "\n".join(f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errors)
                         if e.exists())
        if hung:
            raise TimeoutError(f"ranks {hung} of a {nprocs}-rank world still ran after "
                               f"{timeout} s\n{text}")
        bad = [r for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks {bad} of a {nprocs}-rank world failed\n{text}")
        results = []
        for r in range(nprocs):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(fn, rank, nprocs, tmp, timeout, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(rank, *args)
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        dist.destroy_process_group()
