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
Every collective reports itself -- operation, dtype, shape, group size, ring
wire bytes, and the per-device operand bytes under the collective's HLO name
(``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``; what the
JAX package's dry run reads from its partitioned program) -- to an active
graph recorder (``engine.analysis.OpRecorder``, ``launch.dryrun.StepRecorder``),
as the kernel wrappers report launches.  The two byte counts are different
quantities and are kept apart.

The collectives are ``torch.autograd.Function`` pairs, so a training step's
backward issues the conjugate collective: an all-gather's backward
reduce-scatters (or, for a result every rank of the axis goes on to use
alike, takes this rank's block: ``replicated=True``), a reduce-scatter's
all-gathers, an all-to-all's is the inverse all-to-all, and Megatron's f/g
pair: :meth:`MeshAxis.copy` (identity forward, psum backward) and
:meth:`MeshAxis.all_reduce` (psum forward, identity backward).

:func:`record_only_mesh` lays a mesh of any shape over no world: its axes
(:class:`RecordAxis`) play one rank of each (rank 0 unless asked), move
nothing, return tensors of
the right shape and dtype (on the meta device, shapes only) and report
themselves as a real axis does -- how the dry run records one device of the
512-device production mesh.
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
    "pmax": lambda size, inb, outb: 2 * (size - 1) * inb,
    "all_to_all": lambda size, inb, outb: (size - 1) * inb // size,
    "broadcast": lambda size, inb, outb: (size - 1) * inb,
}

# the HLO instruction each primitive is, under the names the JAX package's dry
# run counts per-device operand bytes by (``repro.launch.dryrun.collective_bytes``)
HLO_KIND = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "psum": "all-reduce", "pmax": "all-reduce", "all_to_all": "all-to-all",
            "broadcast": "collective-broadcast"}


def _report(op: str, axis: "MeshAxis", x: torch.Tensor, out: torch.Tensor, kind: str) -> None:
    if not torch._C._len_torch_dispatch_stack():
        return
    inb, outb = x.numel() * x.element_size(), out.numel() * out.element_size()
    entry = {"primitive": op, "axis": axis.name, "kind": kind,
             "dtype": str(x.dtype).removeprefix("torch."),
             "shape": tuple(int(s) for s in out.shape), "axis_size": axis.size,
             "wire_bytes": int(_WIRE[op](axis.size, inb, outb)),
             "hlo": HLO_KIND[op], "operand_bytes": int(inb), "result_bytes": int(outb)}
    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "record_collective", None)
        if record is not None:
            record(entry)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather; backward: reduce-scatter the partial gradients, or
    (``replicated``) take this rank's block of a gradient every rank holds
    whole."""

    @staticmethod
    def forward(ctx, x, axis, dim, kind, replicated):
        ctx.args = (axis, dim, kind, replicated)
        return axis._all_gather(x, dim, kind)

    @staticmethod
    def backward(ctx, g):
        axis, dim, kind, replicated = ctx.args
        dx = axis.block(g, dim) if replicated else axis._reduce_scatter(g, dim, kind)
        return dx, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, kind):
        ctx.args = (axis, dim, kind)
        return axis._reduce_scatter(x, dim, kind)

    @staticmethod
    def backward(ctx, g):
        axis, dim, kind = ctx.args
        return axis._all_gather(g, dim, kind), None, None, None


class _Reduce(torch.autograd.Function):
    """Megatron's g: psum forward, identity backward (the result's gradient
    is the same on every rank of the axis, and is each partial input's)."""

    @staticmethod
    def forward(ctx, x, axis, kind):
        return axis._psum(x, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, psum backward (a value every rank
    holds alike, consumed by computations that differ between the ranks)."""

    @staticmethod
    def forward(ctx, x, axis, kind):
        ctx.args = (axis, kind)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, kind = ctx.args
        return axis._psum(g, kind), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim, kind):
        ctx.args = (axis, split_dim, concat_dim, kind)
        return axis._all_to_all(x, split_dim, concat_dim, kind)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim, kind = ctx.args
        return axis._all_to_all(g, concat_dim, split_dim, kind), None, None, None, None


@dataclass(eq=False)
class MeshAxis:
    """One axis of a host mesh as this rank sees it: its ``size``, this
    rank's index ``rank`` on it, and ``group``, the process group of the
    ranks along it (None on a one-process world).  The collectives are the
    identity at size 1 and record nothing there (no autograd node either).
    ``kind`` labels what a collective moves for the recorder: ``"edge"`` for
    an activation edge of the walkers (what ``analysis.collective_report``
    holds against the pricing), ``"output"`` for a result assembled over the
    shards, ``"state"`` for decode state paged between ranks, ``"weight"``
    for a parameter gathered before use, ``"grad"`` for a gradient summed
    over the data-parallel ranks."""

    name: str
    size: int
    rank: int
    group: Any = None

    moves = True    # a record-only axis moves nothing

    def _run(self, fn, x: torch.Tensor, out_shape) -> torch.Tensor:
        """Run the collective ``fn(out, x)`` into a new ``out`` beside ``x``,
        out of sight of any dispatch mode (the recorder sees the collective
        as one entry, :func:`_report`, and a mode with a
        ``hold_collective_output`` method is handed the new buffer)."""
        modes = _get_current_dispatch_mode_stack()
        with _disable_current_modes():
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            if self.moves:
                fn(out, x.contiguous())
        for mode in modes:
            hold = getattr(mode, "hold_collective_output", None)
            if hold is not None:
                hold(out)
        return out

    # -- the transport (no autograd) ------------------------------------------

    def _all_gather(self, x, dim, kind):
        xt = x.movedim(dim, 0)

        def run(o, s):
            # the list form: gloo has taken it in every release
            dist.all_gather(list(o.chunk(self.size)), s, group=self.group)

        out = self._run(run, xt, (self.size * xt.shape[0],) + tuple(xt.shape[1:]))
        out = out.movedim(0, dim).contiguous()
        _report("all_gather", self, x, out, kind)
        return out

    def _reduce_scatter(self, x, dim, kind):
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

    def _psum(self, x, kind, op: str = "psum"):
        red = dist.ReduceOp.MAX if op == "pmax" else dist.ReduceOp.SUM

        def run(o, s):
            o.copy_(s)
            dist.all_reduce(o, op=red, group=self.group)

        out = self._run(run, x, tuple(x.shape))
        _report(op, self, x, out, kind)
        return out

    def _all_to_all(self, x, split_dim, concat_dim, kind):
        split_dim, concat_dim = split_dim % x.ndim, concat_dim % x.ndim
        n = x.shape[split_dim]
        if n % self.size:
            raise ValueError(f"all_to_all: dim of size {n} does not split over "
                             f"{self.size} ranks")
        # block j of split_dim goes to rank j: lay the blocks along a new
        # leading dim (the rest keep x's order), exchange, and put the blocks
        # received along concat_dim, rank major
        xs = x.unflatten(split_dim, (self.size, n // self.size)).movedim(split_dim, 0)
        out = self._run(lambda o, s: dist.all_to_all_single(o, s, group=self.group), xs,
                        tuple(xs.shape))
        out = out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1).contiguous()
        _report("all_to_all", self, x, out, kind)
        return out

    # -- the collectives ------------------------------------------------------

    def all_gather(self, x: torch.Tensor, dim: int = -1, *, kind: str = "edge",
                   replicated: bool = False) -> torch.Tensor:
        """Tiled all-gather along ``dim``: shard i's block lands at block i,
        the single-device order of that dim.  Backward: a reduce-scatter of
        the partial gradients, or with ``replicated`` (every rank of the axis
        goes on to use the result alike, so each holds the whole gradient)
        this rank's block of it."""
        if self.size == 1:
            return x
        return _AllGather.apply(x, self, dim, kind, replicated)

    def all_reduce(self, x: torch.Tensor, *, kind: str = "edge", op: str = "sum") -> torch.Tensor:
        """Sum (``op="max"``: the largest value) over the axis, a new tensor;
        ``x`` is left as it was.  The sum's backward is the identity
        (Megatron's g); the max carries no gradient."""
        if self.size == 1:
            return x
        if op == "max":
            return self._psum(x.detach(), kind, "pmax")
        if op != "sum":
            raise ValueError(f"all_reduce: op {op!r} is neither 'sum' nor 'max'")
        return _Reduce.apply(x, self, kind)

    def copy(self, x: torch.Tensor, *, kind: str = "edge") -> torch.Tensor:
        """``x`` itself, whose backward sums the gradient over the axis
        (Megatron's f): for a value every rank holds alike that feeds a
        computation that differs between the ranks."""
        if self.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _Copy.apply(x, self, kind)

    def reduce_scatter(self, x: torch.Tensor, dim: int = -1, *,
                       kind: str = "edge") -> torch.Tensor:
        """Sum over the axis, each rank keeping its block of ``dim`` (tiled);
        backward: an all-gather."""
        if self.size == 1:
            return x
        return _ReduceScatter.apply(x, self, dim, kind)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int, *,
                   kind: str = "edge") -> torch.Tensor:
        """Cut ``split_dim`` into ``size`` blocks, send block j to the rank at
        index j, and lay the blocks received along ``concat_dim`` in rank
        order (a sharding of ``concat_dim`` becomes one of ``split_dim``);
        backward: the inverse all-to-all."""
        if self.size == 1:
            return x
        return _AllToAll.apply(x, self, split_dim, concat_dim, kind)

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
        inverse of :meth:`all_gather`; ``x`` itself at size 1."""
        if self.size == 1:
            return x
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"axis {self.name!r} of size {self.size} must divide the "
                             f"dim of size {n}")
        return x.narrow(dim, self.rank * (n // self.size), n // self.size)


@dataclass(eq=False)
class RecordAxis(MeshAxis):
    """An axis of a record-only mesh: one of ``size`` ranks with no world
    behind it.  Its collectives move nothing: each returns a tensor of the
    shape and dtype a real axis would return (uninitialised; on the meta
    device, shapes only) and reports itself exactly as a real axis does."""

    moves = False


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
    record_only: bool = False

    def axis(self, name: str) -> MeshAxis:
        return self.axes[name]

    def unit(self, name: str) -> MeshAxis:
        """An axis ``name`` of size 1: what a layout runs over where it cuts
        nothing over the mesh's axis of that name (its collectives the
        identity)."""
        return MeshAxis(name, 1, 0)

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


def record_only_mesh(shape, axes=("data", "model"), ranks=None) -> HostMesh:
    """A mesh of ``shape`` over no world, as one of its ranks sees it (rank 0
    on every axis, or the index ``ranks`` names for an axis): every axis a
    :class:`RecordAxis`.  Run a sharded step on meta tensors over it to
    record what that device of the mesh would do and move."""
    shape, axes, ranks = tuple(int(s) for s in shape), tuple(axes), ranks or {}
    return HostMesh(shape, axes, None,
                    {a: RecordAxis(a, s, ranks.get(a, 0)) for a, s in zip(axes, shape)},
                    record_only=True)


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
    processes and return each rank's result, in rank order: one call of a
    :class:`World` that ends with it.

    ``fn`` must be importable by a child (a module-level function) and its
    result picklable.  The world must end within ``timeout`` seconds, or every
    rank is killed and ``TimeoutError`` raised; a rank that raises fails the
    call with its traceback."""
    with World(nprocs, timeout=timeout) as w:
        return w.run(fn, args)


class World:
    """A gloo world of ``nprocs`` local processes that takes one call after
    another: :meth:`run` runs ``fn(rank, *args)`` on every rank and returns
    each rank's result, in rank order; :meth:`close` (or the end of its
    ``with`` block) ends it.  The processes start at once and meet while the
    caller goes on, so a world started early is ready by its first call.

    The world meets through a ``FileStore`` in a fresh temporary directory
    (no port is taken); each rank runs one CPU thread.  ``args`` reach the
    ranks as ``torch.multiprocessing`` pickles them (CUDA tensors by IPC,
    shared host tensors by their segment); a rank drops them before it takes
    the next call.  A call must end within its ``timeout`` (default: the
    world's), or every rank is killed and ``TimeoutError`` raised; a rank
    that raises ends the world and fails the call with every rank's
    traceback.  Collectives time out after the world's ``timeout`` too, so a
    rank blocked on a failed peer ends.  A world that failed takes no more
    calls."""

    def __init__(self, nprocs: int, *, timeout: float = 600.0):
        import torch.multiprocessing as mp

        self.nprocs, self.timeout, self._calls = nprocs, timeout, 0
        self._tmp = tempfile.TemporaryDirectory(prefix="repro_torch_world_")
        ctx = mp.get_context("spawn")
        self._done = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(nprocs)]
        self._procs = [ctx.Process(target=_world_rank, args=(r, nprocs, self._tmp.name, timeout,
                                                             self._jobs[r], self._done))
                       for r in range(nprocs)]
        self._failed: str | None = None
        for p in self._procs:
            p.start()

    def __enter__(self) -> World:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn, args=(), *, timeout: float | None = None) -> list:
        import queue

        if self._failed:
            raise RuntimeError(f"this {self.nprocs}-rank world failed before: {self._failed}")
        timeout = self.timeout if timeout is None else timeout
        call, self._calls = self._calls, self._calls + 1
        for jobs in self._jobs:
            jobs.put((call, fn, args))
        deadline, done = time.monotonic() + timeout, set()
        while len(done) < self.nprocs:
            try:
                done.add(self._done.get(timeout=max(0.01, min(1.0, deadline - time.monotonic()))))
                continue
            except queue.Empty:
                pass
            if any(p.exitcode is not None for r, p in enumerate(self._procs) if r not in done):
                self._end(deadline)
                bad = [r for r, p in enumerate(self._procs) if p.exitcode]
                raise RuntimeError(self._fail(f"ranks {bad} of a {self.nprocs}-rank world "
                                              "failed"))
            if time.monotonic() >= deadline:
                hung = [r for r in range(self.nprocs) if r not in done]
                self._end(deadline)
                raise TimeoutError(self._fail(f"ranks {hung} of a {self.nprocs}-rank world "
                                              f"still ran after {timeout} s"))
        results = []
        for r in range(self.nprocs):
            path = Path(self._tmp.name) / f"rank{r}.{call}.pkl"
            with open(path, "rb") as f:
                results.append(pickle.load(f))
            path.unlink()
        return results

    def _fail(self, what: str) -> str:
        """``what`` and every rank's traceback; the world takes no more calls."""
        errors = [Path(self._tmp.name) / f"rank{r}.err" for r in range(self.nprocs)]
        self._failed = what
        return what + "\n" + "\n".join(f"rank {r}:\n{e.read_text()}"
                                        for r, e in enumerate(errors) if e.exists())

    def _end(self, deadline: float) -> None:
        """Ask every rank to stop, wait for them until ``deadline``, kill the rest."""
        for jobs in self._jobs:
            jobs.put(None)
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()

    def close(self) -> None:
        """End the world: every rank leaves its loop (killed if it has not
        within the world's ``timeout``), and the temporary directory goes."""
        if any(p.is_alive() for p in self._procs):
            self._end(time.monotonic() + self.timeout)
        for q in (self._done, *self._jobs):
            q.cancel_join_thread()   # a job a killed rank never read must not block the exit
            q.close()
        self._tmp.cleanup()


def _world_rank(rank, nprocs, tmp, timeout, jobs, done):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
    try:
        while (job := jobs.get()) is not None:
            call, fn, args = job
            del job
            result = fn(rank, *args)
            del args        # the caller's tensors, released before the next call
            with open(Path(tmp) / f"rank{rank}.{call}.pkl", "wb") as f:
                pickle.dump(result, f)
            del result
            done.put(rank)
    except BaseException:
        (Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        dist.destroy_process_group()
