"""Multi-pod dry run on the meta device: build every (arch x shape cell x
production mesh) step and record what one device of the mesh would hold and
do, the port of the JAX package's ``launch/dryrun.py``.

The JAX package forces 512 host devices and compiles each cell; its records
come from the compiled program.  The port has no compiler to ask, so each
cell's step (train_4k -> ``lm.make_train_step``, prefill_32k ->
``make_prefill_step``, decode_* -> ``make_serve_step``) runs on
``torch.device("meta")`` -- shapes and dtypes, no memory, no card -- under a
recorder of its ATen operations and collectives.  The mesh is a shape with
axis names (:class:`AbstractMesh`); it needs no ``torch.distributed`` world.

The recorded step is the SPMD step of one device: one rank of a
record-only mesh of the production shape (``launch.mesh.record_only_mesh``:
its collectives move nothing, return the right shapes and report themselves)
runs ``lm.make_*_step(mesh=)`` on its shards, the same code a real
``torch.distributed`` world runs.  That rank is rank 0, but for a decode
step the ``model`` rank that owns the new token's cache slot
(:func:`recorded_ranks`; a sliding window's ring slot ``pos % W``): the only
rank that writes its block of the sequence-sharded cache, so the busiest;
the other ranks' temporaries and bytes fall short of its record by that
copy of their cache blocks.  A record holds:

  * ``memory.argument_size_in_bytes`` -- the per-device bytes of the step's
    arguments (the train state or the params / cache, the batch, and for a
    decode step its 4-byte ``pos``): each leaf's per-device shape comes from
    its ``PartitionSpec`` after :func:`sanitize_spec` on the mesh's shape.
    Exact: the JAX package's shard shapes give the same bytes.
  * ``memory.temp_size_in_bytes`` -- the peak, over the recorded step, of
    the bytes held by tensors the step itself made (every storage an
    operation or a collective creates counts from its creation until it is
    freed; views add nothing; the step's outputs count while they are alive
    inside it), extended from the traced depths to the config's (below: a
    lower bound): the device's own step's.  Traced at full depth on one
    device, the peak is what the card's allocator reads above the arguments
    for the same step (``chip_smoke.py`` phase 15 prints both).
  * ``flops`` -- the device's FLOPs of the step by the formulas of
    ``torch.utils.flop_counter`` (matrix products, convolutions, attention;
    elementwise work counts 0).  Not held against XLA's ``cost_analysis``:
    the two count different programs (the remat recompute, fusions).
  * ``bytes_accessed`` -- the input plus output bytes of every ATen operation
    of the device's step that is not a view, and of every collective.  This
    is before any fusion, so it bounds from above what a fused program
    moves.
  * ``collective_bytes_per_device`` -- the per-device operand bytes of each
    collective kind the step issued, under the JAX package's HLO names
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``):
    the quantity its dry run reads from the partitioned HLO, here of the
    port's own explicit schedule (``PERF.md`` compares the two).

A step's cost grows by the same amount with every layer of a kind, so each
cell is recorded at the few depths that give every layer kind's share (1 and 2
layers for a uniform stack, 1-3 for its training step and for
recurrentgemma's rec, rec, attn_local pattern) and summed to the config's
depth (``traced_layers`` in the record; :func:`measure`): exactly for FLOPs,
bytes and collective bytes, and as a lower bound for the peak, which misses a live set that
only becomes the largest past the traced depths (62-100% of a whole trace's
at depth 7 of the smoke configs; 59% at llama3.2-1b's 16-layer training step
of 4 x 512 tokens, whose peak sits in the AdamW update of the largest leaf:
the embedding's at 1-3 layers, the stacked MLP weights' at 16).
A config no deeper than that is recorded whole.  Tracing every layer would repeat identical work: a 61-layer step at
32k tokens makes tens of millions of ATen calls, each a Python dispatch on
meta.

``status`` is ``SKIP`` (with the reason) where ``cell_supported`` says so,
``FAIL`` (error and a trimmed traceback) where the build or the recorded step
raises -- the sweep goes on -- and ``OK`` otherwise.  Artifacts land in
``artifacts/dryrun_torch/<arch>__<cell>__<mesh>.json``, apart from the JAX
package's ``artifacts/dryrun/``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b_smoke --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--workers N]
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.bridge import leaves, rebuild, resolve_device
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.distributed.sharding import (
    axis_size, make_rules, sanitize_spec, sanitized_specs, shard_tree)
from repro_torch.launch.mesh import (
    MULTI_POD_SHAPE, PRODUCTION_SHAPE, HostMesh, record_only_mesh)
from repro_torch.models import lm, transformer as T
from repro_torch.models.config import SHAPE_CELLS, ShapeCell, cell_by_name, cell_supported
from repro_torch.optim.optimizer import OptimizerConfig, make_optimizer

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


@dataclass(frozen=True)
class AbstractMesh:
    """A device mesh as a shape with axis names (JAX's ``AbstractMesh``):
    ``shape`` maps each axis name to its size."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def tag(self) -> str:
        return "pod" + "x".join(map(str, self.sizes))

    def record_only(self, ranks=None) -> HostMesh:
        """This mesh as one rank sees it (rank 0, or the indices ``ranks``
        names by axis), with no world behind it
        (``launch.mesh.record_only_mesh``)."""
        return record_only_mesh(self.sizes, self.axis_names, ranks)


def production_mesh(multi_pod: bool) -> AbstractMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) across two pods:
    ``launch/mesh.py``'s production shapes, with no world behind them."""
    if multi_pod:
        return AbstractMesh(MULTI_POD_SHAPE, ("pod", "data", "model"))
    return AbstractMesh(PRODUCTION_SHAPE, ("data", "model"))


def shard_shape(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple[int, ...]:
    """The per-device block of a global ``shape`` under a sanitized ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // axis_size(mesh, ax) for dim, ax in zip(shape, spec))


def _opt_specs(cfg, opt_state, param_specs, params):
    """Optimizer-state spec entries mirroring the parameter shardings (adamw:
    m/v match params; adafactor: factored row/col specs)."""
    specs: dict = {"grad_norm": ()}
    if cfg.opt_kind == "adafactor":
        def vspec(s, p):
            axes = tuple(s) + (None,) * (p.ndim - len(tuple(s)))
            if p.ndim >= 2:
                return {"row": axes[:-1], "col": axes[:-2] + axes[-1:]}
            return {"full": axes}

        specs["v"] = _map2(vspec, param_specs, params)
    else:
        specs["v"] = param_specs
    if "m" in opt_state:
        specs["m"] = param_specs
    if "master" in opt_state:
        specs["master"] = param_specs
    return specs


def _map2(fn, specs, like):
    """``fn(spec, leaf)`` over a spec tree (spec tuples are its leaves) and a
    tensor tree of the same structure."""
    if isinstance(specs, dict):
        return {k: _map2(fn, specs[k], like[k]) for k in specs}
    if isinstance(specs, list):
        return [_map2(fn, s, x) for s, x in zip(specs, like)]
    return fn(specs, like)


def _replicated(specs):
    if isinstance(specs, dict):
        return {k: _replicated(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_replicated(v) for v in specs]
    return ()


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _leaf_specs(mesh: AbstractMesh, specs, args, path=()):
    """(name, sanitized spec) of every tensor of ``args``, walking the spec
    tree along ``args``' structure (a spec tuple at a tensor's place is its
    leaf), named and ordered as ``flatten_with_names`` names the tensors."""
    if isinstance(args, dict):
        for k in sorted(args):
            yield from _leaf_specs(mesh, specs[k], args[k], path + (f"[{k!r}]",))
    elif isinstance(args, (tuple, list)):
        for i, (spec, x) in enumerate(zip(specs, args)):
            yield from _leaf_specs(mesh, spec, x, path + (f"[{i}]",))
    else:
        yield "/".join(path), sanitize_spec(mesh, specs, tuple(args.shape))


@dataclass
class Cell:
    """One cell's step: the config, the shape cell, the mesh and rules, the
    step function, its global arguments (meta tensors) and the sanitized
    spec of each argument leaf by name.  On a host mesh (``mesh`` a
    ``launch.mesh.HostMesh``: a real world's, or a record-only one) the step
    is the SPMD step and ``local`` holds this rank's shards of the
    arguments (real tensors on a real world, meta ones on a record-only
    mesh); else ``local`` is None and the step is the single-device one."""

    cfg: object
    cell: ShapeCell
    mesh: object
    rules: dict
    step: object
    args: tuple
    specs: dict
    local: tuple | None = None
    preset: str = "base"

    def call(self):
        """Run the step once (on a host mesh: this rank's SPMD step on its
        shards).  A decode step runs at its last cache slot,
        ``pos = seq_len - 1``: the port's decode takes the position as an
        int, where the JAX package traces the 0-d int32 that ``args`` holds
        (its bytes count among the arguments)."""
        args = self.args if self.local is None else self.local
        if self.cell.kind == "decode":
            params, cache, batch, _ = args
            return self.step(params, cache, batch, self.cell.seq_len - 1)
        return self.step(*args)

    def shards(self) -> list[tuple[str, tuple, tuple, tuple, torch.dtype]]:
        """(leaf name, global shape, spec, per-device shape, dtype) of every
        argument leaf, in checkpoint naming and order."""
        return [(name, tuple(x.shape), self.specs[name],
                 shard_shape(self.mesh, self.specs[name], tuple(x.shape)), x.dtype)
                for name, x in flatten_with_names(self.args)]

    def argument_bytes(self) -> int:
        return sum(math.prod(per) * dt.itemsize for _, _, _, per, dt in self.shards())


def _values(c: "Cell", opt, device):
    """Real tensors for a cell's meta arguments: the parameters from
    ``init_lm(0)`` (the optimizer state from its ``init``), token ids and
    embeddings from a numpy generator seeded 0, zero caches and steps."""
    gen = np.random.default_rng(0)
    cfg, device = c.cfg, resolve_device(device)
    params = T.init_lm(0, cfg, device=device)

    def value(x):
        if x.ndim and not x.dtype.is_floating_point:
            ids = gen.integers(0, cfg.vocab_size, tuple(x.shape)).astype(np.int32)
            return torch.from_numpy(ids).to(device=device, dtype=x.dtype)
        if x.ndim:
            return torch.from_numpy(gen.standard_normal(tuple(x.shape)).astype(np.float32)).to(
                device=device, dtype=x.dtype)
        return torch.zeros((), dtype=x.dtype, device=device)

    batch = {k: value(v) for k, v in sorted(c.args[-1 if c.cell.kind != "decode" else 2].items())}
    if c.cell.kind == "train":
        return ({"params": params, "opt_state": opt.init(params),
                 "step": value(c.args[0]["step"])}, batch)
    if c.cell.kind == "prefill":
        return (params, batch)
    cache = rebuild(c.args[1], iter(torch.zeros(tuple(x.shape), dtype=x.dtype, device=device)
                                    for x in leaves(c.args[1])))
    return (params, cache, batch, value(c.args[3]))


def build_cell(arch: str, cell, *, multi_pod: bool = False, mesh=None, cfg_override=None,
               preset: str = "base", device=None) -> Cell:
    """The step of ``cell`` (a name in ``SHAPE_CELLS`` or a ``ShapeCell``)
    for ``arch`` (or ``cfg_override``) on the production mesh (or ``mesh``)
    under the ``preset`` rules, its arguments on meta.  The ``zero2``
    preset's ``"params": "replicated"`` replicates the parameters and keeps
    the optimizer state sharded.

    ``mesh`` an :class:`AbstractMesh` (the default: the production one):
    the single-device step.  ``mesh`` a ``launch.mesh.HostMesh``: the SPMD
    step under the preset (``lm.make_*_step(mesh=, preset=)``; ``sp``
    raises ``ValueError``), and ``Cell.local`` this rank's shards as that
    preset lays them out (``transformer.Spmd``) -- on a record-only mesh of
    the meta arguments, on a real world of real ones on ``device`` (the card
    when None), from :func:`_values`."""
    cfg = cfg_override if cfg_override is not None else lm.get_config(arch)
    cell = cell if isinstance(cell, ShapeCell) else cell_by_name(cell)
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    if isinstance(mesh, HostMesh):
        multi_pod = "pod" in mesh.axis_names
    rules = make_rules(multi_pod=multi_pod, preset=preset)
    baxes = rules["batch"]

    param_specs = T.param_pspecs(cfg)
    opt_param_specs = param_specs          # optimizer states always sharded
    if rules.get("params") == "replicated":  # ZeRO-2: replicate model params
        param_specs = _replicated(param_specs)
    params = T.init_lm(0, cfg, device="meta")
    batch = lm.batch_struct(cfg, cell)
    batch_specs = lm.batch_pspecs(cfg, cell, batch_axes=baxes)
    sharded = isinstance(mesh, HostMesh)
    kw = {"mesh": mesh, "preset": preset} if sharded else {}

    opt = None
    if cell.kind == "train":
        opt = make_optimizer(OptimizerConfig(
            kind=cfg.opt_kind, b1=cfg.opt_b1, state_dtype=cfg.opt_state_dtype,
            master_weights=cfg.opt_master_weights))
        opt_state = opt.init(params)
        state = {"params": params, "opt_state": opt_state, "step": _meta((), torch.int32)}
        state_specs = {"params": param_specs,
                       "opt_state": _opt_specs(cfg, opt_state, opt_param_specs, params),
                       "step": ()}
        step, args = lm.make_train_step(cfg, opt, **kw), (state, batch)
        specs = (state_specs, batch_specs)
    elif cell.kind == "prefill":
        step, args = lm.make_prefill_step(cfg, **kw), (params, batch)
        specs = (param_specs, batch_specs)
    elif cell.kind == "decode":
        step = lm.make_serve_step(cfg, **kw)
        args = (params, lm.cache_struct(cfg, cell), batch, _meta((), torch.int32))
        specs = (param_specs, T.cache_pspecs(cfg), batch_specs, ())
    else:
        raise ValueError(cell.kind)
    c = Cell(cfg, cell, mesh, rules, step, args, dict(_leaf_specs(mesh, specs, args)),
             preset=preset)
    if sharded:
        c.local = _local_args(c, opt, device)
    return c


def _local_args(c: Cell, opt, device):
    """This rank's shards of a cell's arguments under the sharded executor's
    specs of the cell's preset (``transformer.Spmd``: under ``zero2`` the
    parameters whole, the optimizer state cut)."""
    spmd = T.spmd_layout(c.cfg, c.mesh, preset=c.preset)
    args = c.args if c.mesh.record_only else _values(c, opt, device)
    batch = args[-1] if c.cell.kind != "decode" else args[2]
    bspecs = sanitized_specs({k: (spmd.batch_entry,) + (None,) * (v.ndim - 1)
                              for k, v in batch.items()}, batch, c.mesh)
    if c.cell.kind == "train":
        state = args[0]
        specs = ({"params": spmd.specs,
                  "opt_state": _opt_specs(c.cfg, state["opt_state"], spmd.opt_specs,
                                          state["params"]),
                  "step": ()}, bspecs)
    elif c.cell.kind == "prefill":
        specs = (spmd.specs, bspecs)
    else:
        specs = (spmd.specs, spmd.cache_specs(args[1]), bspecs, ())
    return shard_tree(args, specs, c.mesh)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

_VIEW, _MUTATE, _FRESH = 0, 1, 2
_PLAIN_VALUES = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
                 torch.memory_format)


class _NotMeta(Exception):
    """An operand whose values, not its shape, may decide the result."""


def _signature(x):
    """A hashable stand-in for an operand: a tensor by its shape, strides
    and dtype, a plain value by its type and value.  Raises
    :class:`_NotMeta` for a tensor off meta or an object of another kind."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NotMeta
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    if x is None or isinstance(x, _PLAIN_VALUES):
        return (type(x), x)
    raise _NotMeta


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclass(frozen=True)
class _Out:
    shape: tuple
    stride: tuple
    dtype: torch.dtype


def _describe(out):
    """An operation's result with each tensor replaced by its :class:`_Out`."""
    if isinstance(out, torch.Tensor):
        return _Out(tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (tuple, list)):
        return type(out)(_describe(o) for o in out)
    return out


def _rebuild(desc):
    """A fresh result from :func:`_describe`'s record: new meta tensors."""
    if isinstance(desc, _Out):
        return torch.empty_strided(desc.shape, desc.stride, dtype=desc.dtype, device="meta")
    if isinstance(desc, (tuple, list)):
        return type(desc)(_rebuild(d) for d in desc)
    return desc


class StepRecorder(TorchDispatchMode):
    """Records every ATen operation below autograd while it is active:
    ``flops`` (``torch.utils.flop_counter``'s formulas), ``bytes`` (input
    plus output bytes of each operation that is not a view, and of each
    collective), ``peak`` (the most bytes held at once by the storages the
    operations and collectives made, each counted from its creation until
    it is freed) and ``collectives`` (the operand bytes of the collectives
    of ``launch.mesh.MeshAxis``, summed by HLO kind).

    On meta an operation's outputs follow from its operands' shapes, strides
    and dtypes, so an operation seen before with the same ones is answered
    from a table, without running its meta function again (most of them run
    as Python references): the cost of a step's thousands of identical
    attention tiles is the lookup, and the sweep of every cell takes about a
    quarter of its time without the table (the same records; PERF.md).
    Views (and operations that return their input's storage) run as they
    are; an in-place operation too."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.collectives: dict[str, int] = {}
        self._kind: dict = {}
        self._memo: dict = {}

    def record_collective(self, entry: dict) -> None:
        kind = entry["hlo"]
        self.collectives[kind] = self.collectives.get(kind, 0) + entry["operand_bytes"]
        self.bytes += entry["operand_bytes"] + entry["result_bytes"]

    def hold_collective_output(self, out: torch.Tensor) -> None:
        self._hold(out)

    def _release(self, n):
        self.live -= n

    def _hold(self, out):
        for t in _tensors(out):
            s = t.untyped_storage()
            n = s.nbytes()
            self.live += n
            weakref.finalize(s, self._release, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kind.get(func)
        if kind is None:
            returns = func._schema.returns
            kind = (_MUTATE if func._schema.is_mutable else _VIEW) if any(
                r.alias_info is not None for r in returns) else _FRESH
            self._kind[func] = kind
        if kind == _VIEW:
            return func(*args, **kwargs)
        key = None
        if kind == _FRESH:
            try:
                key = (func, _signature(args), _signature(tuple(sorted(kwargs.items()))))
            except _NotMeta:
                pass
        if key is not None and key in self._memo:
            meta, flops, nbytes = self._memo[key]
            out = _rebuild(meta)
        else:
            out = func(*args, **kwargs)
            ins = _tensors(args) + _tensors(list(kwargs.values()))
            outs = _tensors(out)
            if kind == _FRESH:
                held = {t.untyped_storage()._cdata for t in ins}
                if any(t.untyped_storage()._cdata in held for t in outs):
                    self._kind[func] = _VIEW       # returns its input's storage
                    return out
            formula = flop_registry.get(func._overloadpacket)
            flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
            nbytes = _nbytes(ins) + _nbytes(outs)
            if key is not None and all(t.device.type == "meta" for t in outs):
                self._memo[key] = (_describe(out), flops, nbytes)
        self.flops += flops
        self.bytes += nbytes
        if kind == _FRESH:
            self._hold(out)
        return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _traced_depth(kinds: list[str]) -> int:
    """The least depth whose layers 2.. hold every layer kind: the costs at
    depths 1..D give each kind's share of a layer (the last depth's when a
    kind recurs), or the whole depth when the model is no deeper."""
    firsts = [next((i for i in range(1, len(kinds)) if kinds[i] == k), len(kinds))
              for k in set(kinds)]
    return min(max(firsts) + 1, len(kinds))


def _extend(values: list[int], kinds: list[str]) -> int:
    """A metric at the model's depth from its values at depths 1..D: the
    base (embedding, head, loss, optimizer) plus each layer's kind's share."""
    share = {kinds[d]: values[d] - values[d - 1] for d in range(1, len(values))}
    return values[0] - share[kinds[0]] + sum(share[k] for k in kinds)


def _extend_quadratic(values: list[int], depth: int) -> int:
    """A metric at ``depth`` from its values at depths 1, 2, 3 on the
    quadratic through them: a uniform stack's training step reads and writes
    O(L^2) bytes, since the gradient of each layer's slice of a stacked leaf
    is a whole (L, ...) tensor (``select_backward``), L of which are summed."""
    v1, v2, v3 = values
    q2 = v3 - 2 * v2 + v1                     # twice the L^2 coefficient
    b = v2 - v1 - 3 * q2 // 2
    return v1 - b - q2 // 2 + b * depth + q2 * depth * depth // 2


def measure(arch: str, cell, *, cfg_override=None, mesh=None, preset: str = "base") -> dict:
    """The step of a cell recorded on meta: ``flops``, ``bytes``, ``peak``,
    ``collectives`` (operand bytes by HLO kind) and ``traced_layers``.
    Without ``mesh`` the single-device step, whole-step totals (no
    collectives); with a record-only ``mesh`` (``launch.mesh.HostMesh``)
    its rank 0's SPMD step under the ``preset`` rules, that device's own
    figures.

    FLOPs, bytes and collective bytes are exact: they grow by a fixed amount
    per layer of each kind (and, in a uniform stack's training step, by a
    fixed amount per L^2 on top), so the depths 1..D of
    :func:`_traced_depth` (1, 2, 3 for a uniform stack's training step)
    determine them.  The peak is the
    extension of its last two traced depths' difference (the last per layer
    kind): the peak at depth L is the largest of the live sets along the step,
    each growing linearly in L, a convex function of L, so the extension is a
    lower bound (but for a few scalars' bytes), exact once the largest live
    set is the same one at the traced depths and at L."""
    cfg = cfg_override if cfg_override is not None else lm.get_config(arch)
    kinds = T.layer_kinds(cfg)
    cell = cell if isinstance(cell, ShapeCell) else cell_by_name(cell)
    quadratic = T._uniform(cfg) and cell.kind == "train"
    depth = max(_traced_depth(kinds), 3 if quadratic else 1)
    if depth >= len(kinds):
        depths = [len(kinds)]
    else:
        depths = list(range(1, depth + 1))
    runs = []
    for d in depths:
        c = build_cell(arch, cell, cfg_override=cfg.replace(num_layers=d), mesh=mesh,
                       preset=preset)
        rec = StepRecorder()
        with rec:
            out = c.call()
        del out, c
        runs.append((rec.flops, rec.bytes, rec.peak, rec.collectives))
    flops, nbytes, peak, coll = ([r[i] for r in runs] for i in range(4))
    kinds_seen = sorted({k for r in coll for k in r})
    per_kind = {k: [r.get(k, 0) for r in coll] for k in kinds_seen}
    if len(runs) == 1:
        return {"flops": flops[0], "bytes": nbytes[0], "peak": peak[0],
                "collectives": coll[0], "traced_layers": depths}
    if quadratic:
        total = {"flops": _extend_quadratic(flops, len(kinds)),
                 "bytes": _extend_quadratic(nbytes, len(kinds)),
                 "peak": peak[-1] + (len(kinds) - depths[-1]) * (peak[-1] - peak[-2]),
                 "collectives": {k: _extend_quadratic(v, len(kinds))
                                 for k, v in per_kind.items()}}
    else:
        total = {"flops": _extend(flops, kinds), "bytes": _extend(nbytes, kinds),
                 "peak": _extend(peak, kinds),
                 "collectives": {k: _extend(v, kinds) for k, v in per_kind.items()}}
    return {**total, "traced_layers": depths}


def recorded_ranks(cfg, cell: ShapeCell, mesh: AbstractMesh) -> dict:
    """The device a record is of: rank 0 of every axis, but for a decode step
    the ``model`` rank whose block of the sequence-sharded cache holds the
    new token's slot: ``pos = seq_len - 1`` (the last one), or, for a
    sliding window's ring of W = min(seq_len, window) slots, ``pos % W``.
    That rank alone writes its cache block, a copy of it per layer that the
    other ranks do not make.  A model with no sequence cache (Mamba-2's
    states), or a cache ``model`` does not cut, records rank 0."""
    kinds = set(T.layer_kinds(cfg))
    if cell.kind != "decode" or not kinds & {"attn_mlp", "attn_moe", "attn_local"}:
        return {}
    m, pos = mesh.shape.get("model", 1), cell.seq_len - 1
    slots = cell.seq_len
    if "attn_local" in kinds:
        slots = min(cell.seq_len, cfg.local_window)
        pos %= slots
    if slots % m:
        return {}
    return {"model": pos // (slots // m)}


def dryrun_cell(arch: str, cell, *, multi_pod: bool = False, mesh: AbstractMesh | None = None,
                measured: dict | None = None, save: bool = True, verbose: bool = True) -> dict:
    """Record one (arch, cell, mesh): one device's SPMD step on the
    record-only form of ``mesh`` (rank 0's, a decode step the cache-writing
    rank's: :func:`recorded_ranks`).  ``measured``: a dict that keeps each
    :func:`measure` for the next record of the same mesh.  ``trace_s``: the
    seconds this record took to build and measure."""
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    cell = cell if isinstance(cell, ShapeCell) else cell_by_name(cell)
    cfg = lm.get_config(arch)
    ok, reason = cell_supported(cfg, cell)
    record: dict = {"arch": arch, "cell": cell.name, "mesh": mesh.tag, "kind": cell.kind,
                    "seq_len": cell.seq_len, "global_batch": cell.global_batch,
                    "device": "meta"}
    if not ok:
        record.update(status="SKIP", reason=reason)
        if verbose:
            print(f"[dryrun] {arch} x {cell.name} x {mesh.tag}: SKIP ({reason})")
        if save:
            _save(record)
        return record

    t0 = time.perf_counter()
    try:
        c = build_cell(arch, cell, multi_pod=multi_pod, mesh=mesh)
        args_bytes = c.argument_bytes()
        measured = {} if measured is None else measured
        key = (arch, cell, mesh.tag)
        if key not in measured:
            measured[key] = measure(arch, cell,
                                    mesh=mesh.record_only(recorded_ranks(cfg, cell, mesh)))
        totals = measured[key]
        record.update(
            status="OK",
            trace_s=round(time.perf_counter() - t0, 2),
            traced_layers=totals["traced_layers"],
            flops=totals["flops"],
            bytes_accessed=totals["bytes"],
            collective_bytes_per_device=dict(sorted(totals["collectives"].items())),
            memory={"argument_size_in_bytes": args_bytes, "temp_size_in_bytes": totals["peak"]},
            num_devices=mesh.size,
        )
        if verbose:
            mem_gb = (args_bytes + record["memory"]["temp_size_in_bytes"]) / 2**30
            print(f"[dryrun] {arch} x {cell.name} x {mesh.tag}: OK "
                  f"flops={record['flops']:.3e} bytes={record['bytes_accessed']:.3e} "
                  f"mem~{mem_gb:.2f}GiB/dev (trace {record['trace_s']:.1f}s, layers "
                  f"{totals['traced_layers']})")
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        record.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {arch} x {cell.name} x {mesh.tag}: FAIL {type(e).__name__}: {e}")
    if save:
        _save(record)
    return record


def _save(record: dict):
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{record['arch']}__{record['cell']}__{record['mesh']}.json"
    (ARTIFACT_DIR / name).write_text(json.dumps(record, indent=2))


def _sweep_arch(arch: str, cells, meshes, verbose: bool) -> list[dict]:
    """One arch's records, mesh by mesh and cell by cell, unsaved."""
    measured: dict = {}
    return [dryrun_cell(arch, cell, multi_pod=multi_pod, measured=measured, save=False,
                        verbose=verbose)
            for multi_pod in meshes for cell in cells]


def sweep(archs, cells, meshes, *, verbose: bool = True, workers: int = 1) -> list[dict]:
    """Every (mesh, arch, cell) record, saved, each step measured once (a
    step is one mesh's, so an (arch, mesh) pair shares nothing with
    another).  ``workers`` > 1 records the (arch, mesh) pairs in that many
    processes, a pair to a process (the records are the same)."""
    pairs = [(arch, multi_pod) for multi_pod in meshes for arch in archs]
    args = ([a for a, _ in pairs], [cells] * len(pairs), [[m] for _, m in pairs],
            [verbose] * len(pairs))
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            per_pair = list(pool.map(_sweep_arch, *args))
    else:
        per_pair = [_sweep_arch(*a) for a in zip(*args)]
    records = [r for recs in per_pair for r in recs]
    for record in records:
        _save(record)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--workers", type=int, default=1, help="processes, an (arch, mesh) pair to each")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED_ARCHS

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else (args.arch,)
    cells = [c.name for c in SHAPE_CELLS] if (args.all or not args.cell) else [args.cell]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    records = sweep(archs, cells, meshes, workers=args.workers)
    n = {s: sum(r["status"] == s for r in records) for s in ("OK", "SKIP", "FAIL")}
    print(f"[dryrun] done: {n['OK']} OK, {n['SKIP']} SKIP, {n['FAIL']} FAIL "
          f"in {time.perf_counter() - t0:.1f} s")
    raise SystemExit(1 if n["FAIL"] else 0)


if __name__ == "__main__":
    main()
