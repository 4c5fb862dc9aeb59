"""Optimizers: AdamW (f32 or bf16 moments, optional f32 master weights) and a
factored Adafactor-lite, the port of the JAX package's ``optim/optimizer.py``.

Plain tensor functions over a params tree (nested dicts, tuples and lists of
tensors), not ``torch.optim``: the state is a tree of the same shape as the
JAX package's (``m``, ``v``, ``grad_norm``, ``master``), so the shared
checkpoint layout carries it, and an update takes and returns trees, as the
JAX package's pure functions do (nothing is updated in place).  Each update
clips the gradients to ``clip_norm`` by their global norm and records the
pre-clip norm; weight decay is decoupled and applies to matrices only; the
learning rate is a linear warm-up and a cosine decay.  The arithmetic is
f32, step by step as the JAX package writes it.

On shards (a sharded train step, ``models.lm.make_train_step(mesh=)``) an
update runs on each leaf's local block, and ``shard_axes`` (a tree giving,
for each leaf and each of its dims, the mesh axes that dim is cut over,
``distributed.sharding.dim_axes``) turns the clip's global norm into the
whole tree's: each leaf's squares are summed over the axes that leaf is cut
over, so a replicated leaf counts once.  AdamW is elementwise past the clip;
Adafactor's factored means over a cut dim (the row mean over the last dim,
the column mean and the normaliser over the one before) are psums of the
block's sums over that dim's axes, divided by the whole dim.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.bridge import leaves, rebuild


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"              # adamw | adafactor
    lr: float = 5e-4                 # paper: AdamW, cosine from 5e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    state_dtype: str = "float32"     # float32 | bfloat16
    master_weights: bool = False     # keep an f32 master copy when params are bf16


def _tree_map(fn, tree):
    return rebuild(tree, map(fn, leaves(tree)))


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """A python number or a tensor as an f32 tensor (on ``like``'s device)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=None if like is None else like.device)


def cosine_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a 0-d tensor), in f32: linear
    warm-up to ``cfg.lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    progress = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    progress = torch.clamp(progress, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * progress))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


@dataclass(frozen=True)
class Optimizer:
    config: OptimizerConfig
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]

    @staticmethod
    def last_grad_norm(opt_state) -> torch.Tensor:
        return opt_state["grad_norm"]


def _cut_axes(dims) -> tuple:
    """The axes a leaf is cut over (its ``shard_axes`` entry's, each once),
    ordered by name."""
    return tuple(sorted({a.name: a for axes in dims for a in axes}.values(),
                        key=lambda a: a.name))


def sharded_global_norm(grads, shard_axes) -> torch.Tensor:
    """:func:`global_norm` of the whole tree from this rank's shards: the
    leaves' squares summed by the tuple of axes they are sharded over, each
    sum over its axes, in a fixed order of the tuples (every rank alike)."""
    sums: dict = {}
    for g, dims in zip(leaves(grads), _leaves_as(shard_axes, grads)):
        axes = _cut_axes(dims)
        part = torch.sum(torch.square(g.to(torch.float32)))
        key = tuple(a.name for a in axes)
        sums[key] = (axes, sums[key][1] + part) if key in sums else (axes, part)
    total = None
    for key in sorted(sums):
        axes, part = sums[key]
        for ax in axes:
            part = ax.all_reduce(part, kind="grad")
        total = part if total is None else total + part
    return torch.sqrt(total)


def _clip(grads, clip_norm, shard_axes=None):
    if shard_axes is None or not any(map(_cut_axes, _leaves_as(shard_axes, grads))):
        gn = global_norm(grads)
    else:
        gn = sharded_global_norm(grads, shard_axes)
    scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return _tree_map(lambda g: g * scale, grads), gn


def _state_dtype(cfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _step_device(params):
    flat = leaves(params)
    return flat[0].device if flat else None


def make_adamw(cfg: OptimizerConfig) -> Optimizer:
    sdtype = _state_dtype(cfg)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=sdtype, device=p.device)
        state = {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
                 "grad_norm": torch.zeros((), dtype=torch.float32,
                                          device=_step_device(params))}
        if cfg.master_weights:
            state["master"] = _tree_map(lambda p: p.to(torch.float32).clone(), params)
        return state

    def update(grads, opt_state, params, *, step, shard_axes=None):
        """(new params, new state); ``step`` an int or a 0-d tensor;
        ``shard_axes``: on shards, the axes each leaf is sharded over."""
        grads, gn = _clip(grads, cfg.clip_norm, shard_axes)
        step = _f32(step, gn)
        t = step + 1
        lr = cosine_schedule(cfg, step)
        bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)

        def upd(g, m, v, p, master=None):
            g32 = g.to(torch.float32)
            m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
            v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g32)
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            ref = master if master is not None else p
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                delta = delta + cfg.weight_decay * ref.to(torch.float32)
            new_ref = ref.to(torch.float32) - lr * delta
            out = (new_ref.to(p.dtype), m_new.to(sdtype), v_new.to(sdtype))
            return out + (new_ref,) if master is not None else out

        trees = [grads, opt_state["m"], opt_state["v"], params]
        if cfg.master_weights:
            trees.append(opt_state["master"])
        outs = [upd(*args) for args in zip(*(_leaves_as(t, params) for t in trees))]
        pick = lambda i: rebuild(params, iter(o[i] for o in outs))
        new_state = {"m": pick(1), "v": pick(2), "grad_norm": gn}
        if cfg.master_weights:
            new_state["master"] = pick(3)
        return pick(0), new_state

    return Optimizer(cfg, init, update)


def _mean(x, dim: int, axes) -> torch.Tensor:
    """``x.mean(dim)`` of the whole tensor from this rank's block of it: the
    block's sum over ``dim`` summed over ``axes`` (the axes that cut ``dim``),
    divided by the whole dim; the plain mean where no axis cuts it."""
    if not axes:
        return x.mean(dim=dim)
    total, n = x.sum(dim=dim), x.shape[dim]
    for ax in axes:
        total, n = ax.all_reduce(total, kind="grad"), n * ax.size
    return total / n


def make_adafactor(cfg: OptimizerConfig) -> Optimizer:
    """Factored second moment (row and column means) for parameters of two
    or more axes, O(rows + cols) state each.  ``b1 == 0`` drops the first
    moment (classic Adafactor)."""
    sdtype = _state_dtype(cfg)
    use_momentum = cfg.b1 > 0.0

    def init(params):
        def vstate(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"row": torch.zeros(p.shape[:-1], **f32),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"full": torch.zeros(p.shape, **f32)}

        state = {"v": _tree_map(vstate, params),
                 "grad_norm": torch.zeros((), dtype=torch.float32,
                                          device=_step_device(params))}
        if use_momentum:
            state["m"] = _tree_map(lambda p: torch.zeros(p.shape, dtype=sdtype, device=p.device),
                                   params)
        return state

    def update(grads, opt_state, params, *, step, shard_axes=None):
        """(new params, new state); ``step`` an int or a 0-d tensor;
        ``shard_axes``: on shards, the axes each dim of each leaf is cut
        over."""
        grads, gn = _clip(grads, cfg.clip_norm, shard_axes)
        lr = cosine_schedule(cfg, _f32(step, gn))

        def upd(g, m, v, p, dims):
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + 1e-30
            if p.ndim >= 2:
                dims = tuple(dims) + ((),) * (p.ndim - len(dims))
                row = cfg.b2 * v["row"] + (1 - cfg.b2) * _mean(g2, -1, dims[-1])
                col = cfg.b2 * v["col"] + (1 - cfg.b2) * _mean(g2, -2, dims[-2])
                vhat = (row[..., None] * col[..., None, :]) / torch.clamp(
                    _mean(row, -1, dims[-2])[..., None, None], min=1e-30)
                v_new = {"row": row, "col": col}
            else:
                full = cfg.b2 * v["full"] + (1 - cfg.b2) * g2
                vhat = full
                v_new = {"full": full}
            delta = g32 / torch.clamp(torch.sqrt(vhat), min=1e-30)
            m_new = None
            if use_momentum:
                m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * delta
                delta = m_new
            if p.ndim >= 2:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p_new = p.to(torch.float32) - lr * delta
            return (p_new.to(p.dtype), None if m_new is None else m_new.to(sdtype), v_new)

        g_leaves, p_leaves = _leaves_as(grads, params), leaves(params)
        v_leaves = _leaves_as(opt_state["v"], params)
        m_leaves = (_leaves_as(opt_state["m"], params) if use_momentum
                    else [None] * len(g_leaves))
        d_leaves = (_leaves_as(shard_axes, params) if shard_axes is not None
                    else [()] * len(g_leaves))
        outs = [upd(*args) for args in zip(g_leaves, m_leaves, v_leaves, p_leaves, d_leaves)]
        pick = lambda i: rebuild(params, iter(o[i] for o in outs))
        new_state = {"v": pick(2), "grad_norm": gn}
        if use_momentum:
            new_state["m"] = pick(1)
        return pick(0), new_state

    return Optimizer(cfg, init, update)


def _leaves_as(tree, like) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``like``, in
    ``like``'s order, a dict's entries found by key (the Adafactor ``v``
    state holds a dict per parameter)."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves_as(tree[k], like[k])]
    if isinstance(like, (tuple, list)):
        return [x for t, lk in zip(tree, like) for x in _leaves_as(t, lk)]
    return [tree]


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.kind == "adamw":
        return make_adamw(cfg)
    if cfg.kind == "adafactor":
        return make_adafactor(cfg)
    raise ValueError(cfg.kind)


def opt_pspecs(param_specs, kind: str = "adamw"):
    """Moment shardings mirror the parameter shardings: ``param_specs`` is a
    tree of ``PartitionSpec`` entries (``distributed.sharding.spec``'s
    tuples), and the state's specs come back in the same form."""
    if kind == "adamw":
        return {"m": param_specs, "v": param_specs, "grad_norm": ()}
    if kind == "adafactor":
        def vspec(s):
            spec = tuple(s)
            return {"row": spec[:-1] if len(spec) >= 2 else spec,
                    "col": spec[:-2] + spec[-1:] if len(spec) >= 2 else spec}

        return {"m": param_specs, "v": _map_specs(vspec, param_specs), "grad_norm": ()}
    raise ValueError(kind)


def _map_specs(fn, specs):
    """``fn`` over a tree whose leaves are spec tuples (dicts and lists hold
    them; a tuple is a leaf)."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)
