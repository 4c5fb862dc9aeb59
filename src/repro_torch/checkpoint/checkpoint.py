"""Atomic checkpoints in the JAX package's on-disk layout.

Layout (the same files the JAX package's ``checkpoint/checkpoint.py``
writes and reads, so each package restores the other's checkpoints):

    <dir>/step_<N>/
        manifest.json     -- step, meta, and per leaf: name, file, shape, dtype
        arr_<idx>.npy     -- one file per leaf
    <dir>/LATEST          -- atomic pointer file

A leaf's name is its path as ``jax.tree_util.tree_flatten_with_path`` prints
it, ``"/"``-joined (``['block0']/['q']/['lin']/['w']`` for nested dicts,
``[0]`` for a sequence index), and leaves go in sorted-key order, as JAX
flattens a dict.  dtypes that ``.npy`` cannot hold (bfloat16, the float8s)
are stored as an unsigned bit view of their width and named in the manifest;
the bits go through torch's own views, so no ``ml_dtypes`` is needed.

Atomic: a step is written to ``step_<N>.tmp.<pid>``, fsync'd, then renamed,
and ``LATEST`` is replaced by a rename, so a crashed writer never corrupts
it.  Keep-k GC prunes old steps after a successful save.
:class:`AsyncSaver` writes on a background thread from a host copy taken
when the save is asked for.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

# dtype name -> (its torch dtype, the signed bit view in torch and in numpy,
# the unsigned numpy view that the .npy file holds)
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.int8, np.uint8),
}
_VIEW_NAMES = {view[0]: name for name, view in _VIEW_DTYPES.items()}


def _name(path) -> str:
    return "/".join(path)


def flatten_with_names(tree, path=()):
    """[(name, leaf)] of a tree of dicts, tuples and lists, in JAX's order
    (a dict's keys sorted)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_names(tree[k], path + (f"[{k!r}]",))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_names(v, path + (f"[{i}]",))]
    return [(_name(path), tree)]


def _map_with_names(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, path + (f"[{k!r}]",)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_names(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(_name(path), tree)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, true dtype name) of a tensor or array leaf."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype in _VIEW_NAMES:
        name = _VIEW_NAMES[t.dtype]
        _, signed, _, unsigned = _VIEW_DTYPES[name]
        return t.view(signed).numpy().view(unsigned), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str | os.PathLike, step: int, tree, *, keep: int = 3,
         extra_meta: dict | None = None) -> Path:
    """Blocking checkpoint write of a tree of tensors (or arrays). Returns
    the final step directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    manifest = {"step": step, "leaves": [], "meta": extra_meta or {}}
    for i, (name, leaf) in enumerate(flatten_with_names(tree)):
        arr, true_dtype = _to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"name": name, "file": fname, "shape": list(arr.shape),
                                   "dtype": true_dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # fsync the directory entries before the atomic publish
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = ckpt_dir / f".LATEST.tmp.{os.getpid()}"
    latest_tmp.write_text(final.name)
    os.rename(latest_tmp, ckpt_dir / "LATEST")
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_????????") if p.is_dir())
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    pointer = ckpt_dir / "LATEST"
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    if not (ckpt_dir / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def _load_leaf(path: Path, entry: dict, sharding=None) -> torch.Tensor:
    """One stored leaf as a tensor; under a ``sharding``
    (``distributed.sharding.NamedSharding``) only this rank's block of it,
    read from a memory map so the rest of the file is never loaded."""
    arr = np.load(path, mmap_mode="r" if sharding is not None else None)
    if sharding is not None:
        arr = np.ascontiguousarray(arr[sharding.local_slices(arr.shape)])
    if entry["dtype"] in _VIEW_DTYPES:
        torch_dtype, _, signed, _ = _VIEW_DTYPES[entry["dtype"]]
        return torch.from_numpy(arr.view(signed)).view(torch_dtype)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str | os.PathLike, target, *, step: int | None = None,
            shardings=None):
    """Restore into the structure of ``target``, a tree of tensors: each leaf
    comes back with its target's dtype and device (latest step by default).
    ``shardings``: optional tree of the same structure whose leaves are
    ``distributed.sharding.NamedSharding`` (or None: the whole leaf) --
    each rank loads only its block of each sharded leaf (elastic remesh: the
    mesh the checkpoint was saved from is irrelevant).  Returns (tree,
    manifest)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}

    shard_of = dict(flatten_with_names(shardings)) if shardings is not None else {}

    def load(name, leaf):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        entry = by_name[name]
        if tuple(entry["shape"]) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(entry['shape'])} != target "
                             f"{tuple(leaf.shape)}")
        arr = _load_leaf(d / entry["file"], entry, shard_of.get(name))
        return arr.to(device=leaf.device, dtype=leaf.dtype)

    return _map_with_names(load, target), manifest


def _host_copy(tree):
    """Every tensor leaf copied to the host (the tree's structure kept), so
    that later updates of the device tensors cannot reach a pending save."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class AsyncSaver:
    """One in-flight asynchronous save at a time: :meth:`save_async` waits
    for the previous one, copies the tree to the host, and writes it with
    :func:`save` on a background thread; :meth:`wait` joins it and raises
    the error of a failed save."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def save_async(self, ckpt_dir, step, tree, **kw):
        self.wait()
        host_tree = _host_copy(tree)

        def _run():
            try:
                save(ckpt_dir, step, host_tree, **kw)
            except BaseException as e:  # noqa: BLE001  (re-raised by wait)
                self._err = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
