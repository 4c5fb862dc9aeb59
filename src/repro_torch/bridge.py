"""Weights across the two packages: nested dicts of arrays <-> tensors.

The JAX package keeps ``params``/``state`` as nested dicts (and tuples) of
arrays; after ``jax.tree_util.tree_map(np.asarray, tree)`` they are numpy
arrays, which :func:`to_torch` turns into the port's tensors on a device.
:func:`to_numpy` goes back.  The tree structure and key names are the same
in both packages, so no renaming happens here.  Training needs nothing more:
parameter, gradient and BatchNorm-state trees are such trees, and cross in
both directions through :func:`to_torch` and :func:`to_numpy`.  So do the
spiking LM's parameters (``init_spiking_lm``): their ``layers`` tree stacks
every block's leaves along a leading L axis in both packages, and so do the
gradient trees ``jax.value_and_grad`` and the port's ``loss_and_grad``
return.  :func:`leaves` and :func:`rebuild` take such a tree apart and put it
back together (training steps and the optimizers map over the leaves), and
:func:`layer_params` takes one block's leaves out of a stacked ``layers``
tree.  :func:`resolve_device` is where every entry point of the port picks
its device: the card unless the caller names another.

Packed spike words cross as bit patterns: the JAX package keeps them as
``uint32``, the port as ``int32`` (PyTorch on the CPU has no shifts or NOT
for ``uint32``).  :func:`words_to_numpy` and :func:`words_to_torch` convert
between the two with a numpy ``.view``, never a value cast.
"""

from __future__ import annotations

import numpy as np
import torch


def leaves(tree) -> list:
    """The leaves of a tree of dicts, tuples and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, new_leaves):
    """``tree``'s structure with the leaves of ``new_leaves`` (an iterator, in
    :func:`leaves` order)."""
    if isinstance(tree, dict):
        return {k: rebuild(v, new_leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, new_leaves) for v in tree)
    return next(new_leaves)


def layer_params(layers, i: int):
    """Block ``i``'s leaves of the stacked ``layers`` tree."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises (the port
    never drops quietly to the CPU: pass ``device="cpu"`` for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def to_torch(tree, device=None, dtype=torch.float32):
    """Numpy arrays (or tensors) -> tensors of ``dtype`` on ``device``,
    keeping the dict/tuple/list structure.  ``dtype=None`` keeps each leaf's
    own dtype: a bf16 leaf (numpy's ``ml_dtypes.bfloat16``, which
    ``torch.tensor`` cannot take) crosses as its bits, by a ``uint16``
    view.  Arrays are copied, so the result never aliases read-only numpy
    memory."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=dtype or tree.dtype)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype or torch.bfloat16)
    return torch.tensor(a, dtype=dtype, device=device)


def to_numpy(tree):
    """Tensors -> numpy arrays on the host, keeping the structure; a bf16
    tensor becomes an ``ml_dtypes.bfloat16`` array of the same bits."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Port words (int32 tensor) -> the JAX package's uint32 words, same bits."""
    if words.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {words.dtype}")
    return words.detach().cpu().numpy().view(np.uint32)


def words_to_torch(words, device=None) -> torch.Tensor:
    """uint32 words (numpy or a JAX array) -> the port's int32 words on
    ``device``, same bits; the array is copied."""
    a = np.array(words, copy=True)
    if a.dtype != np.uint32:
        raise TypeError(f"packed words must be uint32, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32)).to(device)
