"""The LM config registry (``register``, ``get_config``) and the LM loss
(``_shift_labels``, ``cross_entropy``), as in the JAX package's
``models/lm.py``; the generic LM entry points come with the generic LM
substrate."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ArchConfig

_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    from repro_torch.configs import llama3_2_1b  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch.configs import llama3_2_1b  # noqa: F401

    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _shift_labels(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token labels and an f32 mask (the last position masked out; its
    label wraps to the first token, as the JAX package's does)."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]), torch.zeros_like(tokens[:, :1])], dim=1)
    return labels, mask.to(torch.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Stable masked cross-entropy: ``logsumexp`` over f32 logits, the
    masked sum divided by ``max(mask.sum(), 1)``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
