"""The LM config registry (``register``, ``get_config``), as in the JAX
package's ``models/lm.py``; the LM entry points come with the generic LM
substrate."""

from __future__ import annotations

from typing import Callable

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
