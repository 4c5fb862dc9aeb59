"""The paper's own models: Spike-IAND-Former 8-384 / 8-512 / 8-768 (Table I)
plus the Spikformer (residual-ADD) baselines, as vision configs -- the same
registry as the JAX package's ``configs/spike_iand_former.py``.
"""

from __future__ import annotations

from repro_torch.core.spikformer import SpikformerConfig

_VISION: dict[str, SpikformerConfig] = {}


def _add(name: str, cfg: SpikformerConfig):
    _VISION[name] = cfg
    return cfg


# ImageNet-geometry configs (224x224 -> 14x14 tokens via 4 pooling stages)
_IMAGENET = dict(img_size=224, num_classes=1000,
                 tokenizer_pools=(True, True, True, True))

_add("spike-iand-former-8-384", SpikformerConfig(
    embed_dim=384, num_layers=8, num_heads=12, residual="iand", **_IMAGENET))
_add("spike-iand-former-8-512", SpikformerConfig(
    embed_dim=512, num_layers=8, num_heads=8, residual="iand", **_IMAGENET))
_add("spike-iand-former-8-768", SpikformerConfig(
    embed_dim=768, num_layers=8, num_heads=12, residual="iand", **_IMAGENET))
# Spikformer baselines (residual ADD) for the Table-I comparison
_add("spikformer-8-384", SpikformerConfig(
    embed_dim=384, num_layers=8, num_heads=12, residual="add", **_IMAGENET))
_add("spikformer-8-512", SpikformerConfig(
    embed_dim=512, num_layers=8, num_heads=8, residual="add", **_IMAGENET))

# CIFAR-10 geometry (32x32 -> 8x8 tokens), the hardware eval target
_add("spike-iand-former-cifar10", SpikformerConfig(
    img_size=32, num_classes=10, embed_dim=384, num_layers=4, num_heads=12,
    residual="iand", tokenizer_pools=(False, False, True, True)))

# Reduced smoke model
_add("spike-iand-former_smoke", SpikformerConfig(
    img_size=32, num_classes=10, embed_dim=64, num_layers=2, num_heads=4,
    residual="iand", tokenizer_pools=(False, False, True, True)))


def get_vision_config(name: str) -> SpikformerConfig:
    if name not in _VISION:
        raise KeyError(f"unknown vision config '{name}'; have {sorted(_VISION)}")
    return _VISION[name]


def list_vision_configs() -> list[str]:
    return sorted(_VISION)
