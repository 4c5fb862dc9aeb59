"""Deterministic synthetic data pipelines -- the token and image streams, a
copy of the JAX package's ``data/pipeline.py`` in numpy alone.

Batches are a pure function of (seed, step, shard), so any process can
regenerate exactly its shard of any step, and a restart needs no data-loader
state beyond the step counter.  Images are low-frequency oriented gratings
plus noise whose orientation depends on the class, so the Spikformer
examples have real signal to fit; tokens are a Zipf-ish unigram mixture with
BOS-separated documents of geometric length (the spiking LM's prompts).  The
same (config, step) gives the same arrays as the JAX package's
:func:`make_batch`, bit for bit.  The modality stubs come with the generic LM
substrate.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    bos_id: int = 1
    mean_doc_len: int = 256
    kind: str = "tokens"           # tokens | images | audio_stub | vision_stub
    # images
    img_size: int = 32
    num_classes: int = 10
    # stubs
    d_model: int = 0
    num_prefix_tokens: int = 0


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard, 0xC0FFEE]))


def token_batch(cfg: DataConfig, step: int, *, shard: int = 0, num_shards: int = 1):
    """Returns {'tokens': (B/num_shards, S) int32} for this shard of the step."""
    b = cfg.global_batch // num_shards
    rng = _rng(cfg, step, shard)
    z = rng.zipf(1.3, size=(b, cfg.seq_len)).astype(np.int64)
    tokens = (z % (cfg.vocab_size - 2)) + 2
    doc_break = rng.random((b, cfg.seq_len)) < (1.0 / cfg.mean_doc_len)
    tokens = np.where(doc_break, cfg.bos_id, tokens)
    tokens[:, 0] = cfg.bos_id
    return {"tokens": tokens.astype(np.int32)}


def image_batch(cfg: DataConfig, step: int, *, shard: int = 0, num_shards: int = 1):
    """Returns {'image': (B, H, W, 3) f32 in [0, 1], 'label': (B,) int32}
    for this shard of the step: class-dependent oriented gratings + noise."""
    b = cfg.global_batch // num_shards
    rng = _rng(cfg, step, shard)
    labels = rng.integers(0, cfg.num_classes, size=(b,))
    yy, xx = np.mgrid[0:cfg.img_size, 0:cfg.img_size].astype(np.float32)
    angles = labels.astype(np.float32) / cfg.num_classes * np.pi
    phase = rng.random((b, 1, 1)).astype(np.float32) * 2 * np.pi
    freq = 2 * np.pi / 8.0
    grating = 0.5 + 0.5 * np.sin(
        freq * (np.cos(angles)[:, None, None] * xx + np.sin(angles)[:, None, None] * yy)
        + phase)
    noise = rng.random((b, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    img = 0.7 * grating[..., None] + 0.3 * noise
    return {"image": img.astype(np.float32), "label": labels.astype(np.int32)}


def make_batch(cfg: DataConfig, step: int, *, shard: int = 0, num_shards: int = 1):
    fn = {"tokens": token_batch, "images": image_batch}.get(cfg.kind)
    if fn is None:
        raise NotImplementedError(
            f"kind={cfg.kind!r}: the modality stubs come with the generic LM "
            "substrate; this package has kind='tokens' and kind='images'")
    return fn(cfg, step, shard=shard, num_shards=num_shards)
