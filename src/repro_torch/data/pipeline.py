"""Deterministic synthetic data pipelines -- the token and image streams, a
copy of the JAX package's ``data/pipeline.py`` in numpy alone.

Batches are a pure function of (seed, step, shard), so any process can
regenerate exactly its shard of any step, and a restart needs no data-loader
state beyond the step counter.  Images are low-frequency oriented gratings
plus noise whose orientation depends on the class, so the Spikformer
examples have real signal to fit; tokens are a Zipf-ish unigram mixture with
BOS-separated documents of geometric length (the spiking LM's prompts); the
modality stubs (``audio_stub``, ``vision_stub``) are precomputed-embedding
frontends.  The same (config, step) gives the same arrays as the JAX
package's :func:`make_batch`, bit for bit.  :class:`Prefetcher` makes future
steps on a background thread, in step order.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
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


def modality_batch(cfg: DataConfig, step: int, *, shard: int = 0, num_shards: int = 1):
    """audio_stub: {'embeds': (B, S, d_model) f32, 'labels': (B, S) int32};
    vision_stub: {'image_embeds': (B, P, d_model) f32, 'tokens': (B, S - P)
    int32}, P = ``num_prefix_tokens``."""
    b = cfg.global_batch // num_shards
    rng = _rng(cfg, step, shard)
    if cfg.kind == "audio_stub":
        return {
            "embeds": rng.standard_normal((b, cfg.seq_len, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, size=(b, cfg.seq_len)).astype(np.int32),
        }
    if cfg.kind == "vision_stub":
        p = cfg.num_prefix_tokens
        text = dataclasses.replace(cfg, seq_len=cfg.seq_len - p)
        return {
            "image_embeds": rng.standard_normal((b, p, cfg.d_model)).astype(np.float32),
            "tokens": token_batch(text, step, shard=shard, num_shards=1)["tokens"][:b],
        }
    raise ValueError(cfg.kind)


def make_batch(cfg: DataConfig, step: int, *, shard: int = 0, num_shards: int = 1):
    fn = {"tokens": token_batch, "images": image_batch,
          "audio_stub": modality_batch, "vision_stub": modality_batch}[cfg.kind]
    return fn(cfg, step, shard=shard, num_shards=num_shards)


class Prefetcher:
    """Background-thread prefetch of future steps (host generation overlaps
    the device's work): :meth:`next` returns ``(step, batch)`` in step order
    from ``start_step`` on, at most ``depth`` steps ahead; :meth:`stop`
    ends the thread."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._shard, self._num_shards = shard, num_shards
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step, shard=self._shard, num_shards=self._num_shards)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
