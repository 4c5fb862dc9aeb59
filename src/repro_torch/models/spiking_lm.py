"""Spiking transformer blocks at LM shape (PyTorch): the training and oracle
view of the JAX package's ``models/spiking_lm.py``.

Per block (every inter-layer tensor binary):

    q/k/v  = LIF(RMSNorm(Linear(x)))            (tick-batched GEMMs)
    attn   = LIF(causal-SSA(q, k, v))           (softmax-free, masked QK^T V)
    branch = LIF(RMSNorm(Linear(attn)))
    x      = IAND(x, branch)                    (AND-NOT residual)
    h      = LIF(RMSNorm(Linear1(x)))
    branch = LIF(RMSNorm(Linear2(h)))
    x      = IAND(x, branch)

T time steps fold into the batch of every GEMM; only the LIF chains see the
unfolded T axis.  The deploy view is an engine plan
(``repro_torch.engine.compile_plan`` on a spiking ``ArchConfig``), held
against this graph by the tests.  The parameters keep the JAX package's
tree: ``layers`` stacks every block's leaves along a leading L axis (the
JAX package scans over it), so :mod:`repro_torch.bridge` carries them across
as they are, and so do their gradients.  :func:`loss_fn` is the training
loss (next-token cross-entropy on the rate-decoded logits).

``use_kernel=True`` (on :func:`forward`, :func:`block_apply` and
:func:`loss_fn`) routes every LIF through the LIF kernel wrappers (forward
kernel, backward kernel: ``kernels.lif_parallel.ops._LifOp``) and the
quadratic causal SSA through the attention kernel
(``kernels.spiking_attention.ops._SsaOp``); on a CPU tensor those wrappers
run their plain versions.  The linear ordering stays plain on both routes,
as ``core/lif.py::lif(use_kernel=)`` and the vision config's ``use_kernel``
have it.  The default is the JAX package's graph.
"""

from __future__ import annotations

import torch

from repro_torch.bridge import layer_params
from repro_torch.core.iand import iand
from repro_torch.core.lif import lif
from repro_torch.core.spiking_attention import ssa
from repro_torch.engine.layout import lm_block_layout
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import rmsnorm_apply, rmsnorm_init

# Spikformer's fixed attention scale (no softmax, so it is a plain gain); the
# deploy engine reads it from here so both views share one value.
ATTN_SCALE = 0.125


def _fold(x):      # (T, B, S, D) -> (T*B, S, D)
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _unfold(x, t):
    return x.reshape((t, -1) + tuple(x.shape[1:]))


def _lif(drive, cfg: ArchConfig, use_kernel: bool):
    return lif(drive, chain_len=cfg.spike_chain_len, use_kernel=use_kernel)


def _lin_init(generator: torch.Generator, d_in: int, d_out: int, dtype, *,
              layers: int | None = None):
    """One Linear+RMSNorm unit: weight N(0, 1/d_in), RMSNorm scale 1, on the
    generator's device.  ``layers`` stacks that many units along a leading
    axis in one draw (the ``layers`` tree of :func:`init_spiking_lm`)."""
    lead = () if layers is None else (layers,)
    dev = generator.device
    w = torch.randn(lead + (d_in, d_out), generator=generator, dtype=dtype, device=dev)
    return {"w": w * (d_in ** -0.5),
            "norm": {"scale": torch.ones(lead + (d_out,), dtype=dtype, device=dev)}}


def _lin_norm_lif(p, x, cfg: ArchConfig, *, use_kernel: bool = False):
    """Tick-batched Linear -> RMSNorm -> LIF. x: (T, B, S, Din) spikes."""
    t = x.shape[0]
    y = _fold(x) @ p["w"].to(x.dtype)
    y = rmsnorm_apply(p["norm"], y, eps=cfg.norm_eps)
    return _lif(_unfold(y, t), cfg, use_kernel)


def causal_ssa(q, k, v, *, scale: float, ordering: str = "quadratic", chunk: int = 512,
               use_kernel: bool = False):
    """Softmax-free causal spiking attention. q/k/v: (T, B, H, S, Dh).
    ``use_kernel`` takes the attention kernel for the quadratic ordering."""
    if use_kernel and ordering == "quadratic":
        from repro_torch.kernels.spiking_attention.ops import ssa_op

        return ssa_op(q, k, v, scale=scale, causal=True)
    return ssa(q, k, v, scale=scale, ordering=ordering, causal=True, chunk=chunk)


def _param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16


def init_spiking_lm(generator: torch.Generator, cfg: ArchConfig):
    """Random parameters in the JAX package's tree, drawn from ``generator``
    on its own device (a ``torch.Generator(device)``: at full width the
    1.3 B parameters are made on the card, never on the host).  Embedding
    N(0, 0.02^2); each (d_in, d_out) weight N(0, 1/d_in); RMSNorm scales 1.
    The numbers are not the JAX package's for the same seed: tests carry the
    JAX parameters across through numpy instead."""
    dtype, dev = _param_dtype(cfg), generator.device
    randn = lambda *shape: torch.randn(shape, generator=generator, dtype=dtype, device=dev)
    layers = {u.name: _lin_init(generator, u.d_in, u.d_out, dtype, layers=cfg.num_layers)
              for u in lm_block_layout(cfg)}
    return {
        "embed": {"table": randn(cfg.vocab_size, cfg.d_model) * 0.02,
                  "norm": rmsnorm_init(cfg.d_model, dtype, dev)},
        "layers": layers,
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "lm_head": {"w": randn(cfg.d_model, cfg.vocab_size) * (cfg.d_model ** -0.5)},
    }


def block_init(generator: torch.Generator, cfg: ArchConfig, dtype):
    """One block's parameters (unstacked), a unit per entry of the shared
    ``lm_block_layout``."""
    return {u.name: _lin_init(generator, u.d_in, u.d_out, dtype) for u in lm_block_layout(cfg)}


def block_apply(p, x, cfg: ArchConfig, *, ordering: str, use_kernel: bool = False):
    """x: (T, B, S, D) spikes -> same."""
    t, b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    kw = dict(use_kernel=use_kernel)
    q = _lin_norm_lif(p["q"], x, cfg, **kw)
    k = _lin_norm_lif(p["k"], x, cfg, **kw)
    v = _lin_norm_lif(p["v"], x, cfg, **kw)
    split = lambda z: z.reshape(t, b, s, h, dh).permute(0, 1, 3, 2, 4)
    attn = causal_ssa(split(q), split(k), split(v), scale=ATTN_SCALE, ordering=ordering, **kw)
    attn = attn.permute(0, 1, 3, 2, 4).reshape(t, b, s, d)
    attn = _lif(attn, cfg, use_kernel)                           # attn spikes
    branch = _lin_norm_lif(p["proj"], attn, cfg, **kw)
    x = iand(x, branch)                                          # AND-NOT residual
    hdn = _lin_norm_lif(p["fc1"], x, cfg, **kw)
    branch = _lin_norm_lif(p["fc2"], hdn, cfg, **kw)
    return iand(x, branch)


def forward(params, batch, cfg: ArchConfig, *, ordering: str = "quadratic",
            use_kernel: bool = False):
    """tokens (B, S) -> logits (B, S, V), rate-decoded over T time steps."""
    t = cfg.spike_t
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    emb = params["embed"]["table"][torch.as_tensor(tokens, dtype=torch.long,
                                                   device=params["embed"]["table"].device)]
    drive = emb[None].expand((t,) + tuple(emb.shape))
    drive = rmsnorm_apply(params["embed"]["norm"], drive, eps=cfg.norm_eps)
    x = _lif(drive, cfg, use_kernel)                             # encoding layer
    for i in range(cfg.num_layers):
        x = block_apply(layer_params(params["layers"], i), x, cfg, ordering=ordering,
                        use_kernel=use_kernel)
    rate = x.mean(dim=0)                                         # rate decoding
    rate = rmsnorm_apply(params["final_norm"], rate, eps=cfg.norm_eps)
    return rate @ params["lm_head"]["w"].to(rate.dtype)


def loss_fn(params, batch, cfg: ArchConfig, *, ordering: str = "quadratic",
            use_kernel: bool = False):
    """Next-token cross-entropy of :func:`forward`'s logits (the last
    position masked out).  Returns ``(ce, {"loss": ce})``, as the JAX
    package's ``loss_fn``; differentiate it with ``torch.autograd``."""
    from repro_torch.models.lm import _shift_labels, cross_entropy

    logits = forward(params, batch, cfg, ordering=ordering, use_kernel=use_kernel)
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    labels, mask = _shift_labels(torch.as_tensor(tokens, device=logits.device))
    ce = cross_entropy(logits, labels, mask)
    return ce, {"loss": ce}
