"""Deploy-plan executor: folded weights in, logits out.

Walks the same layer list (``engine.layout``) as the eval graph, in the
accelerator's deploy view:

* each stage/unit is ONE folded weight read (Conv/Linear with the BN baked
  in) -- no separate BN pass over the activations;
* every AND-NOT residual executes inside the LIF dispatch's epilogue
  (``iand_skip``), so spikes are written once -- no standalone IAND pass;
* all Conv/Linear compute is tick-batched (T folded into the batch: one
  weight read serves all time steps).

On a ``packed`` backend the spikes between layers are bit-packed along time
(``repro_torch.core.packing``): every LIF epilogue emits words, the residual
is the bitwise AND-NOT on words, and the head rate-decodes by popcount, so
the packed executor never unpacks a train itself.  Under ``Backend.sparse``
every LIF pack epilogue also attaches the occupancy map of its words, which
rides along with the train (``reshape_elems`` keeps it, the head split drops
it) to the sparse consumers.

All compute -- linears, convs and attention -- goes through
``repro_torch.engine.backend``; the executor never calls a kernel or a plain
version directly, so the plan's backend decides the compute route.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.core import nn as cnn
from repro_torch.core import packing
from repro_torch.core.iand import connective
from repro_torch.core.spiking_attention import merge_heads, split_heads, split_heads_packed
from repro_torch.engine import backend as B
from repro_torch.engine.plan import DeployPlan, PlanMeta


# active spike tap (``capture_spikes``): every packed train a LIF epilogue
# emits is appended here -- None when no capture is active
_spike_tap: list | None = None


@contextlib.contextmanager
def capture_spikes():
    """Capture every packed spike train the executor's LIF epilogues emit.

    ``with capture_spikes() as taps: engine.apply(plan, batch)`` leaves
    ``taps`` holding one ``PackedSpikes`` per LIF dispatch, in execution
    order -- the input of ``engine.analysis.sparsity_report``."""
    global _spike_tap
    prev, _spike_tap = _spike_tap, []
    try:
        yield _spike_tap
    finally:
        _spike_tap = prev


def _lif(meta: PlanMeta, drive, iand_skip=None, pack_output: bool = False,
         occupancy: bool | None = None):
    cfg = meta.cfg
    out = B.lif_apply(meta.backend, drive, theta=cfg.theta, lam=cfg.lam,
                      schedule=cfg.lif_schedule, chain_len=cfg.chain_len,
                      iand_skip=iand_skip, pack_output=pack_output, occupancy=occupancy)
    if _spike_tap is not None and isinstance(out, packing.PackedSpikes):
        _spike_tap.append(out)
    return out


def _tokenizer_exec(meta: PlanMeta, tok_params, image):
    """image: (B, H, W, C) analog in [0, 1] -> spikes (T, B, N, D)."""
    cfg = meta.cfg
    x = None
    for stage, p in zip(meta.tok_stages, tok_params):
        if stage.encode:
            # encoding layer: analog conv once, broadcast across T (the input
            # is not binary, so it stays on the plain conv on every backend)
            y = cnn.conv_apply(p, image)
            if stage.pool:
                y = cnn.maxpool(y)
            drive = y[None].expand((cfg.t,) + tuple(y.shape))
        else:
            y = B.conv3x3_apply(meta.backend, p, cnn.fold_time(x))  # one weight read
            if stage.pool:
                y = cnn.maxpool(y)
            drive = cnn.unfold_time(y, cfg.t)
        x = _lif(meta, drive)
    t, b, h, w, d = x.shape
    return x.reshape(t, b, h * w, d)


def _unit_linear(meta: PlanMeta, p, x):
    """Tick-batched folded linear on (T, B, N, Din) spikes."""
    t, b, n, _ = x.shape
    return B.linear_apply(meta.backend, p, x.reshape(t * b * n, -1)).reshape(t, b, n, -1)


def _block_exec(meta: PlanMeta, bparams, x):
    """One block in deploy form. x: (T, B, N, D) spikes."""
    cfg = meta.cfg
    res = connective(cfg.residual)   # only reached for residual="add"
    acts: dict = {}
    h = None
    for u in meta.block_units:
        if u.role == "qkv":
            acts[u.name] = _lif(meta, _unit_linear(meta, bparams[u.name], x))
            continue
        if u.role == "attn_out":
            attn = B.ssa_apply(
                meta.backend, *(split_heads(acts[n], cfg.num_heads) for n in "qkv"),
                scale=cfg.attn_scale, ordering=cfg.attn_ordering)
            attn = _lif(meta, merge_heads(attn))          # attn spikes
            drive = _unit_linear(meta, bparams[u.name], attn)
        elif u.role == "mlp_hidden":
            h = _lif(meta, _unit_linear(meta, bparams[u.name], x))
            continue
        elif u.role == "mlp_out":
            drive = _unit_linear(meta, bparams[u.name], h)
        else:
            raise ValueError(f"unknown unit role: {u.role}")
        if u.fuse_residual:      # AND-NOT inside the LIF epilogue
            x = _lif(meta, drive, iand_skip=x)
        else:
            x = res(x, _lif(meta, drive))
    return x


# -- packed datapath ---------------------------------------------------------

def _tokenizer_exec_packed(meta: PlanMeta, tok_params, image) -> packing.PackedSpikes:
    """image: (B, H, W, C) analog -> packed spikes, words (W, B, N, D)."""
    cfg = meta.cfg
    xp = None
    for stage, p in zip(meta.tok_stages, tok_params):
        if stage.encode:
            # analog encoding conv: same as the dense path (input not binary)
            y = cnn.conv_apply(p, image)
            if stage.pool:
                y = cnn.maxpool(y)
            drive = y[None].expand((cfg.t,) + tuple(y.shape))
        else:
            drive = B.conv3x3_apply_packed(meta.backend, p, xp)   # (T, B, H, W, C)
            if stage.pool:
                drive = cnn.unfold_time(cnn.maxpool(cnn.fold_time(drive)), cfg.t)
        xp = _lif(meta, drive, pack_output=True)
    _, b, h, wd, d = xp.words.shape
    return xp.reshape_elems(b, h * wd, d)


def _unit_linear_packed(meta: PlanMeta, p, xp: packing.PackedSpikes):
    """Packed-operand folded linear: words (W, B, N, Din) -> drive (T, B, N, Dout)."""
    return B.linear_apply_packed(meta.backend, p, xp)


def _block_exec_packed(meta: PlanMeta, bparams, xp: packing.PackedSpikes):
    """One block on packed activations.  Only reached for residual='iand'
    (compile_plan rejects packed ADD plans), so every residual join is the
    bitwise AND-NOT in a LIF epilogue."""
    cfg = meta.cfg
    acts: dict = {}
    h = None
    for u in meta.block_units:
        if u.role == "qkv":
            acts[u.name] = _lif(meta, _unit_linear_packed(meta, bparams[u.name], xp),
                                pack_output=True)
            continue
        if u.role == "attn_out":
            # q/k/v stay packed through the head split; the backend feeds the
            # words to the packed SSA kernel (or unpacks at its own op boundary)
            attn = B.ssa_apply_packed(
                meta.backend, *(split_heads_packed(acts[n], cfg.num_heads) for n in "qkv"),
                scale=cfg.attn_scale, ordering=cfg.attn_ordering)
            attn_sp = _lif(meta, merge_heads(attn), pack_output=True)
            drive = _unit_linear_packed(meta, bparams[u.name], attn_sp)
        elif u.role == "mlp_hidden":
            h = _lif(meta, _unit_linear_packed(meta, bparams[u.name], xp),
                     pack_output=True)
            continue
        elif u.role == "mlp_out":
            drive = _unit_linear_packed(meta, bparams[u.name], h)
        else:
            raise ValueError(f"unknown unit role: {u.role}")
        xp = _lif(meta, drive, iand_skip=xp, pack_output=True)
    return xp


def _rate_head(head_params, counts: torch.Tensor, steps: int):
    """Rate decoding: spike counts summed over (T, tokens) -> mean rate ->
    logits.  ``counts``: (B, N, D) per-token counts over T (exact integers),
    ``steps`` = T * N.  The dense and packed heads share this one division,
    so they agree bit for bit."""
    return cnn.linear_apply(head_params, counts.sum(dim=1).float() / steps)


def _head_packed(meta: PlanMeta, head_params, xp: packing.PackedSpikes):
    """Rate decoding by popcount: mean over (T, tokens) without unpacking."""
    return _rate_head(head_params, packing.spike_counts(xp), xp.t * xp.elem_shape[1])


def _execute(meta: PlanMeta, params, batch):
    if meta.backend.packed:
        xp = _tokenizer_exec_packed(meta, params["tokenizer"], batch)
        for bparams in params["blocks"]:
            xp = _block_exec_packed(meta, bparams, xp)
        return _head_packed(meta, params["head"], xp)
    x = _tokenizer_exec(meta, params["tokenizer"], batch)
    for bparams in params["blocks"]:
        x = _block_exec(meta, bparams, x)
    t, _, n, _ = x.shape                     # rate decoding over (T, tokens)
    return _rate_head(params["head"], x.sum(dim=0), t * n)


def make_apply_fn(plan: DeployPlan):
    """``fn(params, images) -> logits`` with the plan's static metadata closed
    over.  ``images``: (B, H, W, C) float32 on the plan's device."""
    return functools.partial(_execute, plan.meta)


def apply(plan: DeployPlan, batch) -> torch.Tensor:
    """One-shot convenience: run the plan on an image batch (a tensor or a
    numpy array; moved to the plan's device)."""
    images = torch.as_tensor(batch, dtype=torch.float32, device=plan.meta.device)
    with torch.inference_mode():
        return make_apply_fn(plan)(plan.params, images)
