"""Deploy-plan compiler: (params, state, cfg) -> the accelerator's view.

``compile_plan`` performs the paper's deploy-time transformations once,
ahead of serving: every Conv+BN pair of the tokenizer is folded into a single
(w, b) via ``fold_conv_bn``, every Linear+BN pair of every block via
``fold_linear_bn`` -- the BN disappears from the graph entirely.  The block
layout records which LIFs fuse the AND-NOT residual into their epilogue, and
the backend (plain PyTorch vs the CUDA kernels) is a plan property.

A plan lives on one device, the card unless the caller asks for the CPU.
This slice covers the vision family; spiking-LM plans come in a later one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import bridge
from repro_torch.core import nn as cnn
from repro_torch.engine.backend import Backend, resolve
from repro_torch.engine.layout import ProjUnit, TokStage, block_layout, tokenizer_layout


@dataclass(frozen=True)
class PlanMeta:
    """Static half of a deploy plan."""

    cfg: Any                          # SpikformerConfig (frozen)
    backend: Backend
    tok_stages: tuple[TokStage, ...]
    block_units: tuple[ProjUnit, ...]
    num_layers: int
    device: torch.device
    family: str = "vision"


@dataclass(frozen=True)
class DeployPlan:
    meta: PlanMeta
    params: dict                      # folded-weight tree of tensors on meta.device

    @property
    def cfg(self):
        return self.meta.cfg

    @property
    def backend(self) -> Backend:
        return self.meta.backend


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises (a plan
    never drops quietly to the CPU: pass ``device="cpu"`` for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plan on the CPU")
    return dev


def compile_plan(params, state, cfg, *, backend="cuda", device=None,
                 checkpoint=None) -> DeployPlan:
    """Fold a trained (params, state, cfg) into a deploy plan on ``device``.

    ``params``/``state``: nested dicts of tensors or numpy arrays with the
    JAX package's structure (see :mod:`repro_torch.bridge`).
    ``backend``: Backend | "torch" | "cuda" | "torch+packed" | "cuda+packed" |
    "torch+packed+sparse" | "cuda+packed+sparse" (see ``engine.backend.resolve``).
    ``checkpoint``: optional checkpoint directory (either package's layout,
    :mod:`repro_torch.checkpoint.checkpoint`) holding ``{"params", "state"}``;
    its arrays are restored into the ``params``/``state`` skeleton before
    folding, as the JAX package's ``compile_plan(checkpoint=)`` does.
    """
    if not hasattr(cfg, "tokenizer_config"):
        raise NotImplementedError(
            "spiking-LM deploy plans are ported in a later slice (ROADMAP "
            "queue 1, item 6); this slice covers the vision configs")
    be = resolve(backend)
    if be.packed and cfg.residual != "iand":
        raise ValueError(
            "packed backends require residual='iand': the ADD residual sums "
            "spike trains into non-binary tensors, which cannot be bit-packed")
    dev = resolve_device(device)
    params = bridge.to_torch(params, dev)
    state = bridge.to_torch(state, dev)
    if checkpoint is not None:
        from repro_torch.checkpoint import checkpoint as ckpt

        restored, _ = ckpt.restore(checkpoint, {"params": params, "state": state})
        params, state = restored["params"], restored["state"]
    tok_stages = tokenizer_layout(cfg.tokenizer_config())
    units = block_layout(cfg)

    tp, ts = params["tokenizer"], state["tokenizer"]
    folded_tok = tuple(cnn.fold_conv_bn(tp[st.conv], tp[st.bn], ts[st.bn])
                       for st in tok_stages)
    folded_blocks = tuple(
        {u.name: cnn.fold_linear_bn(params[f"block{i}"][u.name]["lin"],
                                    params[f"block{i}"][u.name]["bn"],
                                    state[f"block{i}"][u.name]["bn"])
         for u in units}
        for i in range(cfg.num_layers))

    meta = PlanMeta(cfg=cfg, backend=be, tok_stages=tok_stages, block_units=units,
                    num_layers=cfg.num_layers, device=dev)
    return DeployPlan(meta=meta, params={"tokenizer": folded_tok,
                                         "blocks": folded_blocks,
                                         "head": params["head"]})


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def plan_stats(plan: DeployPlan) -> dict:
    """Structural op accounting of the deploy plan (what the paper's Table II
    argues about): every BN is folded away, every IAND rides a LIF epilogue."""
    meta = plan.meta
    n_tok = len(meta.tok_stages)
    n_units = len(meta.block_units)
    fused = sum(u.fuse_residual for u in meta.block_units) * meta.num_layers
    return {
        "decode_entry": False,        # vision: non-causal SSA, no step mode
        "folded_conv_bn": n_tok,
        "folded_linear_bn": n_units * meta.num_layers,
        "bn_ops": 0,                  # folded at plan-compile time
        "fused_lif_iand_dispatches": fused,
        "standalone_iand_ops": 0,     # IAND only ever executes in the fused epilogue
        "standalone_add_ops": 0 if meta.cfg.residual == "iand" else 2 * meta.num_layers,
        # one LIF dispatch per tokenizer stage; per block: q,k,v, attn, proj, fc1, fc2
        "lif_dispatches": n_tok + (n_units + 1) * meta.num_layers,
        # tick-batched: each folded weight is read once per image batch for all T
        "weight_reads": n_tok + n_units * meta.num_layers + 1,
        "backend": meta.backend.kind,
        "packed": meta.backend.packed,
        "sparse": meta.backend.sparse,
        # bits per spike moved between layers: 32 (f32) dense, or the packed
        # word amortised over the T steps it carries
        "bits_per_spike": (32 * -(-meta.cfg.t // 32) / meta.cfg.t
                           if meta.backend.packed else 32),
        "param_count": _numel(plan.params),
    }
