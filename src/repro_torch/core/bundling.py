"""Row bundling: merge near-duplicate embedding spike trains at plan time
(PyTorch port of the JAX package's ``core/bundling.py``).

The spiking LM's encoding LIF sees each token only through its embedding-table
row -- the drive is the row broadcast over the T time steps
(``engine.execute._lm_embed_drive``), so a token's spike train is a pure
function of its row.  Two rows whose trains agree on every (time step, feature)
bit are indistinguishable to everything downstream: blocks, attention, head.
Rows whose trains differ in only a few bits are nearly so.

This module computes each row's packed train once (its *signature*), greedily
clusters signatures by hamming distance, and rewrites bundled rows to their
cluster representative's row, after which bundled tokens share one train.

Correctness contract:

* ``radius=0`` bundles only rows with bit-identical trains: the transform is
  then exactly logit-preserving (dedup, not approximation).
* ``radius>0`` is lossy; :func:`bundle` walks radii descending and accepts the
  largest radius whose measured max-abs logit error on a probe batch stays
  within the caller's budget.  Radius 0 satisfies any budget >= 0, so the
  search always ends with a valid plan.

The accepted radius, bundle count and measured error are recorded as a
:class:`BundleInfo` on the plan's metadata and surfaced by
``engine.plan.plan_stats``.

Clustering is O(V^2) in vocabulary size (a dense hamming matrix), and the
probe scores all V tokens as one sequence: :func:`bundle` is for the
smoke-scale configs, as in the reference.  :func:`row_train_table` and
:func:`attach_train_table` run at any vocabulary size.

Words are int32 tensors holding the uint32 bit pattern (``core.packing``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import packing

# Rows of the table run through the encoding LIF at a time in
# :func:`row_train_table`: each row's train depends on its row alone, so the
# blocks give the words of one pass, with a drive of at most
# T x ROW_BLOCK x D f32 (537 MB at llama3.2-1b width) in place of the whole
# table's 4.2 GB.
ROW_BLOCK = 16384


@dataclass(frozen=True)
class BundleInfo:
    """Record of an applied row-bundling transform (lives on
    ``PlanMeta.bundle``)."""

    num_rows: int          # vocabulary rows considered
    num_bundles: int       # distinct representatives after bundling
    radius: int            # accepted hamming radius (0 = exact dedup)
    budget: float          # caller's max-abs logit-error budget
    logit_err: float       # measured max-abs logit error on the probe batch

    @property
    def rows_merged(self) -> int:
        return self.num_rows - self.num_bundles


def row_train_table(plan) -> torch.Tensor:
    """(W, V, D) int32 words: row ``i``'s packed encoding-LIF spike train under
    the plan's own neuron parameters and dispatch route (the encoding LIF of
    tokens ``0..V-1``, run :data:`ROW_BLOCK` rows at a time)."""
    from repro_torch.engine import execute

    table = plan.params["embed"]["table"]
    v = table.shape[0]
    blocks = []
    with torch.inference_mode():
        for lo in range(0, v, ROW_BLOCK):
            tokens = torch.arange(lo, min(v, lo + ROW_BLOCK), device=table.device)[None]
            drive = execute._lm_embed_drive(plan.meta, plan.params["embed"], tokens)
            ps = execute._lif(plan.meta, drive, pack_output=True, occupancy=False)
            blocks.append(ps.words.reshape(ps.words.shape[0], tokens.shape[1], -1))
            del drive, ps
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def attach_train_table(plan):
    """The plan with the per-row packed train table attached
    (``params['embed']['train_words']``, (W, V, D) int32).

    The encoding train is a pure function of the embedding row, so the decode
    step fetches a generated token's train from this table instead of running
    the T-step encoding LIF per token (``engine.execute._lm_decode_step``).
    Costs ``V * W * D`` words of plan memory, ``ceil(T/32)/32`` of the f32
    embedding table."""
    words = row_train_table(plan)
    new_params = dict(plan.params)
    new_params["embed"] = dict(plan.params["embed"])
    new_params["embed"]["train_words"] = words
    return dataclasses.replace(plan, params=new_params)


def row_signatures(plan) -> torch.Tensor:
    """(V, K) int32 hamming signatures: :func:`row_train_table` flattened to one
    word vector per row."""
    words = row_train_table(plan)
    return words.permute(1, 0, 2).reshape(words.shape[1], -1)


def hamming_matrix(sigs: torch.Tensor) -> torch.Tensor:
    """(V, V) int32 pairwise hamming distances between word signatures: the
    number of (time step, feature) bits on which two trains disagree (SWAR
    popcount of the XOR)."""
    x = sigs[:, None, :] ^ sigs[None, :, :]
    return packing.popcount(x).sum(dim=-1, dtype=torch.int32)


def cluster_rows(sigs: torch.Tensor, radius: int) -> torch.Tensor:
    """Greedy hamming clustering: ``reps`` (V,) int64 on the signatures'
    device, ``reps[i]`` the representative row of ``i``'s bundle.

    First-fit in row order: the lowest-index unassigned row opens a bundle and
    absorbs every still-unassigned row within ``radius`` of it.
    Deterministic; at ``radius=0`` it is exact duplicate-train dedup."""
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    d = hamming_matrix(sigs).cpu().numpy()
    v = d.shape[0]
    reps = np.full(v, -1, dtype=np.int64)
    for i in range(v):
        if reps[i] >= 0:
            continue
        members = (reps < 0) & (d[i] <= radius)
        reps[members] = i
    return torch.from_numpy(reps).to(sigs.device)


def bundle_table(table: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """Each row rewritten to its representative's row: bundled tokens now
    share one embedding row, hence one bit-identical spike train."""
    return table[reps]


def _with_table(plan, table, info: BundleInfo | None):
    new_params = dict(plan.params)
    new_params["embed"] = dict(plan.params["embed"])
    new_params["embed"]["table"] = table
    # a rewritten table invalidates any train table; the caller re-attaches
    # (attach_train_table) once the final table is known
    new_params["embed"].pop("train_words", None)
    new_meta = dataclasses.replace(plan.meta, bundle=info)
    return dataclasses.replace(plan, meta=new_meta, params=new_params)


def bundle(plan, *, budget: float, probe_tokens=None, radii=None):
    """Row bundling of an LM deploy plan under a measured logit-error budget;
    returns the bundled plan (``plan.meta.bundle`` records what was accepted).

    ``budget`` is the largest max-abs logit deviation from the unbundled plan
    tolerated on ``probe_tokens`` (default: one sequence of every vocabulary
    row).  ``radii`` overrides the descending candidate radii; the search
    accepts the first (largest) radius whose measured error fits, down to
    radius 0 -- exact duplicate dedup, error 0.0 by construction."""
    from repro_torch.engine import execute

    if plan.meta.family != "lm":
        raise ValueError("row bundling applies to LM embedding tables only")
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    table = plan.params["embed"]["table"]
    had_train_table = "train_words" in plan.params["embed"]
    v = table.shape[0]
    sigs = row_signatures(plan)
    if probe_tokens is None:
        probe_tokens = torch.arange(v, device=table.device)[None]
    ref = execute.apply(plan, probe_tokens)
    if radii is None:
        # geometric sweep down from ~6% of the signature bits to exact dedup
        top = max(1, sigs.shape[1] * 32 // 16)
        radii = []
        r = top
        while r >= 1:
            radii.append(r)
            r //= 2
        radii.append(0)
    for radius in radii:
        reps = cluster_rows(sigs, int(radius))
        num_bundles = int(torch.unique(reps).numel())
        if num_bundles == v and radius > 0:
            continue                      # nothing merged; cheaper radius next
        cand = _with_table(plan, bundle_table(table, reps), None)
        err = float((execute.apply(cand, probe_tokens) - ref).abs().max())
        if err <= budget:
            info = BundleInfo(num_rows=v, num_bundles=num_bundles, radius=int(radius),
                              budget=float(budget), logit_err=err)
            out = _with_table(plan, bundle_table(table, reps), info)
            return attach_train_table(out) if had_train_table else out
    raise AssertionError("radius-0 dedup must satisfy any budget >= 0")
