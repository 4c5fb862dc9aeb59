"""Measured spike sparsity of a plan's forward (the part of the JAX
package's ``engine/analysis.py`` that the sparse datapath needs).

:func:`sparsity_report` runs a packed plan once under
``engine.execute.capture_spikes`` and reports, per LIF tap and aggregated,
the skip rates each sparse consumer sees on those activations.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import packing

_GRANULE = 8    # token rows per skip granule of the plain sparse route


def sparsity_report(plan, batch) -> dict:
    """MEASURED occupancy of every packed spike train a plan's forward moves
    on ``batch``:

    * ``word_zero_rate`` -- fraction of 32-bit words that are all-zero (the
      finest exact-skip granule);
    * ``occ_tile_zero_rate`` -- fraction of ``packing.OCC_TILE``-element
      occupancy tiles that are all-zero;
    * ``token_granule_zero_rate`` -- fraction of 8-token granules with no
      spike at any feature or time step (what the plain sparse GEMM skips);
    * ``spike_rate`` -- plain spike density over (T, elements).
    """
    from repro_torch.engine import execute

    with execute.capture_spikes() as taps:
        execute.apply(plan, batch)
    if not taps:
        raise ValueError(
            "plan produced no packed spike trains -- sparsity_report needs a "
            "packed backend (Backend.packed=True)")
    per_tap = []
    tot = dict.fromkeys(("words", "zero_words", "tiles", "zero_tiles", "granules",
                         "zero_granules", "spikes", "slots"), 0)
    for ps in taps:
        words = ps.words
        occ = ps.occ if ps.occ is not None else packing.occupancy_map(words)
        # token granules: rows of the (tokens, features) view, all word planes
        flat = words.reshape(words.shape[0], -1, words.shape[-1])
        row_alive = (flat != 0).any(dim=2).any(dim=0)
        row_alive = F.pad(row_alive, (0, (-row_alive.shape[0]) % _GRANULE))
        gran_alive = row_alive.reshape(-1, _GRANULE).any(dim=1)
        n = {"words": words.numel(), "zero_words": int((words == 0).sum()),
             "tiles": occ.numel(), "zero_tiles": int((occ == 0).sum()),
             "granules": gran_alive.numel(), "zero_granules": int((~gran_alive).sum()),
             "spikes": int(packing.spike_counts(ps).sum(dtype=torch.int64)),
             "slots": ps.t * math.prod(ps.elem_shape)}
        per_tap.append({
            "shape": tuple(int(s) for s in ps.dense_shape),
            "word_zero_rate": n["zero_words"] / n["words"],
            "occ_tile_zero_rate": n["zero_tiles"] / n["tiles"],
            "token_granule_zero_rate": n["zero_granules"] / n["granules"],
            "spike_rate": n["spikes"] / n["slots"],
        })
        for key in tot:
            tot[key] += n[key]
    return {
        "num_taps": len(per_tap),
        "taps": per_tap,
        "word_zero_rate": tot["zero_words"] / tot["words"],
        "occ_tile_zero_rate": tot["zero_tiles"] / tot["tiles"],
        "token_granule_zero_rate": tot["zero_granules"] / tot["granules"],
        "spike_rate": tot["spikes"] / tot["slots"],
    }
