"""Deploy-time fused inference engine (the paper's accelerator view), PyTorch.

* :func:`compile_plan` folds ``(params, state, cfg)`` into a
  :class:`DeployPlan` on a device: ConvBN/LinearBN pairs (vision) or
  Linear+RMSNorm units and the embedding norm (spiking LM) become single
  weight reads, AND-NOT residuals are marked for the fused LIF epilogue, and
  the backend (plain PyTorch vs the CUDA kernels) becomes a plan property.
* :func:`apply` / :func:`make_apply_fn` execute a plan.
* LM plans decode incrementally: :func:`prefill`, :func:`prefill_chunk` and
  :func:`decode_step` (and their ``make_*_fn`` factories) carry a
  :class:`DecodeState` of O(d^2) per head, flat in context length;
  :func:`decode_state_batch_init`, :func:`decode_state_scatter` and
  :func:`decode_state_gather` page sequences in and out of one batched state
  (continuous serving, ``launch.scheduler``).
* :func:`plan_stats` accounts for the ops the deploy view eliminated.
* ``compile_plan(mesh=)`` (:class:`ShardingCfg`) shards a plan over a
  ``torch.distributed`` world, bit-exact against the single-device plan;
  the cross-rank spike edges go through :func:`spike_allgather` /
  :func:`word_allgather` (int32 words under packed backends), and
  :func:`decode_state_full` gathers a sharded ``DecodeState``.

The layer list lives in :mod:`repro_torch.engine.layout`, shared with the
eval graphs in ``repro_torch.core`` and ``repro_torch.models``.
"""

from repro_torch.engine.backend import (
    Backend, spike_allgather, spike_shard, unit_partition_specs, word_allgather, word_psum,
    word_reduce_scatter,
)
from repro_torch.engine.execute import (
    DecodeState, apply, decode_state_batch_init, decode_state_full, decode_state_gather,
    decode_state_init, decode_state_scatter, decode_step, make_apply_fn, make_decode_step_fn,
    make_prefill_chunk_fn, make_prefill_fn, prefill, prefill_chunk,
)
from repro_torch.engine.plan import (
    DecodeEntry, DeployPlan, LMDeployCfg, PlanMeta, ShardingCfg, compile_plan, plan_stats,
)

__all__ = ["Backend", "apply", "make_apply_fn", "DeployPlan", "PlanMeta", "compile_plan",
           "plan_stats", "LMDeployCfg", "DecodeEntry", "DecodeState", "decode_state_init",
           "decode_state_batch_init", "decode_state_scatter", "decode_state_gather",
           "decode_state_full", "prefill", "prefill_chunk", "decode_step", "make_prefill_fn",
           "make_prefill_chunk_fn", "make_decode_step_fn", "ShardingCfg", "spike_allgather",
           "spike_shard", "unit_partition_specs", "word_allgather", "word_psum",
           "word_reduce_scatter"]
