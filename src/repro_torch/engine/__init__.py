"""Deploy-time fused inference engine (the paper's accelerator view), PyTorch.

* :func:`compile_plan` folds ``(params, state, cfg)`` into a
  :class:`DeployPlan` on a device: ConvBN/LinearBN pairs become single weight
  reads, AND-NOT residuals are marked for the fused LIF epilogue, and the
  backend (plain PyTorch vs the CUDA kernels) becomes a plan property.
* :func:`apply` / :func:`make_apply_fn` execute a plan.
* :func:`plan_stats` accounts for the ops the deploy view eliminated.

The layer list lives in :mod:`repro_torch.engine.layout`, shared with the
eval graph in ``repro_torch.core``.
"""

from repro_torch.engine.backend import Backend
from repro_torch.engine.execute import apply, make_apply_fn
from repro_torch.engine.plan import DeployPlan, PlanMeta, compile_plan, plan_stats

__all__ = ["Backend", "apply", "make_apply_fn", "DeployPlan", "PlanMeta",
           "compile_plan", "plan_stats"]
