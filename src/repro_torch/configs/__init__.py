"""Architecture configs: the ten assigned archs (each with its ``_smoke``
variant) and the paper's own Spike-IAND-Former models, as in the JAX
package's ``configs``.

Importing this package populates the ``repro_torch.models.lm`` registry.
"""

from repro_torch.configs import (  # noqa: F401
    granite_moe_3b_a800m,
    kimi_k2_1t_a32b,
    llama3_2_1b,
    mamba2_130m,
    mistral_large_123b,
    musicgen_large,
    paligemma_3b,
    qwen1_5_4b,
    qwen3_8b,
    recurrentgemma_9b,
    spike_iand_former,
)

ASSIGNED_ARCHS = (
    "musicgen-large",
    "qwen1.5-4b",
    "qwen3-8b",
    "llama3.2-1b",
    "mistral-large-123b",
    "mamba2-130m",
    "granite-moe-3b-a800m",
    "kimi-k2-1t-a32b",
    "paligemma-3b",
    "recurrentgemma-9b",
)
