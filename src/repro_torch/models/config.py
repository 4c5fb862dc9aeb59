"""Architecture configuration of the language models -- the fields of the JAX
package's ``ArchConfig`` that the spiking LM and its deploy plan read.

A copy, not an import: the port imports nothing of the JAX package.  The
family-specific fields the spiking LM never reads (MoE, SSM, hybrid,
modality stubs, optimizer) come with the generic LM substrate.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None      # default: d_model // num_heads
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    modality: str = "text"           # text | audio_stub | vision_stub

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # the paper's technique (spiking mode)
    spiking: bool = False
    spike_t: int = 4
    spike_chain_len: int | None = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
