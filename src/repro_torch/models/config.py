"""Unified architecture configuration of the language models, a copy of the
JAX package's ``models/config.py`` (the port imports nothing of the JAX
package).

One frozen dataclass covers all five families (dense / moe / ssm / hybrid /
modality-stub transformers) and the spiking LM; family-specific fields are
ignored elsewhere.  The configs of the ten assigned architectures live in
``repro_torch.configs``.  ``SHAPE_CELLS`` are the shape columns of the JAX
package's dry-run (``cell_supported`` says which an arch runs).
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
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # qwen3
    act: str = "swiglu"              # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-family sqrt(d_model) embedding scale

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rec","rec","attn")
    block_pattern: tuple[str, ...] = ()
    local_window: int = 2048
    lru_width: int | None = None

    # modality stubs ([audio]/[vlm]): backbone consumes precomputed embeddings
    modality: str = "text"           # text | audio_stub | vision_stub
    num_prefix_tokens: int = 0       # vlm: image-patch prefix length (full attn)

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32" # kimi-k2 uses bfloat16 to fit 512 chips
    opt_master_weights: bool = False # bf16 params + f32 master (halves AG/RS)
    opt_kind: str = "adamw"          # adamw | adafactor (kimi: factored, b1=0)
    opt_b1: float = 0.9
    remat: bool = True
    scan_layers: bool = True
    attn_block_q: int = 512
    attn_block_k: int = 1024

    # paper technique (spiking mode) -- DESIGN.md S3
    spiking: bool = False
    spike_t: int = 4
    spike_chain_len: int | None = None

    # which shape cells this arch supports (DESIGN.md S3 long_500k rules)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:        # ssm
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (shape) column: what gets lowered in the dry-run."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def cell_by_name(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def cell_supported(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(supported, reason-if-not). long_500k needs sub-quadratic attention."""
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: 500k-token decode requires sub-quadratic "
            "attention (run only for ssm/hybrid; see DESIGN.md S3)"
        )
    return True, ""
