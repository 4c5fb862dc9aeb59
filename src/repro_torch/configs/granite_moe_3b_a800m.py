"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

NOTE: the assignment line gives "MoE 40e top-8" in the config field and
"32 experts top-8" in the comment; we take the config field (40 experts) as
authoritative -- DESIGN.md S8.5.
"""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("granite-moe-3b-a800m")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,              # per-expert FFN width
        vocab_size=49155,
        num_experts=40,
        num_experts_per_tok=8,
        tie_embeddings=True,
    )


@register("granite-moe-3b-a800m_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="granite-moe-3b-a800m_smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
        num_experts=8, num_experts_per_tok=2, compute_dtype="float32",
    )
