"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per-expert), vocab=163840, MoE 384e top-8 -- trillion-param MoE
[arXiv:2501.kimi2; unverified, paper-table].

~1.03T expert params.  bf16 params (8.15 GB/dev at 256 chips) + classic
momentum-free Adafactor (factored second moment, O(rows+cols) state): the
ONLY optimizer family that fits a 1T model on a 16 GB-HBM pod -- bf16 Adam
moments alone would add 16.3 GB/dev (measured in the dry-run; DESIGN.md S4).
Experts sharded over the data axis (EP=16, 24 experts/rank), per-expert FFN
over the model axis.
"""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("kimi-k2-1t-a32b")
def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=2048,             # per-expert FFN width
        vocab_size=163840,
        num_experts=384,
        num_experts_per_tok=8,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        opt_state_dtype="bfloat16",
        opt_kind="adafactor",
        opt_b1=0.0,
        attn_block_q=256,
        attn_block_k=512,
    )


@register("kimi-k2-1t-a32b_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="kimi-k2-1t-a32b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256, num_experts=8,
        num_experts_per_tok=2, param_dtype="float32",
        opt_state_dtype="float32", compute_dtype="float32",
    )
