"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

123B params: bf16 params + fp32 Adam moments fully sharded over 512 chips
(~2.4 GB params+moments per chip).  Smaller attention blocks to bound the
chunked-attention working set at 32k prefill.
"""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("mistral-large-123b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        attn_block_q=256,
        attn_block_k=512,
    )


@register("mistral-large-123b_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="mistral-large-123b_smoke", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, head_dim=8, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
    )
