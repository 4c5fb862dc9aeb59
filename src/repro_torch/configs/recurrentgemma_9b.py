"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (kv=1 MQA) d_ff=12288
vocab=256000 -- RG-LRU + local attention, pattern 1:2 [arXiv:2402.19427;
unverified].

Block pattern (rec, rec, attn_local) repeating (38 = 12x3 + 2); local window
2048.  Sub-quadratic: runs the long_500k cell (RG-LRU state + ring-buffer
window cache).  Mixed block kinds -> Python-loop layers (scan_layers=False).
The RG-LRU recurrence is real-valued/gated, so the paper's spiking technique
is inapplicable to the recurrent blocks (DESIGN.md S3).
"""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("recurrentgemma-9b")
def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        block_pattern=("rec", "rec", "attn_local"),
        local_window=2048,
        lru_width=4096,
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        act="geglu",
        embed_scale=True,
        tie_embeddings=True,
        scan_layers=False,
        supports_long_context=True,
    )


@register("recurrentgemma-9b_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="recurrentgemma-9b_smoke", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256, lru_width=64,
        local_window=16, compute_dtype="float32",
    )
