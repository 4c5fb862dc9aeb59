"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1 = MQA) d_ff=16384
vocab=257216 -- SigLIP + gemma [arXiv:2407.07726; hf].

The SigLIP vision tower is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings (256 tokens) which attend
bidirectionally (prefix-LM mask); the gemma backbone is implemented in full
(GeGLU, embed scaling, MQA with head_dim 256).
"""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("paligemma-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b",
        family="dense",
        modality="vision_stub",
        num_prefix_tokens=256,
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        act="geglu",
        embed_scale=True,
        tie_embeddings=True,
    )


@register("paligemma-3b_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="paligemma-3b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        num_prefix_tokens=4, compute_dtype="float32",
    )
