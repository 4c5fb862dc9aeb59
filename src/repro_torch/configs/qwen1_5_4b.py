"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("qwen1.5-4b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


@register("qwen1.5-4b_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="qwen1.5-4b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, compute_dtype="float32",
    )
