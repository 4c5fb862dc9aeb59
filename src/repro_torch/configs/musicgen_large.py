"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec/text-conditioning frontend is a STUB per
the assignment: ``input_specs`` provides precomputed frame embeddings and the
backbone predicts codebook tokens (vocab 2048).  Plain-GELU MLP as in the
original (non-gated) transformer blocks.
"""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("musicgen-large")
def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        family="dense",
        modality="audio_stub",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        act="gelu",
    )


@register("musicgen-large_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="musicgen-large_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=64, compute_dtype="float32",
    )
