"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

Sub-quadratic: runs the long_500k cell (O(1)-state decode).  The paper's
spiking technique is inapplicable to the real-valued SSD recurrence
(DESIGN.md S3/S Arch-applicability).
"""

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import register


@register("mamba2-130m")
def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=24,          # == ssm heads (d_inner / ssm_head_dim)
        num_kv_heads=1,
        d_ff=0,                # attention-free, no MLP block
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        tie_embeddings=True,
        supports_long_context=True,
    )


@register("mamba2-130m_smoke")
def smoke_config() -> ArchConfig:
    return config().replace(
        name="mamba2-130m_smoke", num_layers=2, d_model=64, num_heads=4,
        vocab_size=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
        compute_dtype="float32",
    )
