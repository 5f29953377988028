"""Mamba2-130M (Dao & Gu 2024, "Transformers are SSMs", arXiv:2405.21060):
24L d_model=768, attention-free SSD (state-space duality) layers with
d_inner 1536 = 24 heads of 64, a state of 128, a causal conv of width 4,
RMSNorm, no positions, a tied head of 50,280.  The smoke config keeps the
family at CPU size.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
        norm="rmsnorm", pos="none", tie_embeddings=True, sub_quadratic=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=1,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
        norm="rmsnorm", pos="none", tie_embeddings=True, sub_quadratic=True,
        logit_chunk=64,
    )
