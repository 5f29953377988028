"""Gemma-2B (Gemma Team 2024, arXiv:2403.08295): 18L d_model=2048, 8 query
heads over one KV head (MQA) of head dim 256, GeGLU d_ff=16384,
vocab=256000, tied embeddings scaled by sqrt(d_model), RMSNorm with (1 +
w), RoPE.  The smoke config keeps the family at CPU size.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=256000,
        act="gelu", mlp_kind="gated", norm="rmsnorm_p1", pos="rope",
        tie_embeddings=True, embed_scale=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512,
        act="gelu", mlp_kind="gated", norm="rmsnorm_p1", pos="rope",
        tie_embeddings=True, embed_scale=True, logit_chunk=64,
    )
