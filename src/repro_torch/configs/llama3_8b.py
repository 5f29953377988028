"""Llama 3 8B (Grattafiori et al. 2024, arXiv:2407.21783): 32L
d_model=4096 32H over 8 KV heads (GQA), head dim 128, SwiGLU d_ff=14336,
vocab=128256, RMSNorm, RoPE with theta 5e5, untied head.  The smoke
config keeps the family at CPU size (4 heads over 2 KV heads).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128256,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        rope_theta=500000.0,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        logit_chunk=64,
    )
