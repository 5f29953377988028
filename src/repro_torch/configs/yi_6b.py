"""Yi-6B (01.AI 2024, arXiv:2403.04652), a llama-architecture model: 32L
d_model=4096 32H over 4 KV heads (GQA, 8 query heads a KV head), head dim
128, SwiGLU d_ff=11008, vocab=64000, RMSNorm, RoPE with theta 5e6, untied
head.  The smoke config keeps the family at CPU size (4 heads over one KV
head).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab_size=64000,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        rope_theta=5000000.0,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="yi-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        logit_chunk=64,
    )
