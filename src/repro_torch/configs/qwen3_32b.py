"""Qwen3-32B (the Qwen3 family): 64L d_model=5120, 64 query heads over 8
KV heads (GQA) of head dim 128, SwiGLU d_ff=25600, vocab=151936, RMSNorm
on q and k per head (qk-norm) before RoPE with theta 1e6, untied head.
The smoke config keeps the family at CPU size.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=25600, vocab_size=151936,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        rope_theta=1e6, qk_norm=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        qk_norm=True, logit_chunk=64,
    )
