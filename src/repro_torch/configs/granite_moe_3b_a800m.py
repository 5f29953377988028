"""Granite-3.0-MoE 3B-A800M (IBM 2024, hf ibm-granite/granite-3.0-3b-a800m-
base): 32L d_model=1536, 24 query heads over 8 KV heads of 64, 40 experts
of d_ff=512 with top-8 routing, vocab=49155, tied head, RMSNorm, RoPE,
SwiGLU experts.  The smoke config keeps the family at CPU size, with a
capacity factor of 8 so that no pair is dropped (decode == prefill).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49155, n_experts=40, top_k=8,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        rope_theta=10000.0, tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512, n_experts=8, top_k=2,
        capacity_factor=8.0,
        act="silu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        tie_embeddings=True, logit_chunk=64,
    )
