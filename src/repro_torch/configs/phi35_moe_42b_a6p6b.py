"""Phi-3.5-MoE 42B-A6.6B (Microsoft 2024, hf microsoft/Phi-3.5-MoE-
instruct): 32L d_model=4096, 32 query heads over 8 KV heads of 128, 16
experts of d_ff=6400 with top-2 routing, vocab=32064, LayerNorm without
biases, RoPE, SwiGLU experts, untied head.  The smoke config keeps the
family at CPU size, with a capacity factor of 8 so that no pair is dropped
(decode == prefill).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064, n_experts=16, top_k=2,
        act="silu", mlp_kind="gated", norm="layernorm", pos="rope",
        rope_theta=10000.0, use_bias=False,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="phi35-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512, n_experts=4, top_k=2,
        capacity_factor=8.0,
        act="silu", mlp_kind="gated", norm="layernorm", pos="rope",
        logit_chunk=64,
    )
