"""Zamba2-2.7B (Zyphra, arXiv:2411.15242): 54 Mamba2 layers, d_model 2560,
a state of 64, and one attention + MLP block whose weights are shared
across the depth, run after every 6th Mamba2 layer (9 invocations, each
with its own KV cache) on concat(h, the input embedding), 2 x d_model =
5,120 wide: 32 heads of 160 (no grouping), a gated GELU MLP of 10,240,
projected back to d_model.  RMSNorm, RoPE, a tied head of 32,000.  The
smoke config keeps the family at CPU size (4 layers, 2 invocations).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        head_dim=160,                  # the shared block works in 2 * d
        d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
        hybrid_attn_every=6,
        act="gelu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        tie_embeddings=True, sub_quadratic=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, vocab_size=512,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
        hybrid_attn_every=2,
        act="gelu", mlp_kind="gated", norm="rmsnorm", pos="rope",
        tie_embeddings=True, sub_quadratic=True, logit_chunk=64,
    )
