"""seamless-m4t-medium (arXiv:2308.11596): an encoder-decoder, 12 encoder
and 12 decoder layers, d_model 1024, 16 heads of 64 (MHA), a classic GELU
MLP of 4096 with biases, LayerNorm, RoPE, an untied head over 256,206
tokens.  The audio frontend is a stub: precomputed frame embeddings (B,
seq // frame_ratio, d_model) pass through ``frame_proj``.  The smoke
config keeps the family at CPU size (2 + 2 layers, d_model 64).
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=256206,
        act="gelu", mlp_kind="classic", norm="layernorm", pos="rope",
        use_bias=True, frontend="audio_stub", frame_ratio=4,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-smoke", family="encdec",
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        act="gelu", mlp_kind="classic", norm="layernorm", pos="rope",
        use_bias=True, frontend="audio_stub", frame_ratio=4, logit_chunk=64,
    )
