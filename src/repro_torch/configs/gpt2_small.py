"""GPT-2 small (124M) -- the paper's own experimental model (Radford et al.
2019): 12L d_model=768 12H d_ff=3072 vocab=50257, learned positions,
LayerNorm, GELU 2-layer MLP, biases, tied embeddings, context 1024.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gpt2-small", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=50257,
        act="gelu", mlp_kind="classic", norm="layernorm", pos="learned",
        use_bias=True, tie_embeddings=True, max_seq=1024,
    )


def smoke_config() -> ArchConfig:
    """The mini GPT-2 used for the paper-validation pre-training runs."""
    return ArchConfig(
        name="gpt2-mini", family="dense",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=256,
        act="gelu", mlp_kind="classic", norm="layernorm", pos="learned",
        use_bias=True, tie_embeddings=True, max_seq=512, logit_chunk=128,
    )
