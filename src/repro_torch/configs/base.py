"""Architecture configuration, copied from ``repro.configs.base`` so that
the port's configs load without the JAX package.  Field names and defaults
are the reference's, so one config describes the same model in both."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # block flavour
    act: str = "silu"
    mlp_kind: str = "gated"          # gated | classic
    norm: str = "rmsnorm"            # rmsnorm | rmsnorm_p1 | layernorm
    pos: str = "rope"                # rope | learned | none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: embeddings * sqrt(d_model)
    max_seq: int = 8192              # learned-pos table size
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    hybrid_attn_every: int = 0       # zamba2: shared attn block cadence
    # enc-dec / multimodal frontends
    enc_layers: int = 0
    frontend: str = "none"           # none | audio_stub | vision_stub
    num_patches: int = 0             # vlm prefix length
    frame_ratio: int = 1             # audio: encoder frames = seq // ratio
    # numerics / execution
    attention_impl: str = "xla"      # xla | flash_pallas (Pallas kernel)
    dtype: str = "bfloat16"
    remat: bool = True
    logit_chunk: int = 512           # chunked cross-entropy chunk length
    sub_quadratic: bool = False      # can run long_500k (SSM/hybrid)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding/lm-head rows padded to a multiple of 128 (the padded
        logits are masked to -1e30 in the serve head; padded ids are never
        produced)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included), the
        reference's formula: the hybrid adds its one shared attention + MLP
        block over 2 * d_model and its projection back to d_model."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, k, hd = self.n_heads, self.n_kv_heads, self.head_dim
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            attn = d * (h * hd) * 2 + d * (k * hd) * 2
            mlp = 3 * d * ff if self.mlp_kind == "gated" else 2 * d * ff
            if self.n_experts:
                mlp = self.n_experts * 3 * d * ff + d * self.n_experts
            per_layer = attn + mlp
        elif self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            nh = di // self.ssm_head_dim
            per_layer = d * (2 * di + 2 * self.ssm_state + nh) + di * d
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            d2 = 2 * d
            total += (d2 * (h * hd) * 2 + d2 * (k * hd) * 2 + 3 * d2 * ff
                      + d2 * d)
        if self.family == "encdec":
            attn = d * (h * hd) * 2 + d * (k * hd) * 2
            mlp = 2 * d * ff if self.mlp_kind == "classic" else 3 * d * ff
            total += self.enc_layers * (attn + mlp) + self.n_layers * attn
        return total + v * d * (1 if self.tie_embeddings else 2)
