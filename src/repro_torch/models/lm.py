"""Decoder-only language model, dense family: embed with learned positions,
a Python loop over the layers in place of the reference's scan, final norm
and tied head (port of the serving half of ``repro/models/lm.py``).

The caches are stacked (L, B, S, ...) buffers, as in the JAX package; each
layer works on its view and writes its rows in place, so ``lm_decode``
mutates the caches it is given (the JAX step returns new ones).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qadam import QState
from repro_torch.core.qpolicy import QuantPolicy, as_policy
from repro_torch.models.attention import Cache, init_caches
from repro_torch.models.blocks import block_apply
from repro_torch.models.common import Params, cast_params, layernorm, tree_map

_NEG = -1e30


def carrier_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked block parameters."""
    return tree_map(lambda x: (QState(x.q[i], x.scale[i], x.zero[i])
                               if isinstance(x, QState) else x[i]), blocks)


def embed_tokens(params: Params, tokens: torch.Tensor, cfg,
                 positions: torch.Tensor, dtype: torch.dtype,
                 policy: QuantPolicy) -> torch.Tensor:
    """Token + learned-position embedding.  Positions are clamped to the
    table: a freed slot rides the batched decode step with its stale
    position, which can reach the table size; its row is discarded."""
    table = policy.quantize_weight("embed", params["embed"])
    e = table[tokens.long()].to(dtype)
    pos_table = params["pos_embed"]
    pe = pos_table[positions.clamp(0, pos_table.shape[0] - 1)].to(dtype)
    return e + pe


def logits_head(params: Params, h: torch.Tensor, cfg,
                policy: QuantPolicy) -> torch.Tensor:
    """(B, C, d) -> (B, C, V_padded) fp32 logits, padded vocab masked to
    -1e30.  Carrier-precision operands, fp32 accumulation (the reference's
    ``preferred_element_type=f32`` einsum)."""
    if cfg.tie_embeddings:
        head = policy.quantize_weight("lm_head", params["embed"]).t()
    else:
        head = policy.quantize_weight("lm_head", params["lm_head"])
    logits = torch.matmul(h.to(torch.float32),
                          head.to(h.dtype).to(torch.float32))
    if cfg.vocab_padded > cfg.vocab_size:
        logits[..., cfg.vocab_size:] = _NEG
    return logits


def _run_stack(params: Params, h: torch.Tensor, cfg, policy: QuantPolicy,
               caches: Cache, cache_offset) -> torch.Tensor:
    for i in range(cfg.n_layers):
        h = block_apply(layer_params(params["blocks"], i), h, cfg,
                        policy=policy,
                        cache={k: c[i] for k, c in caches.items()},
                        cache_offset=cache_offset, layer=i)
    fn = params["final_norm"]
    return layernorm(h, fn["scale"], fn["bias"])


def lm_prefill(params: Params, tokens: torch.Tensor, cfg, *, policy=None,
               max_seq: Optional[int] = None,
               last_pos: Optional[torch.Tensor] = None):
    """Process right-padded prompts (B, S); returns (logits (B, V_padded)
    at ``last_pos`` -- (B,) per-row indices, default the last column -- and
    the caches sized to ``max_seq`` (default S)."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    b, s = tokens.shape
    device = tokens.device
    positions = torch.arange(s, device=device).expand(b, s)
    h = embed_tokens(params, tokens, cfg, positions, dtype, policy)
    caches = init_caches(cfg, b, max_seq or s, dtype,
                         kv_spec=policy.kv_spec(), device=device)
    h = _run_stack(params, h, cfg, policy, caches, 0)
    if last_pos is None:
        hc = h[:, -1:, :]
    else:
        rows = torch.arange(b, device=device)
        hc = h[rows, last_pos.to(device).long()][:, None, :]
    return logits_head(params, hc, cfg, policy)[:, 0, :], caches


def lm_decode(params: Params, caches: Cache, token: torch.Tensor,
              pos: torch.Tensor, cfg, *, policy=None):
    """One-token decode.  token: (B, 1); pos: (B,) int32 per-slot count of
    tokens already in the cache (each slot writes its own row and masks its
    own history).  Returns (logits (B, V_padded), caches) -- the caches are
    updated in place."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    pos = pos.to(device=token.device, dtype=torch.int32)
    h = embed_tokens(params, token, cfg, pos[:, None].long(), dtype, policy)
    h = _run_stack(params, h, cfg, policy, caches, pos)
    return logits_head(params, h, cfg, policy)[:, 0, :], caches
