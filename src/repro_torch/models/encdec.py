"""Encoder-decoder LM, the seamless-m4t backbone (port of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, S_enc, d), which pass through
one linear (role ``frame_proj``).  The encoder is a stack of pre-norm
blocks with bidirectional self-attention and the dense MLP, then
``enc_norm``.  A decoder block is causal self-attention, cross-attention
on the encoder output (k and v projected from it, RoPE on q alone) and the
MLP, each pre-norm with its own residual (``ln1``, ``ln2``, ``ln3``).  The
layers run as a Python loop in place of the reference's scans; policy rules
indexed by depth address encoder blocks by their position in the encoder
stack (``n_layers = enc_layers``) and decoder blocks by theirs.

Attention follows ``cfg.attention_impl``: under ``"flash_pallas"`` the
encoder's self-attention and the loss's cross-attention run the flash
kernels with ``causal=False`` (#8 forward, #9/#10 backward; #7 where no
gradient is wanted), the decoder's self-attention with ``causal=True``.

Serving: :func:`encdec_prefill` encodes the frames, computes every decoder
layer's cross K/V once (stacked (L, B, S_enc, K, hd)) and runs the prompt
into fp self-attention caches (L, B, max_seq, K, hd); :func:`encdec_decode`
writes each step's row at ``pos`` in place and attends over the buffer
under the ``arange(max_seq) <= pos`` mask.  With precomputed cross K/V,
prefill and decode read them through the plain grouped path with q
unrotated (the reference's ``_dec_block`` calls ``_gqa_attend`` on the
projected q), whatever ``attention_impl`` says.  No int8 KV cache: the
reference's self caches are fp.

Recomputation as the reference's: under ``cfg.remat`` every encoder and
every decoder block is one checkpoint with nothing kept inside it (the
reference's ``jax.checkpoint(body, prevent_cse=False)``), and the CE
chunks are checkpointed as in ``lm.chunked_ce``.  The checkpoints are
non-reentrant, so loss and gradients are bit-identical with ``remat`` on
and off.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.qpolicy import LinearCtx, QuantPolicy, as_policy
from repro_torch.models.attention import (Cache, _attend, attn_context,
                                          attn_out, init_caches)
from repro_torch.models.common import (Params, apply_norm, cast_params,
                                       checkpointed)
from repro_torch.models.lm import (carrier_dtype, chunked_ce, embed_tokens,
                                   logits_chunk, rope_for, unstack_layers)
from repro_torch.models.mlp import mlp_apply


def _enc_block(bp: Params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
               layer: int, rope) -> torch.Tensor:
    """h + attn(ln1(h)) over every frame, then + mlp(ln2(h))."""
    nl = cfg.enc_layers
    x = apply_norm(h, bp["ln1"], cfg.norm)
    ctx = attn_context(bp["attn"], x, cfg, policy=policy, rope=rope,
                       layer=layer, n_layers=nl, causal=False)
    h = h + attn_out(bp["attn"], ctx, policy=policy, layer=layer,
                     n_layers=nl)
    x = apply_norm(h, bp["ln2"], cfg.norm)
    return h + mlp_apply(bp["mlp"], x, cfg, policy=policy, layer=layer,
                         n_layers=nl)


def encode(params: Params, frames: torch.Tensor, cfg, *,
           policy=None) -> torch.Tensor:
    """The bidirectional encoder: frames (B, S_enc, d) -> (B, S_enc, d) in
    the carrier, after ``enc_norm``.  ``params`` already in the carrier
    (the callers cast them)."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    h = policy.linear(LinearCtx("frame_proj"), frames.to(dtype),
                      params["frame_proj"])
    rope = rope_for(cfg, torch.arange(h.shape[1], device=h.device))
    for i, bp in enumerate(unstack_layers(params["enc_blocks"],
                                          cfg.enc_layers)):
        if cfg.remat:
            h = checkpointed(_enc_block, bp, h, cfg, policy=policy, layer=i,
                             rope=rope)
        else:
            h = _enc_block(bp, h, cfg, policy=policy, layer=i, rope=rope)
    return apply_norm(h, params["enc_norm"], cfg.norm)


def _dec_block(bp: Params, h: torch.Tensor, enc_out: Optional[torch.Tensor],
               cfg, *, policy: QuantPolicy, layer: int, rope,
               cache: Optional[Cache] = None,
               cache_offset: Union[int, torch.Tensor, None] = None,
               cross_kv: Optional[Cache] = None) -> torch.Tensor:
    """One decoder block.  ``cross_kv`` (serving): the layer's precomputed
    {"k", "v"} (B, S_enc, K, hd), read through the plain grouped path with
    the projected q; else (the loss) cross-attention on ``enc_out``.  The
    cross projections share the ``attn_qkv`` / ``attn_out`` roles.  With a
    ``cache`` the self-attention writes its rows there (in place)."""
    nl = cfg.n_layers
    x = apply_norm(h, bp["ln1"], cfg.norm)
    ctx = attn_context(bp["self_attn"], x, cfg, policy=policy, cache=cache,
                       cache_offset=cache_offset, rope=rope, layer=layer,
                       n_layers=nl)
    h = h + attn_out(bp["self_attn"], ctx, policy=policy, layer=layer,
                     n_layers=nl)
    x = apply_norm(h, bp["ln2"], cfg.norm)
    ca = bp["cross_attn"]
    if cross_kv is not None:
        b, sq = x.shape[0], x.shape[1]
        q = policy.linear(LinearCtx("attn_qkv", layer, nl), x, ca["wq"],
                          ca.get("bq")).reshape(b, sq, cfg.n_heads,
                                                cfg.head_dim)
        ctx = _attend(q, cross_kv["k"], cross_kv["v"], None)
    else:
        ctx = attn_context(ca, x, cfg, policy=policy, rope=rope, layer=layer,
                           n_layers=nl, kv_source=enc_out, causal=False)
    h = h + attn_out(ca, ctx, policy=policy, layer=layer, n_layers=nl)
    x = apply_norm(h, bp["ln3"], cfg.norm)
    return h + mlp_apply(bp["mlp"], x, cfg, policy=policy, layer=layer,
                         n_layers=nl)


def encdec_loss(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
                policy=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"frames": (B, S_enc, d), "tokens": (B, S + 1)[, "loss_mask":
    (B, S)]} -> (ce, {"ce", "loss"})."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    enc_out = encode(params, batch["frames"], cfg, policy=policy)
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    positions = torch.arange(inp.shape[1], device=inp.device)
    h = embed_tokens(params, inp, cfg, positions, dtype, policy)
    rope = rope_for(cfg, positions)
    for i, bp in enumerate(unstack_layers(params["dec_blocks"],
                                          cfg.n_layers)):
        if cfg.remat:
            h = checkpointed(_dec_block, bp, h, enc_out, cfg, policy=policy,
                             layer=i, rope=rope)
        else:
            h = _dec_block(bp, h, enc_out, cfg, policy=policy, layer=i,
                           rope=rope)
    h = apply_norm(h, params["final_norm"], cfg.norm)
    ce = chunked_ce(params, h, labels, batch.get("loss_mask"), cfg, policy)
    return ce, {"ce": ce, "loss": ce}


def cross_kv(params: Params, enc_out: torch.Tensor, cfg,
             policy: QuantPolicy) -> Cache:
    """Every decoder layer's cross K/V of ``enc_out``, stacked {"k", "v"}
    (L, B, S_enc, K, hd) in the carrier."""
    b, s_enc, _ = enc_out.shape
    kh, hd, nl = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    ks, vs = [], []
    for i, bp in enumerate(unstack_layers(params["dec_blocks"], nl)):
        ctx, ca = LinearCtx("attn_qkv", i, nl), bp["cross_attn"]
        ks.append(policy.linear(ctx, enc_out, ca["wk"], ca.get("bk")
                                ).reshape(b, s_enc, kh, hd))
        vs.append(policy.linear(ctx, enc_out, ca["wv"], ca.get("bv")
                                ).reshape(b, s_enc, kh, hd))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def encdec_prefill(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
                   policy=None, max_seq: Optional[int] = None):
    """Encode the frames, compute the cross K/V of every layer once, run the
    decoder prompt ``batch["tokens"]`` (B, S) into self caches of
    ``max_seq`` rows (default S) -> (logits of the last column (B,
    V_padded), state {"self": caches, "cross": cross K/V})."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    enc_out = encode(params, batch["frames"], cfg, policy=policy)
    cross = cross_kv(params, enc_out, cfg, policy)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    h = embed_tokens(params, tokens, cfg, positions, dtype, policy)
    rope = rope_for(cfg, positions)
    caches = init_caches(cfg, b, max_seq, dtype, device=tokens.device)
    for i, bp in enumerate(unstack_layers(params["dec_blocks"],
                                          cfg.n_layers)):
        h = _dec_block(bp, h, None, cfg, policy=policy, layer=i, rope=rope,
                       cache={k: c[i] for k, c in caches.items()},
                       cache_offset=0,
                       cross_kv={k: c[i] for k, c in cross.items()})
    h = apply_norm(h, params["final_norm"], cfg.norm)
    logits = logits_chunk(params, h[:, -1:, :], cfg, policy)[:, 0, :]
    return logits, {"self": caches, "cross": cross}


def encdec_decode(params: Params, state, token: torch.Tensor,
                  pos: Union[int, torch.Tensor], cfg, *, policy=None):
    """One decode step: token (B, 1) at ``pos`` (an int, or (B,) per slot)
    -> (logits (B, V_padded), state); the self caches are written in place
    at ``pos``, the cross K/V read as they are."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    b = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=token.device).reshape(-1).expand(b)
    positions = pos[:, None].long()
    h = embed_tokens(params, token, cfg, positions, dtype, policy)
    rope = rope_for(cfg, positions)
    caches, cross = state["self"], state["cross"]
    for i, bp in enumerate(unstack_layers(params["dec_blocks"],
                                          cfg.n_layers)):
        h = _dec_block(bp, h, None, cfg, policy=policy, layer=i, rope=rope,
                       cache={k: c[i] for k, c in caches.items()},
                       cache_offset=pos,
                       cross_kv={k: c[i] for k, c in cross.items()})
    h = apply_norm(h, params["final_norm"], cfg.norm)
    return logits_chunk(params, h, cfg, policy)[:, 0, :], state


def init_state(cfg, batch: int, max_seq: int, enc_len: int,
               dtype: torch.dtype, device="cpu"):
    """Zero decode state {"self": (L, B, max_seq, K, hd), "cross": (L, B,
    enc_len, K, hd)}, each {"k", "v"} in ``dtype``."""
    return {"self": init_caches(cfg, batch, max_seq, dtype, device=device),
            "cross": init_caches(cfg, batch, enc_len, dtype, device=device)}
