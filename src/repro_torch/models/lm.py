"""Decoder-only language model, dense family: GPT-2 (learned positions,
LayerNorm, tied head), llama (RoPE, RMSNorm, gated MLP, grouped KV heads,
untied head), gemma (scaled embedding, (1 + w) RMSNorm, GeGLU, tied head)
and qwen3 (qk-norm); and the MoE family (granite, phi-3.5-moe: the MLP
replaced by ``models/moe.py``, whose load-balance and z losses the stack
sums and the loss adds, as the reference's ``lm_loss``); embed, a Python loop over the layers in place of the
reference's scan, final norm and head (port of ``repro/models/lm.py``):
the training loss with a chunked cross entropy, prefill and decode.  The
SSM family (Mamba2: ``models/ssm.py``, ``blocks.ssm_block``) runs the same
stack without attention, positions or a mask, and carries per-layer SSM
and conv states in place of the KV caches.  The hybrid family (zamba2)
runs its SSM layers in groups of ``hybrid_attn_every``, each group
followed by the shared attention + MLP block (``blocks.shared_block``) on
concat(h, emb0), emb0 the embedding output (a prefill's or a decode
step's); invocation g reads and writes KV cache g, so it carries both
the stacked SSM states and (G, B, S, K, hd) caches, G = n_layers //
hybrid_attn_every.  Its loss passes emb0, the embedding output, to every
invocation, as the reference's (``_hybrid_loss_stack``).

Positions: a prefill's rows sit at ``arange(S)`` (packed prompts restart
at 0, ``segment_positions_and_mask``), a decode step's at each slot's own
``pos``.  Under learned positions they index the position table; under
RoPE the rotary tables are built from them once per forward
(``common.rope_tables``) and every layer rotates its q and k by them.

The caches are stacked (L, B, S, ...) buffers, as in the JAX package; each
layer works on its view and writes its rows in place, so ``lm_decode``
mutates the caches it is given (the JAX step returns new ones).  The SSM
states are stacked (L, B, ...) too, but ``lm_decode`` returns new ones and
leaves those it is given as they are: a recurrence read and written in
place could not be retried.

Attention follows ``cfg.attention_impl``: under ``"flash_pallas"`` the loss
and the unpacked fp-KV prefill attend through the flash kernels (#8
forward, #9/#10 backward; ``models/attention.py``), as the reference's
``_gqa_attend`` does; decode steps, int8 caches on the fused path and
packed prefills keep their own paths.  ``kv_path`` picks how an int8
cache is read (the kernels, or dequantize-on-read; ``models/attention.py``).

The loss recomputes as the reference does.  Under ``cfg.remat`` (on by
default) each layer runs as two checkpointed halves split at the attention
context (``blocks.block_context``, ``blocks.block_finish``): the backward
keeps a layer's input and its context -- the reference's
``save_only_these_names("attn_ctx")`` -- and recomputes the rest, so every
block linear's forward kernel runs twice a step and the attention forward
twice; an MoE layer's recomputation must route as its forward did, or
it raises (``moe.route_check_contexts``).  Two segments rather than
selective checkpointing, because
``create_selective_checkpoint_contexts`` sees aten ops and not the
``autograd.Function`` around the flash and int8 kernels.  The CE chunks
are always checkpointed (``chunked_ce``), whatever ``cfg.remat`` says, and
``_attend`` runs in checkpointed q-chunks (``models/attention.py``).  The
checkpoints are non-reentrant, so the backward runs the same autograd
graph on recomputed values: loss and gradients are bit-identical with
``remat`` on and off wherever the recomputed ops repeat their bits (the
kernels use no float atomics).  An SSM layer is one checkpointed segment:
it has no attention context, so the reference's ``save_only_these_names(
"attn_ctx")`` keeps nothing inside it.  A hybrid group (``hybrid_attn_every``
SSM layers and the shared block), which the reference checkpoints whole
keeping the shared block's ``attn_ctx``, is two segments split there: the
SSM layers with the shared block's attention context, then the rest of
the shared block.  The backward keeps the group's input, the SSM layers'
output and the context, so each linear's forward and the attention
forward run twice a step there too.  Prefill and decode never
recompute.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.qadam import QState
from repro_torch.core.qpolicy import QuantPolicy, as_policy
from repro_torch.core.quantizer import _div
from repro_torch.models.attention import Cache, init_caches
from repro_torch.models.blocks import (block_apply, block_context,
                                      block_finish, shared_block,
                                      shared_context, shared_finish,
                                      ssm_block)
from repro_torch.models.common import (Params, apply_norm, cast_params,
                                       checkpointed, rope_tables, tree_map)
from repro_torch.models.moe import route_check_contexts
from repro_torch.models.ssm import SSMState, init_ssm_state

_NEG = -1e30
#: the MoE losses' weights in the training loss (the reference's)
AUX_COEF = 0.01
ZLOSS_COEF = 1e-3


def carrier_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def embed_tokens(params: Params, tokens: torch.Tensor, cfg,
                 positions: torch.Tensor, dtype: torch.dtype,
                 policy: QuantPolicy) -> torch.Tensor:
    """Token embedding, times ``sqrt(d_model)`` under ``cfg.embed_scale``
    (gemma; the factor rounded to the carrier first, as the reference's
    ``jnp.asarray(math.sqrt(d), dtype)``: 45.25 at bf16 for d = 2048),
    plus the learned-position one under ``cfg.pos == "learned"``.
    Positions are clamped to that table: a freed slot rides the batched
    decode step with its stale position, which can reach the table size;
    its row is discarded."""
    table = policy.quantize_weight("embed", params["embed"])
    e = table[tokens.long()].to(dtype)
    if cfg.embed_scale:
        e = e * torch.full((), math.sqrt(cfg.d_model), dtype=dtype,
                           device=e.device)
    if cfg.pos != "learned":
        return e
    pos_table = params["pos_embed"]
    pe = pos_table[positions.clamp(0, pos_table.shape[0] - 1)].to(dtype)
    return e + pe


def rope_for(cfg, positions: torch.Tensor):
    """The rotary tables of ``positions`` under RoPE, else None."""
    if cfg.pos != "rope":
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def unstack_layers(blocks: Params, n_layers: int):
    """Per-layer views of the stacked block parameters (prepared QState
    leaves field by field), one ``unbind`` per tensor, so a backward
    stacks each leaf's gradient once."""
    def split(x):
        if isinstance(x, QState):
            return [QState(*f) for f in zip(*(t.unbind(0) for t in x))]
        return x.unbind(0)
    per_leaf = tree_map(split, blocks)
    return [tree_map(lambda t: t[i], per_leaf) for i in range(n_layers)]


def logits_chunk(params: Params, h: torch.Tensor, cfg,
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
        valid = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab_size
        logits = torch.where(valid, logits, _NEG)
    return logits


def _chunk_len(s: int, target: int) -> int:
    if s <= target:
        return s
    for c in range(target, 0, -1):
        if s % c == 0:
            return c
    return s


def _ce_chunk(params: Params, hc: torch.Tensor, lc: torch.Tensor,
              mc: torch.Tensor, cfg, policy: QuantPolicy) -> torch.Tensor:
    """Summed cross entropy of one chunk, weighted by ``mc`` (float32)."""
    logits = logits_chunk(params, hc, cfg, policy)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum((logz - gold) * mc)


def chunked_ce(params: Params, h: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor], cfg,
               policy: QuantPolicy) -> torch.Tensor:
    """Mean cross entropy over the sequence in chunks of ``cfg.logit_chunk``
    positions, each chunk checkpointed (the reference's ``jax.checkpoint``
    of the chunk body): the fp32 logits of one chunk exist at a time, in
    the forward and again in the backward, which recomputes them."""
    b, s, _ = h.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    chunk = _chunk_len(s, cfg.logit_chunk or s)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        mc = mask[:, i:i + chunk].to(torch.float32)
        tot = tot + checkpointed(_ce_chunk, params, h[:, i:i + chunk],
                                 labels[:, i:i + chunk], mc, cfg, policy)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            policy=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"tokens": (B, S + 1) int[, "loss_mask": (B, S)]} -> (loss,
    metrics).  ``policy`` is anything ``as_policy`` accepts."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    # one (S,) row of positions, broadcast over the batch: the position
    # table's gradient is then a batch sum, not an accumulating scatter
    # whose order (and last bits) vary from run to run
    positions = torch.arange(inp.shape[1], device=inp.device)
    h = embed_tokens(params, inp, cfg, positions, dtype, policy)
    rope = rope_for(cfg, positions)
    moe_routes = None
    if cfg.n_experts:
        aux = z = torch.zeros((), dtype=torch.float32, device=h.device)
        # the recomputation must route as the forward did
        moe_routes = route_check_contexts
    layers = unstack_layers(params["blocks"], cfg.n_layers)
    if cfg.family == "hybrid":
        h = _hybrid_loss_stack(params["shared"], layers, h, cfg, policy, rope)
    else:
        for i, lp in enumerate(layers):
            if cfg.family == "ssm":
                # one segment a layer: there is no attention context to keep
                h = (checkpointed(ssm_block, lp, h, cfg, policy=policy,
                                  layer=i)
                     if cfg.remat else
                     ssm_block(lp, h, cfg, policy=policy, layer=i))[0]
            elif cfg.remat:
                # the reference's save_only_these_names("attn_ctx"): the
                # backward keeps h and ctx and recomputes each half
                ctx = checkpointed(block_context, lp, h, cfg, policy=policy,
                                   layer=i, rope=rope)
                h, a, zz = checkpointed(block_finish, lp, h, ctx, cfg,
                                        policy=policy, layer=i,
                                        context_fn=moe_routes)
            else:
                h, a, zz = block_apply(lp, h, cfg, policy=policy, layer=i,
                                       rope=rope)
            if cfg.n_experts:
                aux, z = aux + a, z + zz
    h = apply_norm(h, params["final_norm"], cfg.norm)
    ce = chunked_ce(params, h, labels, batch.get("loss_mask"), cfg, policy)
    metrics = {"ce": ce}
    total = ce
    if cfg.n_experts:
        nl = float(cfg.n_layers)
        total = total + _div(AUX_COEF * aux, nl) + _div(ZLOSS_COEF * z, nl)
        metrics.update(moe_aux=_div(aux, nl), moe_z=_div(z, nl))
    metrics["loss"] = total
    return total, metrics


def _hybrid_context(group, shared: Params, h: torch.Tensor,
                    emb0: torch.Tensor, cfg, *, policy: QuantPolicy,
                    first: int, rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first half of a hybrid group in the loss: its SSM layers (the
    stack's layers ``first``, ``first + 1``, ...), then the shared block's
    attention context on concat(h, emb0) -> (h, ctx)."""
    for j, lp in enumerate(group):
        h = ssm_block(lp, h, cfg, policy=policy, layer=first + j)[0]
    x2 = torch.cat([h, emb0], dim=-1)
    return h, shared_context(shared, x2, cfg, policy=policy, rope=rope)


def _hybrid_finish(shared: Params, h: torch.Tensor, emb0: torch.Tensor,
                   ctx: torch.Tensor, cfg, *,
                   policy: QuantPolicy) -> torch.Tensor:
    """The second half of a hybrid group in the loss: the rest of the
    shared block (``blocks.shared_finish``) on concat(h, emb0), built
    again here rather than kept."""
    x2 = torch.cat([h, emb0], dim=-1)
    return shared_finish(shared, h, x2, ctx, cfg, policy=policy)


def _hybrid_loss_stack(shared: Params, layers, h: torch.Tensor, cfg,
                       policy: QuantPolicy, rope) -> torch.Tensor:
    """The hybrid's stack in the loss: groups of ``hybrid_attn_every`` SSM
    layers, each followed by the shared block on concat(h, emb0), emb0 the
    embedding output.  Each group runs as two halves split at the shared
    block's attention context (:func:`_hybrid_context`,
    :func:`_hybrid_finish`), checkpointed under ``cfg.remat`` -- the
    reference checkpoints the whole group keeping ``attn_ctx`` -- and
    called as they are without it, so the autograd graph, and with it the
    order in which the shared weights' 9 gradients (one an invocation) are
    summed, is the same either way."""
    per, emb0 = cfg.hybrid_attn_every, h
    for first in range(0, len(layers), per):
        group = layers[first:first + per]
        if cfg.remat:
            h, ctx = checkpointed(_hybrid_context, group, shared, h, emb0,
                                  cfg, policy=policy, first=first, rope=rope)
            h = checkpointed(_hybrid_finish, shared, h, emb0, ctx, cfg,
                             policy=policy)
        else:
            h, ctx = _hybrid_context(group, shared, h, emb0, cfg,
                                     policy=policy, first=first, rope=rope)
            h = _hybrid_finish(shared, h, emb0, ctx, cfg, policy=policy)
    return h


def _run_stack(params: Params, h: torch.Tensor, cfg, policy: QuantPolicy,
               caches: Optional[Cache], cache_offset, positions: torch.Tensor,
               page_table=None, mask=None, kv_path=None,
               ssm_states: Optional[SSMState] = None, decode: bool = False):
    """-> (final-normed h, the new SSM states stacked over the layers, or
    None without them).  The caches are written in place.  The hybrid's
    shared block follows every ``hybrid_attn_every``-th SSM layer, on
    concat(h, the stack's input h)."""
    rope = rope_for(cfg, positions)
    emb0 = h
    per = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    new = []
    for i, lp in enumerate(unstack_layers(params["blocks"], cfg.n_layers)):
        if ssm_states is not None:
            h, st = ssm_block(lp, h, cfg, policy=policy, layer=i,
                              state={k: v[i] for k, v in ssm_states.items()},
                              decode=decode)
            new.append(st)
            if per and (i + 1) % per == 0:
                g = i // per
                h = shared_block(params["shared"], h, emb0, cfg,
                                 policy=policy,
                                 cache={k: c[g] for k, c in caches.items()},
                                 cache_offset=cache_offset, mask=mask,
                                 rope=rope, kv_path=kv_path)
            continue
        h, _, _ = block_apply(lp, h, cfg, policy=policy, layer=i,
                              cache={k: c[i] for k, c in caches.items()},
                              cache_offset=cache_offset,
                              page_table=page_table, mask=mask, rope=rope,
                              kv_path=kv_path)
    states = ({k: torch.stack([st[k] for st in new]) for k in new[0]}
              if new else None)
    return apply_norm(h, params["final_norm"], cfg.norm), states


def init_decode_caches(cfg, batch: int, max_seq: int, dtype: torch.dtype,
                       kv_spec=None, device="cpu"):
    """(KV caches, SSM states) of the whole stack, the reference's
    ``init_caches``: KV caches and no SSM states for the attention
    families, the reverse for the SSM family, both for the hybrid (one KV
    cache a shared-block invocation)."""
    caches = states = None
    if cfg.family in ("ssm", "hybrid"):
        states = init_ssm_state(cfg, batch, dtype, device=device)
    if cfg.family != "ssm":
        caches = init_caches(cfg, batch, max_seq, dtype, kv_spec=kv_spec,
                             device=device)
    return caches, states


def segment_positions_and_mask(segments: torch.Tensor, max_seq: int):
    """Packed prompts: ``segments`` (B, S) int, equal ids one prompt's span,
    -1 padding -> (positions (B, S) restarting at each span's start, mask
    (B, S, max_seq): same segment, causal, real query row)."""
    b, s = segments.shape
    seg = segments.long()
    t = torch.arange(s, device=seg.device)
    is_start = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                     device=seg.device),
                          seg[:, 1:] != seg[:, :-1]], dim=1)
    starts = torch.cummax(torch.where(is_start, t[None, :], 0), dim=1).values
    segk = torch.full((b, max_seq), -1, dtype=seg.dtype, device=seg.device)
    segk[:, :s] = seg
    causal = t[:, None] >= torch.arange(max_seq, device=seg.device)[None, :]
    mask = ((seg[:, :, None] == segk[:, None, :]) & causal[None]
            & (seg >= 0)[:, :, None])
    return t[None, :] - starts, mask


def lm_prefill(params: Params, tokens: torch.Tensor, cfg, *, policy=None,
               max_seq: Optional[int] = None,
               last_pos: Optional[torch.Tensor] = None,
               segments: Optional[torch.Tensor] = None,
               kv_path: Optional[str] = None):
    """Process right-padded prompts (B, S); returns (logits, caches sized
    to ``max_seq`` (default S), SSM states).  The SSM family has no caches
    (None) and returns the states after the whole padded row: its pad
    tokens enter the state, as in the reference (ROADMAP section 3); the
    hybrid returns both.
    ``last_pos`` picks the logits' rows: None the last column, (B,)
    per-row indices (B logits), or (M, 2) ``(row, col)`` pairs (M logits,
    one per packed prompt).  ``segments`` (B, S)
    packs several prompts into a row: equal ids one prompt, -1 padding;
    positions restart per prompt and each attends only to itself (fp KV
    caches and ``kv_path="dequant"`` only: the int8-KV flash kernel is
    causal-only).  ``kv_path`` how an int8 cache is read
    (``attention.KV_PATHS``; None: the kernels where they take the spec)."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    b, s = tokens.shape
    device = tokens.device
    max_seq = max_seq or s
    mask = None
    if segments is None:
        positions = torch.arange(s, device=device).expand(b, s)
    elif cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            "packed (segment-id) prefill is attention-family only")
    else:
        positions, mask = segment_positions_and_mask(segments.to(device),
                                                     max_seq)
    h = embed_tokens(params, tokens, cfg, positions, dtype, policy)
    caches, ssm_states = init_decode_caches(cfg, b, max_seq, dtype,
                                            kv_spec=policy.kv_spec(),
                                            device=device)
    h, ssm_states = _run_stack(params, h, cfg, policy, caches, 0, positions,
                               mask=mask, kv_path=kv_path,
                               ssm_states=ssm_states)
    if last_pos is None:
        hc = h[:, -1:, :]
    else:
        lp = last_pos.to(device).long()
        if lp.dim() == 2:                        # (M, 2) packed (row, col)
            hc = h[lp[:, 0], lp[:, 1]][:, None, :]
        else:
            hc = h[torch.arange(b, device=device), lp][:, None, :]
    return logits_chunk(params, hc, cfg, policy)[:, 0, :], caches, ssm_states


def lm_decode(params: Params, caches: Optional[Cache], token: torch.Tensor,
              pos: torch.Tensor, cfg, *, policy=None,
              page_table: Optional[torch.Tensor] = None,
              kv_path: Optional[str] = None,
              ssm_states: Optional[SSMState] = None):
    """One-token decode.  token: (B, 1); pos: (B,) int32 per-slot count of
    tokens already in the cache (each slot writes its own row and masks its
    own history); ``page_table`` (B, maxp) int32 makes the caches page
    pools (L, P, page, K, hd), a slot's logical cache ``maxp * page`` rows;
    ``kv_path`` as in :func:`lm_prefill`.  Returns (logits (B, V_padded),
    caches, SSM states) -- the caches are updated in place; the SSM family
    (caches None) and the hybrid step from ``ssm_states`` and return new
    ones, leaving those given as they were."""
    policy = as_policy(policy)
    dtype = carrier_dtype(cfg)
    params = cast_params(params, dtype)
    pos = pos.to(device=token.device, dtype=torch.int32)
    if page_table is not None:
        page_table = page_table.to(device=token.device, dtype=torch.int32)
    positions = pos[:, None].long()
    h = embed_tokens(params, token, cfg, positions, dtype, policy)
    h, ssm_states = _run_stack(params, h, cfg, policy, caches, pos,
                               positions, page_table, kv_path=kv_path,
                               ssm_states=ssm_states, decode=True)
    return logits_chunk(params, h, cfg, policy)[:, 0, :], caches, ssm_states
