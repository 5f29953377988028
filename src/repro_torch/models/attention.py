"""Self-attention, for training and with a KV cache for serving (port of
``repro/models/attention.py``).

Training (``cache=None``): causal self-attention over the sequence.  Under
``attention_impl="xla"`` plain torch matmuls with an fp32 softmax
(``_attend``); under ``"flash_pallas"`` the flash kernels (``_flash``:
#8 forward, #9/#10 backward, through ``kernels.flash_attn.flash_attention``),
which never materialize the (S, S) scores.  The flash branch is taken
where the reference's ``_flash_path_ok`` takes it: more than one query
row and a causal (or no) mask -- training, and the unpacked prefill of an
fp cache -- and nowhere else (decode steps, int8 caches, packed prefills).

With a cache, the branch follows how the cache is stored and whether the
call is a prefill (``cache_offset`` an int: the prompt's rows are written
at that offset into a dense (B, max_seq) buffer) or a decode step
(``cache_offset`` a (B,) tensor of per-slot positions; with a
``page_table`` the cache is a set of page pools, ``(P, page, K, hd)``
shared by every slot):

* int8 cache, prefill -- quantize the new K/V rows (per position x head),
  write them, then the int8-KV flash kernel attends over the whole stored
  buffer; the causal mask hides the never-written tail;
* int8 cache, decode -- the fused decode kernel (dense strips) or its paged
  twin (pools) attends on the stored payload, quantizes the step's row and
  writes it in place;
* fp cache -- write the rows (paged: at ``(table[b, pc // page], pc %
  page)``, ``pc = min(pos, maxp * page - 1)``, then gather each slot's
  logical view), then plain torch matmul + fp32 softmax.  A packed prefill
  passes its (B, S, max_seq) segment mask here.  Under ``"flash_pallas"``
  an unpacked prefill attends through the flash forward (#8) over the
  whole max_seq buffer instead; the causal mask hides its never-written
  rows.

Under RoPE (``cfg.pos == "rope"``) q and k are rotated before any of
this, k before it is written: ``rope`` carries the rotary tables of the
call's positions (``common.rope_tables``, built once per forward), a
prefill's ``arange(S)`` (restarting per packed prompt) or a decode step's
per-slot positions.  Grouped KV heads are KV-major everywhere: query head
h reads KV head ``h // (H // K)``, as the reference's reshape and repeat.

The kernel wrappers pick kernel or plain version from the tensors' device.
The reference's dequantize-on-read branch has no counterpart: an int8 cache
here is always consumed by the kernels, which keep the dequantized K/V in
fp32 (see ROADMAP, the carrier-precision finding).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.core.qpolicy import INT8_BACKEND, LinearCtx, QuantPolicy
from repro_torch.core.quantizer import quantize_int, storage_dtype
from repro_torch.models.common import apply_rope
from repro_torch.kernels.decode_attn import (paged_logical_view, decode_attention,
                                             decode_attention_paged)
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_fwd_q8)

Cache = Dict[str, torch.Tensor]


def init_caches(cfg, batch: int, max_seq: int, dtype: torch.dtype,
                kv_spec=None, device: Union[str, torch.device] = "cpu") -> Cache:
    """KV cache buffers stacked over the layers: (L, B, S, K, hd) in the
    carrier, or int8 payloads plus (L, B, S, K, 1) fp32 scales when
    ``kv_spec`` (``policy.kv_spec()``) is set.  Never-written rows hold
    payload 0 and scale 0."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if kv_spec is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    qdt = storage_dtype(kv_spec.bits)
    side = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=qdt, device=device),
            "v": torch.zeros(shape, dtype=qdt, device=device),
            "k_scale": torch.zeros(side, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(side, dtype=torch.float32, device=device)}


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Grouped attention on fp K/V.  q: (B, Sq, H, hd); k, v: (B, Skv, K,
    hd); mask: boolean, broadcastable to (B, 1, 1, Sq, Skv), True = attend.
    Scores and softmax in fp32, probabilities cast to v's dtype for the
    context product (the reference's ``_attend_block``)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                     k.to(torch.float32))
    # a 0-d tensor divisor: an IEEE division on every device, as in JAX
    s = s / torch.full((), math.sqrt(hd), dtype=s.dtype, device=s.device)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    ctx = torch.einsum("bkgst,btkh->bskgh", p, v)
    return ctx.reshape(b, sq, h * hd)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int = 0) -> torch.Tensor:
    """Causal attention through the flash kernels, differentiable.  q: (B,
    Sq, H, hd); k, v: (B, Skv, K, hd) -> (B, Sq, H * hd).  As the
    reference's flash branch of ``_gqa_attend``: kv heads repeated to H
    (GQA), each tensor transposed to the kernels' (B * H, S, hd) layout and
    back (copies; the kernels take contiguous rows)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    if h != kh:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)

    def heads_first(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], hd).contiguous()
    o = flash_attention(heads_first(q), heads_first(k), heads_first(v),
                        True, q_offset)
    return o.reshape(b, h, sq, hd).transpose(1, 2).reshape(b, sq, h * hd)


def attn_apply(params, x: torch.Tensor, cfg, *, policy: QuantPolicy,
               cache: Optional[Cache] = None,
               cache_offset: Union[int, torch.Tensor, None] = None,
               page_table: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               rope=None,
               layer: Optional[int] = None, n_layers: int = 0
               ) -> torch.Tensor:
    """One self-attention call.  ``cache=None``: causal attention over the
    sequence (training).  Otherwise against one layer's cache (written in
    place); ``cache_offset``: int for a prefill, (B,) int32 tensor of
    per-slot positions for a decode step (s == 1); ``page_table`` (B, maxp)
    int32 makes the cache page pools (decode only); ``mask`` (B, S,
    max_seq) boolean replaces a prefill's causal mask (packed prompts);
    ``rope`` the (cos, sin) tables of the call's positions, which rotate q
    and k (RoPE configs; None under learned positions)."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ctx_qkv = LinearCtx("attn_qkv", layer, n_layers)
    ctx_out = LinearCtx("attn_out", layer, n_layers)
    # the reference's _flash_path_ok: flash_pallas, more than one query row
    flash = cfg.attention_impl == "flash_pallas" and s > 1
    q = policy.linear(ctx_qkv, x, params["wq"], params.get("bq")
                      ).reshape(b, s, h, hd)
    k = policy.linear(ctx_qkv, x, params["wk"], params.get("bk")
                      ).reshape(b, s, kh, hd)
    v = policy.linear(ctx_qkv, x, params["wv"], params.get("bv")
                      ).reshape(b, s, kh, hd)
    if rope is not None:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    if cache is None:
        if flash:
            ctx = _flash(q, k, v)
        else:
            pos = torch.arange(s, device=x.device)
            ctx = _attend(q, k, v, pos[None, :] <= pos[:, None])
        return policy.linear(ctx_out, ctx, params["wo"], params.get("bo"))
    decode = isinstance(cache_offset, torch.Tensor)
    if page_table is not None and not decode:
        raise ValueError("page_table is a decode-step argument: a prefill "
                         "fills a dense buffer that the engine pages in")

    if "k_scale" in cache:
        if policy.decode_attn_backend()[0] != INT8_BACKEND:
            raise NotImplementedError(
                "int8 KV cache whose spec no attention kernel takes (the "
                "dequantize-on-read path is not ported)")
        kv_spec = policy.kv_spec()
        if decode:
            qg = q[:, 0].reshape(b, kh, h // kh, hd)
            args = (qg, cache["k"], cache["k_scale"], cache["v"],
                    cache["v_scale"], k[:, 0].contiguous(),
                    v[:, 0].contiguous(), cache_offset)
            if page_table is None:
                ctx = decode_attention(*args, qmin=kv_spec.qmin,
                                       qmax=kv_spec.qmax)
            else:
                ctx = decode_attention_paged(*args, page_table,
                                             qmin=kv_spec.qmin,
                                             qmax=kv_spec.qmax)
            ctx = ctx.reshape(b, 1, h * hd)
        else:
            if mask is not None:
                raise NotImplementedError(
                    "a masked (packed) prefill on an int8 cache: the int8-KV "
                    "flash kernel takes the causal mask only, so the engine "
                    "prefills one prompt per row there")
            rows = slice(cache_offset, cache_offset + s)
            kq, ks, _ = quantize_int(k, kv_spec)
            vq, vs, _ = quantize_int(v, kv_spec)
            cache["k"][:, rows] = kq
            cache["k_scale"][:, rows] = ks
            cache["v"][:, rows] = vq
            cache["v_scale"][:, rows] = vs
            ctx = flash_attention_fwd_q8(
                q.contiguous(), cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], causal=True, q_offset=cache_offset)
            ctx = ctx.reshape(b, s, h * hd)
    elif decode:
        slots = torch.arange(b, device=x.device)
        if page_table is None:
            kv_len = cache["k"].shape[1]
            at = cache_offset.long().clamp(0, kv_len - 1)
            cache["k"][slots, at] = k[:, 0].to(cache["k"].dtype)
            cache["v"][slots, at] = v[:, 0].to(cache["v"].dtype)
            kf, vf = cache["k"], cache["v"]
        else:
            page = cache["k"].shape[1]
            kv_len = page_table.shape[1] * page
            pc = cache_offset.long().clamp(0, kv_len - 1)
            pid = page_table.long()[slots, pc // page]
            cache["k"][pid, pc % page] = k[:, 0].to(cache["k"].dtype)
            cache["v"][pid, pc % page] = v[:, 0].to(cache["v"].dtype)
            kf = paged_logical_view(cache["k"], page_table)
            vf = paged_logical_view(cache["v"], page_table)
        kpos = torch.arange(kv_len, device=x.device)
        dmask = (kpos[None, :] <= cache_offset.long()[:, None]
                 )[:, None, None, None, :]
        ctx = _attend(q, kf.to(x.dtype), vf.to(x.dtype), dmask)
    else:
        smax = cache["k"].shape[1]
        cache["k"][:, cache_offset:cache_offset + s] = k.to(cache["k"].dtype)
        cache["v"][:, cache_offset:cache_offset + s] = v.to(cache["v"].dtype)
        kf, vf = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        if flash and mask is None:
            ctx = _flash(q, kf, vf, cache_offset)
        else:
            if mask is None:
                qpos = torch.arange(s, device=x.device) + cache_offset
                mask = (torch.arange(smax, device=x.device)[None, :]
                        <= qpos[:, None])
            else:
                mask = mask[:, None, None]
            ctx = _attend(q, kf, vf, mask)
    return policy.linear(ctx_out, ctx, params["wo"], params.get("bo"))
