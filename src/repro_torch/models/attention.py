"""Dense self-attention with a KV cache (port of the serving branches of
``repro/models/attention.py``).

Three branches, chosen by how the cache is stored and whether the call is
a prefill (``cache_offset`` an int: the prompt's rows are written at that
offset) or a decode step (``cache_offset`` a (B,) tensor of per-slot
positions):

* int8 cache, prefill -- quantize the new K/V rows (per position x head),
  write them, then the int8-KV flash kernel attends over the whole stored
  buffer; the causal mask hides the never-written tail;
* int8 cache, decode -- the fused decode kernel attends on the stored
  payload, quantizes the step's row and writes it in place;
* fp cache -- write the rows, then plain torch matmul + fp32 softmax.

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
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.kernels.flash_attn import flash_attention_fwd_q8

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
    s = s / torch.full_like(s, math.sqrt(hd))   # IEEE division, as in JAX
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    ctx = torch.einsum("bkgst,btkh->bskgh", p, v)
    return ctx.reshape(b, sq, h * hd)


def attn_apply(params, x: torch.Tensor, cfg, *, policy: QuantPolicy,
               cache: Cache, cache_offset: Union[int, torch.Tensor],
               layer: Optional[int] = None, n_layers: int = 0
               ) -> torch.Tensor:
    """One self-attention call against one layer's cache (written in
    place).  ``cache_offset``: int for a prefill, (B,) int32 tensor of
    per-slot positions for a decode step (s == 1)."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ctx_qkv = LinearCtx("attn_qkv", layer, n_layers)
    ctx_out = LinearCtx("attn_out", layer, n_layers)
    q = policy.linear(ctx_qkv, x, params["wq"], params.get("bq")
                      ).reshape(b, s, h, hd)
    k = policy.linear(ctx_qkv, x, params["wk"], params.get("bk")
                      ).reshape(b, s, kh, hd)
    v = policy.linear(ctx_qkv, x, params["wv"], params.get("bv")
                      ).reshape(b, s, kh, hd)
    decode = isinstance(cache_offset, torch.Tensor)
    smax = cache["k"].shape[1]

    if "k_scale" in cache:
        if policy.decode_attn_backend()[0] != INT8_BACKEND:
            raise NotImplementedError(
                "int8 KV cache whose spec no attention kernel takes (the "
                "dequantize-on-read path is not ported)")
        kv_spec = policy.kv_spec()
        if decode:
            qg = q[:, 0].reshape(b, kh, h // kh, hd)
            ctx = decode_attention(
                qg, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
                k[:, 0].contiguous(), v[:, 0].contiguous(), cache_offset,
                qmin=kv_spec.qmin, qmax=kv_spec.qmax)
            ctx = ctx.reshape(b, 1, h * hd)
        else:
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
    else:
        kpos = torch.arange(smax, device=x.device)
        if decode:
            at = cache_offset.long().clamp(0, smax - 1)
            slots = torch.arange(b, device=x.device)
            cache["k"][slots, at] = k[:, 0].to(cache["k"].dtype)
            cache["v"][slots, at] = v[:, 0].to(cache["v"].dtype)
            mask = (kpos[None, :] <= cache_offset.long()[:, None]
                    )[:, None, None, None, :]
        else:
            cache["k"][:, cache_offset:cache_offset + s] = k.to(cache["k"].dtype)
            cache["v"][:, cache_offset:cache_offset + s] = v.to(cache["v"].dtype)
            qpos = torch.arange(s, device=x.device) + cache_offset
            mask = kpos[None, :] <= qpos[:, None]
        ctx = _attend(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), mask)
    return policy.linear(ctx_out, ctx, params["wo"], params.get("bo"))
