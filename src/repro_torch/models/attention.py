"""Self-attention, for training and with a KV cache for serving (port of
``repro/models/attention.py``).

Training (``cache=None``): causal self-attention over the sequence.  Under
``attention_impl="xla"`` plain torch matmuls with an fp32 softmax
(``_attend``, in checkpointed q-chunks of ``_pick_chunk``'s length, which
keeps each fp32 score slab under ``SCORE_BUDGET_BYTES``, as the
reference's ``_gqa_attend``); under ``"flash_pallas"`` the flash kernels
(``_flash``: #8 forward, #9/#10 backward, through
``kernels.flash_attn.flash_attention``), which never materialize the (S,
S) scores.  The flash branch is taken
where the reference's ``_flash_path_ok`` takes it: more than one query
row and a causal (or no) mask -- training, and the unpacked prefill of an
fp cache -- and nowhere else (decode steps, int8 caches, packed prefills).

With a cache, the branch follows how the cache is stored, the ``kv_path``
an int8 cache is read by, and whether the call is a prefill
(``cache_offset`` an int: the prompt's rows are written at that offset
into a dense (B, max_seq) buffer) or a decode step (``cache_offset`` a
(B,) tensor of per-slot positions; with a ``page_table`` the cache is a
set of page pools, ``(P, page, K, hd)`` shared by every slot):

* int8 cache, ``kv_path="fused"`` (the default where the kernels take the
  policy's KV spec, ``policy.decode_attn_backend()``), prefill -- quantize
  the new K/V rows (per position x head), write them, then the int8-KV
  flash kernel attends over the whole stored buffer; the causal mask hides
  the never-written tail;
* int8 cache, ``kv_path="fused"``, decode -- the fused decode kernel
  (dense strips) or its paged twin (pools) attends on the stored payload,
  quantizes the step's row and writes it in place;
* int8 cache, ``kv_path="dequant"`` (the default for any other spec: per
  tensor, 4-bit) -- dequantize on read, the reference's bit-compared
  branch: quantize the new rows (``_kv_quant``: per token, or one scale per
  slot's write block), write them as the fp cache's rows are written, then
  dequantize the buffer (payload x guarded scale, cast to the carrier; a
  paged step gathers each slot's logical view first) and attend as below;
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
The two int8 paths differ by carrier rounding: the kernels keep the
dequantized K/V in fp32, the dequantize-on-read path rounds them to the
carrier (see ROADMAP, the carrier-precision finding).  The serving
engine's degradation ladder picks the path per step (``infer/engine.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.core.qconfig import Granularity
from repro_torch.core.qpolicy import INT8_BACKEND, LinearCtx, QuantPolicy
from repro_torch.core.quantizer import (compute_scale_zero, quantize_int,
                                        storage_dtype)
from repro_torch.models.common import apply_rope, checkpointed
from repro_torch.kernels.decode_attn import (paged_logical_view, decode_attention,
                                             decode_attention_paged)
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_fwd_q8)
from repro_torch.kernels.int8_matmul import scale_guard

Cache = Dict[str, torch.Tensor]

#: the two ways an int8 KV cache is read: the int8-KV kernels, or
#: dequantize-on-read
KV_PATHS = ("fused", "dequant")


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


def default_kv_path(policy: QuantPolicy) -> str:
    """``"fused"`` where the int8-KV kernels take the policy's KV spec,
    else ``"dequant"``."""
    return ("fused" if policy.decode_attn_backend()[0] == INT8_BACKEND
            else "dequant")


def dequant_kv(payload: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Payload x guarded scale in float32, cast to ``dtype``: the scale of
    a never-written row is 0 (every written row's is > 0) and its payload
    0, so the guard (0 -> 1) keeps it exactly 0."""
    return (payload.to(torch.float32) * scale_guard(scale)).to(dtype)


def kv_quant(t: torch.Tensor, spec):
    """Quantize new K/V rows (B, s, K, hd) for the cache -> (payload, fp32
    scale (B, s, K, 1)).  Per-token specs give one scale per (slot,
    position, head); per-tensor specs one per slot's write block, never
    reduced over the batch (the reference's ``_kv_quant``).  Every division
    is by a tensor (``quantizer._div``), so the bits are the same on every
    device."""
    if spec.granularity is Granularity.PER_TENSOR:
        xf = t.to(torch.float32)
        scale, _ = compute_scale_zero(xf, spec, axes=(1, 2, 3))
        q = torch.clamp(torch.round(xf / scale), spec.qmin,
                        spec.qmax).to(storage_dtype(spec.bits))
    else:
        q, scale, _ = quantize_int(t, spec)
    return q, scale.to(torch.float32).expand(t.shape[:-1] + (1,))


#: the largest q-chunk of :func:`_attend` (the reference's ``MAX_DENSE_Q``)
MAX_DENSE_Q = 1024
#: the fp32 score slab one q-chunk may take: the reference's 768 MB,
#: read at each call (a caller lifts it to run ``_attend`` in one block)
SCORE_BUDGET_BYTES = 768e6


def _pick_chunk(sq: int, skv: int, b: int, h: int,
                budget_bytes: Optional[float] = None) -> int:
    """Largest power-of-two q-chunk (<= ``MAX_DENSE_Q``, dividing sq) whose
    fp32 score slab (b, h, chunk, skv) stays under ``budget_bytes``
    (default :data:`SCORE_BUDGET_BYTES`; the reference's ``_pick_chunk``
    on one card: no data or tensor axes)."""
    if budget_bytes is None:
        budget_bytes = SCORE_BUDGET_BYTES
    chunk = MAX_DENSE_Q
    while chunk > 128 and b * h * chunk * skv * 4 > budget_bytes:
        chunk //= 2
    while sq % chunk:
        chunk //= 2
    return max(chunk, 1)


def _mask_chunk(mask, qpos: torch.Tensor, s_kv: int):
    """The mask of the query rows ``qpos``: None (full), ``"causal"`` (key
    position <= query position, as a (len(qpos), s_kv) boolean), or a
    materialized boolean mask, returned as it is."""
    if isinstance(mask, str):
        if mask != "causal":
            raise ValueError(mask)
        kpos = torch.arange(s_kv, device=qpos.device)
        return kpos[None, :] <= qpos[:, None]
    return mask


def _attend_block(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask_b) -> torch.Tensor:
    """qg: (B, c, K, G, hd); k, v: (B, Skv, K, hd); mask_b boolean,
    broadcastable to (B, K, G, c, Skv), or None -> ctx (B, c, K, G, hd).
    Scores and softmax in fp32, probabilities cast to v's dtype for the
    context product (the reference's ``_attend_block``)."""
    hd = qg.shape[-1]
    s = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                     k.to(torch.float32))
    # a 0-d tensor divisor: an IEEE division on every device, as in JAX
    s = s / torch.full((), math.sqrt(hd), dtype=s.dtype, device=s.device)
    if mask_b is not None:
        s = s.masked_fill(~mask_b, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", p, v)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
            q_offset: int = 0) -> torch.Tensor:
    """Grouped attention on fp K/V.  q: (B, Sq, H, hd); k, v: (B, Skv, K,
    hd) -> ctx (B, Sq, H * hd).  ``mask``: ``"causal"`` (query row i at
    position ``q_offset + i``), None, or a materialized boolean mask
    broadcastable to (B, 1, 1, Sq, Skv), True = attend.

    As the reference's ``_gqa_attend``: more than one query row under a
    ``"causal"`` or no mask runs in q-chunks of :func:`_pick_chunk`, each
    chunk's body checkpointed (its backward recomputes the chunk's scores
    and probabilities instead of keeping a slab a chunk), so at most one
    (B, H, chunk, Skv) fp32 slab exists at a time; a decode step (one row)
    and a materialized mask (packed prefill) run in one block."""
    b, sq, h, hd = q.shape
    kh, skv = k.shape[2], k.shape[1]
    qg = q.reshape(b, sq, kh, h // kh, hd)
    chunk = sq
    if sq > 1 and not isinstance(mask, torch.Tensor):
        chunk = _pick_chunk(sq, skv, b, h)
    qpos = torch.arange(sq, device=q.device) + q_offset
    if chunk == sq:
        ctx = _attend_block(qg, k, v, _mask_chunk(mask, qpos, skv))
    else:
        ctx = torch.cat([
            checkpointed(_attend_block, qg[:, i:i + chunk], k, v,
                         _mask_chunk(mask, qpos[i:i + chunk], skv))
            for i in range(0, sq, chunk)], dim=1)
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


def attn_out(params, ctx: torch.Tensor, *, policy: QuantPolicy,
             layer: Optional[int] = None, n_layers: int = 0) -> torch.Tensor:
    """The output projection (role ``attn_out``) of the attention context."""
    return policy.linear(LinearCtx("attn_out", layer, n_layers), ctx,
                         params["wo"], params.get("bo"))


def attn_context(params, x: torch.Tensor, cfg, *, policy: QuantPolicy,
                 cache: Optional[Cache] = None,
                 cache_offset: Union[int, torch.Tensor, None] = None,
                 page_table: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 rope=None, kv_path: Optional[str] = None,
                 layer: Optional[int] = None, n_layers: int = 0
                 ) -> torch.Tensor:
    """The attention context (B, s, H * hd), the input of ``attn_out``,
    which the reference names ``attn_ctx`` for its recomputation policy
    (``models/lm.py`` keeps it).  ``cache=None``: causal attention over the
    sequence (training).  Otherwise against one layer's cache (written in
    place); ``cache_offset``: int for a prefill, (B,) int32 tensor of
    per-slot positions for a decode step (s == 1); ``page_table`` (B, maxp)
    int32 makes the cache page pools (decode only); ``mask`` (B, S,
    max_seq) boolean replaces a prefill's causal mask (packed prompts);
    ``rope`` the (cos, sin) tables of the call's positions, which rotate q
    and k (RoPE configs; None under learned positions); ``kv_path`` how an
    int8 cache is read, one of :data:`KV_PATHS` (None:
    :func:`default_kv_path`; "fused" only where the kernels take the
    spec)."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ctx_qkv = LinearCtx("attn_qkv", layer, n_layers)
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
        return _flash(q, k, v) if flash else _attend(q, k, v, "causal")
    decode = isinstance(cache_offset, torch.Tensor)
    if page_table is not None and not decode:
        raise ValueError("page_table is a decode-step argument: a prefill "
                         "fills a dense buffer that the engine pages in")
    quantized = "k_scale" in cache
    if quantized:
        kv_spec = policy.kv_spec()
        default = default_kv_path(policy)
        kv_path = kv_path or default
        if kv_path not in KV_PATHS or (kv_path == "fused"
                                       and default != "fused"):
            raise ValueError(f"kv_path {kv_path!r}: one of {KV_PATHS}, "
                             f"'fused' only where the int8-KV kernels take "
                             f"the KV spec ({kv_spec.describe()} takes "
                             f"{default!r})")

    if quantized and kv_path == "fused":
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
                raise ValueError(
                    "a masked (packed) prefill on the fused int8 path: the "
                    "int8-KV flash kernel takes the causal mask only, so "
                    "the engine prefills one prompt per row there")
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
        return ctx

    # an fp cache, or an int8 one read by dequantize-on-read: write the new
    # rows (quantized first for an int8 cache), read the buffer back in the
    # carrier, attend
    use_flash = flash and not decode and mask is None
    if quantized:
        kq, ks = kv_quant(k, kv_spec)
        vq, vs = kv_quant(v, kv_spec)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    if decode:
        slots = torch.arange(b, device=x.device)
        if page_table is None:
            kv_len = cache["k"].shape[1]
            at = cache_offset.long().clamp(0, kv_len - 1)
            for name, rows in new.items():
                cache[name][slots, at] = rows[:, 0].to(cache[name].dtype)

            def read(name):
                return cache[name]
        else:
            page = cache["k"].shape[1]
            kv_len = page_table.shape[1] * page
            pc = cache_offset.long().clamp(0, kv_len - 1)
            pid = page_table.long()[slots, pc // page]
            for name, rows in new.items():
                cache[name][pid, pc % page] = rows[:, 0].to(cache[name].dtype)

            def read(name):
                return paged_logical_view(cache[name], page_table)
        kpos = torch.arange(kv_len, device=x.device)
        mask = (kpos[None, :] <= cache_offset.long()[:, None]
                )[:, None, None, None, :]
    else:
        for name, rows in new.items():
            cache[name][:, cache_offset:cache_offset + s] = rows.to(
                cache[name].dtype)

        def read(name):
            return cache[name]
        mask = "causal" if mask is None else mask[:, None, None]
    if quantized:
        kf = dequant_kv(read("k"), read("k_scale"), x.dtype)
        vf = dequant_kv(read("v"), read("v_scale"), x.dtype)
    else:
        kf, vf = read("k").to(x.dtype), read("v").to(x.dtype)
    if use_flash:
        return _flash(q, kf, vf, cache_offset)
    return _attend(q, kf, vf, mask, q_offset=0 if decode else cache_offset)
