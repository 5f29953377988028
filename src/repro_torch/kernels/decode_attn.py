"""Fused int8-KV decode attention: attend directly on the quantized cache,
quantize the step's new K/V row and write it into the cache in place.

:func:`decode_attention` (dense ``(B, S, K, hd)`` strips, the port of
``repro/kernels/decode_attn.py:decode_attention``) and
:func:`decode_attention_paged` (``(P, page, K, hd)`` page pools addressed
through a ``(B, maxp)`` page table, the port of ``decode_attention_paged``)
launch the two entry points of ``csrc/decode_attn.cu`` on CUDA tensors and
run their plain versions on CPU tensors.  Per slot, ``pos[b]`` is both the
number of valid cache rows and the write row; a freed slot riding the
batched step with ``pos[b] == S`` (paged: ``maxp * page``) writes into the
last row.  Both kernels split each slot's logical rows into chunks of
:data:`DECODE_CHUNK` rows, one block each, and combine the chunks in chunk
order in a second launch, so the paged step equals the dense one bit for
bit on the same logical cache, whatever the page size, and a launch
repeats its bits.

Unlike the JAX kernels, which alias their outputs onto the donated cache
buffers and return them, every version here MUTATES ``kq``, ``ks``, ``vq``
and ``vs`` and returns only the context.

Page 0 of a pool is the trash page: freed slots (table rows of zeros) all
write their discarded rows to its row 0 in the same launch, in an order
the card leaves undefined, and no live slot reads it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul import scale_guard

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the kernels (160: Zamba2's shared block, whose rows take
#: aligned groups of 16 lanes for their 10 segments)
_HEAD_DIMS = (32, 64, 128, 160, 256)
MAX_GROUP = 16
#: logical cache rows per chunk block of the kernel (``csrc/decode_attn.cu``
#: CHUNK, which the library reports as ``repro_decode_chunk``)
DECODE_CHUNK = 128


def _workspace(q: torch.Tensor, rows: int):
    """The kernels' float32 workspace, (m, l, acc) of every (slot, kv head,
    chunk), and the chunk count of a ``rows``-row logical cache."""
    b, kh, g, hd = q.shape
    nc = -(-rows // DECODE_CHUNK)
    return torch.empty(b * kh * nc * g * (hd + 2), dtype=torch.float32,
                       device=q.device), nc


def _quantize_rows(x: torch.Tensor, qmin: int, qmax: int):
    """The cache codec on the step's rows (B, K, hd): symmetric, nearest,
    one scale per (slot, head) -> (payload as float, scale (B, K, 1)).  The
    scale divides by a tensor: on CUDA PyTorch multiplies by the reciprocal
    of a Python-scalar divisor, which is not the kernel's IEEE division."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = absmax / torch.full_like(absmax, qmax)
    return torch.clamp(torch.round(xf / scale), qmin, qmax), scale


def _check_cuda_args(what: str, q: torch.Tensor, tensors) -> None:
    """What the kernels take, checked before a launch: carrier, head dim,
    group size, and every tensor of ``tensors`` ((name, tensor, dtype,
    shape) rows) contiguous on q's device with its dtype and shape; the
    int8 buffers 16-byte aligned (rows are read with 16-byte loads)."""
    b, kh, g, hd = q.shape
    if q.dtype not in _DTYPE_CODES or hd not in _HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"{what}: dtype {q.dtype}, head dim {hd}, group {g} "
                         f"(kernel takes {list(_DTYPE_CODES)}, {_HEAD_DIMS}, "
                         f"group <= {MAX_GROUP})")
    for name, t, dt, shape in (("q", q, q.dtype, (b, kh, g, hd)),) + tuple(
            tensors):
        if (t.dtype != dt or t.device != q.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {q.device}")
        if dt == torch.int8 and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned (the "
                             "kernel reads rows with 16-byte loads)")


def decode_attention_plain(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, pos: torch.Tensor, *,
                           qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """Plain PyTorch version: scores over every cache row in fp32, rows
    ``t >= pos[b]`` masked to -1e30, the quantized new row appended, one
    softmax, then the in-place write of the new row."""
    b, kh, g, hd = q.shape
    s = kq.shape[1]
    qf = q.to(torch.float32) * (1.0 / math.sqrt(hd))
    nkq, nks = _quantize_rows(new_k, qmin, qmax)
    nvq, nvs = _quantize_rows(new_v, qmin, qmax)
    ksg = scale_guard(ks)[..., 0].permute(0, 2, 1)[:, :, None, :]   # (B,K,1,S)
    vsg = scale_guard(vs)[..., 0].permute(0, 2, 1)[:, :, None, :]
    sc = torch.einsum("bkgd,btkd->bkgt", qf, kq.to(torch.float32)) * ksg
    valid = torch.arange(s, device=q.device)[None, :] < pos.to(q.device)[:, None]
    sc = sc.masked_fill(~valid[:, None, None, :], -1e30)
    s_new = torch.einsum("bkgd,bkd->bkg", qf, nkq * nks)[..., None]
    p = torch.softmax(torch.cat([sc, s_new], dim=-1), dim=-1)
    ctx = (torch.einsum("bkgt,btkd->bkgd", p[..., :s] * vsg, vq.to(torch.float32))
           + p[..., s:] * (nvq * nvs)[:, :, None, :])
    rows = torch.arange(b, device=q.device)
    at = pos.to(q.device).long().clamp(0, s - 1)
    kq[rows, at] = nkq.to(kq.dtype)
    ks[rows, at] = nks
    vq[rows, at] = nvq.to(vq.dtype)
    vs[rows, at] = nvs
    return ctx.to(q.dtype)


def decode_attention(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                     vq: torch.Tensor, vs: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, pos: torch.Tensor, *,
                     qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """One fused decode-attention step on the int8 KV cache.

    q: (B, K, G, hd) grouped queries; kq/vq: (B, S, K, hd) int8 payloads;
    ks/vs: (B, S, K, 1) fp32 scales; new_k/new_v: (B, K, hd) this step's
    rows; pos: (B,) int32 per-slot valid lengths == write rows.  Returns the
    context (B, K, G, hd) in q's dtype and writes the quantized new rows
    into kq/ks/vq/vs in place.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    b, kh, g, hd = q.shape
    if kq.dim() != 4 or kq.shape[0] != b or kq.shape[2] != kh or kq.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs kq "
                         f"{tuple(kq.shape)}")
    s = kq.shape[1]
    if q.device.type == "cpu":
        return decode_attention_plain(q, kq, ks, vq, vs, new_k, new_v, pos,
                                      qmin=qmin, qmax=qmax)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_cuda_args("decode_attention", q, (
        ("kq", kq, torch.int8, (b, s, kh, hd)),
        ("vq", vq, torch.int8, (b, s, kh, hd)),
        ("ks", ks, torch.float32, (b, s, kh, 1)),
        ("vs", vs, torch.float32, (b, s, kh, 1)),
        ("new_k", new_k, q.dtype, (b, kh, hd)),
        ("new_v", new_v, q.dtype, (b, kh, hd)),
        ("pos", pos, torch.int32, (b,))))
    out = torch.empty_like(q)
    ws, nc = _workspace(q, s)
    lib = _build.load("decode_attn")
    rc = lib.repro_decode_attn(
        _build.ptr(q), _build.ptr(kq), _build.ptr(ks), _build.ptr(vq),
        _build.ptr(vs), _build.ptr(new_k), _build.ptr(new_v), _build.ptr(pos),
        _build.ptr(out), _build.ptr(ws), b, s, kh, g, hd, nc,
        1.0 / math.sqrt(hd), qmin, qmax, _DTYPE_CODES[q.dtype],
        _build.stream_of(q))
    _build.check(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_logical_view(pool: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """(P, page, K, x) pool -> each slot's logical (B, maxp * page, K, x)
    rows, gathered through the (B, maxp) table (a copy)."""
    b, maxp = page_table.shape
    return pool[page_table.long()].reshape(b, maxp * pool.shape[1],
                                           *pool.shape[2:])


def decode_attention_paged_plain(q: torch.Tensor, kq: torch.Tensor,
                                 ks: torch.Tensor, vq: torch.Tensor,
                                 vs: torch.Tensor, new_k: torch.Tensor,
                                 new_v: torch.Tensor, pos: torch.Tensor,
                                 page_table: torch.Tensor, *,
                                 qmin: int = -128,
                                 qmax: int = 127) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's logical cache through the
    table, run :func:`decode_attention_plain` on it, and write the row it
    wrote at logical row ``pc = min(pos, maxp * page - 1)`` into the pools
    at ``(page_table[b, pc // page], pc % page)``."""
    b, maxp = page_table.shape
    page = kq.shape[1]
    views = [paged_logical_view(t, page_table) for t in (kq, ks, vq, vs)]
    ctx = decode_attention_plain(q, *views, new_k, new_v, pos, qmin=qmin,
                                 qmax=qmax)
    rows = torch.arange(b, device=q.device)
    pc = pos.to(q.device).long().clamp(0, maxp * page - 1)
    pid = page_table.to(q.device).long()[rows, pc // page]
    for pool, view in zip((kq, ks, vq, vs), views):
        pool[pid, pc % page] = view[rows, pc]
    return ctx


def decode_attention_paged(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, pos: torch.Tensor,
                           page_table: torch.Tensor, *, qmin: int = -128,
                           qmax: int = 127) -> torch.Tensor:
    """One fused decode-attention step on the paged int8 KV pools.

    q: (B, K, G, hd) grouped queries; kq/vq: (P, page, K, hd) int8 page
    pools shared by every slot; ks/vs: (P, page, K, 1) fp32 scales;
    new_k/new_v: (B, K, hd) this step's rows; pos: (B,) int32 per-slot
    valid lengths == write rows; page_table: (B, maxp) int32 physical page
    of each slot's logical page (unmapped entries: the trash page 0; every
    entry < P, which the kernel does not check).  Returns the context (B,
    K, G, hd) in q's dtype and writes the quantized new rows into the pools
    in place.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    b, kh, g, hd = q.shape
    if (kq.dim() != 4 or kq.shape[2:] != (kh, hd) or page_table.dim() != 2
            or page_table.shape[0] != b):
        raise ValueError(f"decode_attention_paged: q {tuple(q.shape)}, pool "
                         f"{tuple(kq.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    npg, page = kq.shape[:2]
    maxp = page_table.shape[1]
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, kq, ks, vq, vs, new_k, new_v,
                                            pos, page_table, qmin=qmin,
                                            qmax=qmax)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged: unsupported device "
                         f"{q.device}")
    _check_cuda_args("decode_attention_paged", q, (
        ("kq", kq, torch.int8, (npg, page, kh, hd)),
        ("vq", vq, torch.int8, (npg, page, kh, hd)),
        ("ks", ks, torch.float32, (npg, page, kh, 1)),
        ("vs", vs, torch.float32, (npg, page, kh, 1)),
        ("new_k", new_k, q.dtype, (b, kh, hd)),
        ("new_v", new_v, q.dtype, (b, kh, hd)),
        ("pos", pos, torch.int32, (b,)),
        ("page_table", page_table, torch.int32, (b, maxp))))
    out = torch.empty_like(q)
    ws, nc = _workspace(q, maxp * page)
    lib = _build.load("decode_attn")
    rc = lib.repro_decode_attn_paged(
        _build.ptr(q), _build.ptr(kq), _build.ptr(ks), _build.ptr(vq),
        _build.ptr(vs), _build.ptr(new_k), _build.ptr(new_v), _build.ptr(pos),
        _build.ptr(page_table), _build.ptr(out), _build.ptr(ws), b, maxp,
        page, kh, g, hd, nc, 1.0 / math.sqrt(hd), qmin, qmax,
        _DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0

#: the reference's default kv tile, which sizes the paged engine's page
DEFAULT_BLOCK_K = 256


def effective_block_k(s: int, block_k: Optional[int] = None) -> int:
    """The reference's tile rule (``repro/kernels/decode_attn.py:70``
    without its environment override): the requested length, default
    :data:`DEFAULT_BLOCK_K`, clamped to ``s`` and halved until it divides
    ``s``.  The paged engine's default page size."""
    bk = min(block_k or DEFAULT_BLOCK_K, s)
    while s % bk:
        bk //= 2
    return bk


def decode_kv_read_bytes(mode: str, batch: int, max_seq: int,
                         n_kv_heads: int, head_dim: int, *,
                         n_layers: int = 1, fp_bytes: int = 2) -> int:
    """Bytes of KV read per decode step (a copy of the reference's
    accounting): ``fp`` reads the fp K and V once; ``dequant`` reads the
    int8 payloads and fp32 scales, writes fp copies and reads them back;
    ``fused`` reads the payloads and scales once.  The one-row write and
    the q/ctx tiles are left out of all three."""
    elems = batch * max_seq * n_kv_heads * head_dim      # per buffer (K or V)
    scales = batch * max_seq * n_kv_heads                # fp32 scale elements
    if mode == "fp":
        per_layer = 2 * elems * fp_bytes
    elif mode == "dequant":
        per_layer = 2 * (elems * (1 + 2 * fp_bytes) + 4 * scales)
    elif mode == "fused":
        per_layer = 2 * (elems + 4 * scales)
    else:
        raise ValueError(f"unknown mode {mode!r} (fp | dequant | fused)")
    return per_layer * n_layers
