"""Fused int8-KV decode attention: attend directly on the quantized cache,
quantize the step's new K/V row and write it into the cache in place.

:func:`decode_attention` launches ``csrc/decode_attn.cu`` on CUDA tensors
(the port of ``repro/kernels/decode_attn.py:decode_attention``) and runs
:func:`decode_attention_plain` on CPU tensors.  Per slot, ``pos[b]`` is
both the number of valid cache rows and the write row; a freed slot riding
the batched step with ``pos[b] == S`` writes into row ``S - 1``.

Unlike the JAX kernel, which aliases its outputs onto the donated cache
buffers and returns them, both versions here MUTATE ``kq``, ``ks``, ``vq``
and ``vs`` and return only the context.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul import scale_guard

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16


def _quantize_rows(x: torch.Tensor, qmin: int, qmax: int):
    """The cache codec on the step's rows (B, K, hd): symmetric, nearest,
    one scale per (slot, head) -> (payload as float, scale (B, K, 1)).  The
    scale divides by a tensor: on CUDA PyTorch multiplies by the reciprocal
    of a Python-scalar divisor, which is not the kernel's IEEE division."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = absmax / torch.full_like(absmax, qmax)
    return torch.clamp(torch.round(xf / scale), qmin, qmax), scale


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
    if q.dtype not in _DTYPE_CODES or hd not in _HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"decode_attention: dtype {q.dtype}, head dim {hd}, "
                         f"group {g} (kernel takes {list(_DTYPE_CODES)}, "
                         f"{_HEAD_DIMS}, group <= {MAX_GROUP})")
    for name, t, dt, shape in (("q", q, q.dtype, (b, kh, g, hd)),
                               ("kq", kq, torch.int8, (b, s, kh, hd)),
                               ("vq", vq, torch.int8, (b, s, kh, hd)),
                               ("ks", ks, torch.float32, (b, s, kh, 1)),
                               ("vs", vs, torch.float32, (b, s, kh, 1)),
                               ("new_k", new_k, q.dtype, (b, kh, hd)),
                               ("new_v", new_v, q.dtype, (b, kh, hd)),
                               ("pos", pos, torch.int32, (b,))):
        if (t.dtype != dt or t.device != q.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"{dt} {shape} tensor on {q.device}")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("decode_attention: int8 caches must be 16-byte "
                         "aligned (the kernel reads rows with 16-byte loads)")
    out = torch.empty_like(q)
    lib = _build.load("decode_attn")
    rc = lib.repro_decode_attn(
        _build.ptr(q), _build.ptr(kq), _build.ptr(ks), _build.ptr(vq),
        _build.ptr(vs), _build.ptr(new_k), _build.ptr(new_v), _build.ptr(pos),
        _build.ptr(out), b, s, kh, g, hd, 1.0 / math.sqrt(hd), qmin, qmax,
        _DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
