"""Causal flash-attention forward over the int8 KV cache: the int8-KV
prefill of the serving path.

:func:`flash_attention_fwd_q8` launches ``csrc/flash_attn_q8.cu`` on CUDA
tensors (the port of ``repro/kernels/flash_attn.py:flash_attention_fwd_q8``)
and runs :func:`flash_attention_fwd_q8_plain` on CPU tensors.  Both keep
the dequantized K/V in fp32, as the JAX kernel does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul import scale_guard

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _check_args(q, kq, causal, q_offset):
    b, sq, h, hd = q.shape
    if kq.dim() != 4 or kq.shape[0] != b or kq.shape[3] != hd:
        raise ValueError(f"flash_attention_fwd_q8: q {tuple(q.shape)} vs "
                         f"kq {tuple(kq.shape)}")
    skv, kh = kq.shape[1], kq.shape[2]
    if h % kh:
        raise ValueError(f"flash_attention_fwd_q8: {h} heads over {kh} kv heads")
    if not causal and skv != q_offset + sq:
        # nothing but the causal mask hides never-written cache rows (their
        # guarded scale-0 / payload-0 entries would otherwise enter the
        # softmax with exp(0) weight and dilute every output)
        raise ValueError(
            f"causal=False requires a fully written cache: Skv={skv} vs "
            f"q_offset+Sq={q_offset + sq}")
    return b, sq, h, hd, skv, kh


def flash_attention_fwd_q8_plain(q: torch.Tensor, kq: torch.Tensor,
                                 ks: torch.Tensor, vq: torch.Tensor,
                                 vs: torch.Tensor, *, causal: bool = True,
                                 q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: dequantize-in-fp32 scores over the whole
    buffer, masked softmax in fp32, context cast to q's dtype."""
    b, sq, h, hd, skv, kh = _check_args(q, kq, causal, q_offset)
    g = h // kh
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(hd))).reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kq.to(torch.float32))
    s = s * scale_guard(ks)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    p = p * scale_guard(vs)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    ctx = torch.einsum("bkgqt,btkd->bqkgd", p, vq.to(torch.float32))
    return ctx.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention_fwd_q8(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); kq/vq: (B, Skv, K, hd) int8; ks/vs: (B, Skv, K, 1)
    fp32 -> (B, Sq, H, hd) in q's dtype.  H % K == 0 (GQA/MQA); causal
    masking makes any never-written cache tail (rows >= q_offset + Sq)
    invisible.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    b, sq, h, hd, skv, kh = _check_args(q, kq, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=causal,
                                            q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd_q8: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd_q8: dtype {q.dtype}, head dim "
                         f"{hd} (kernel takes {list(_DTYPE_CODES)} and "
                         f"{_HEAD_DIMS})")
    for name, t, dt, shape in (("q", q, q.dtype, (b, sq, h, hd)),
                               ("kq", kq, torch.int8, (b, skv, kh, hd)),
                               ("vq", vq, torch.int8, (b, skv, kh, hd)),
                               ("ks", ks, torch.float32, (b, skv, kh, 1)),
                               ("vs", vs, torch.float32, (b, skv, kh, 1))):
        if (t.dtype != dt or t.device != q.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"flash_attention_fwd_q8: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {q.device}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attn_q8")
    rc = lib.repro_flash_attn_q8(
        _build.ptr(q), _build.ptr(kq), _build.ptr(ks), _build.ptr(vq),
        _build.ptr(vs), _build.ptr(out), b, sq, skv, h, kh, hd,
        1.0 / math.sqrt(hd), int(causal), int(q_offset),
        _DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_fwd_q8")
    flash_attention_fwd_q8.launches += 1
    return out


flash_attention_fwd_q8.launches = 0
