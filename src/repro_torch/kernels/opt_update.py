"""Fused 8-bit AdamW update: one pass over a bucket of block-quantized
moments (port of ``repro/kernels/opt_update.py:fused_adamw_blocks``).

The reference loop (``optim/adamw.py``) decodes each int8 moment to fp32,
runs the update as separate elementwise ops and re-encodes: about six
passes over moment-sized buffers.  :func:`fused_adamw_blocks` does the
whole step per row in one pass (``csrc/opt_update.cu``) on CUDA tensors and
runs :func:`fused_adamw_blocks_plain` on CPU tensors.  The row layout is
``core.qadam``'s blockwise codec: each row is one quantization block of
both moments with its own (scale, zero) pair.

Both versions follow the reference kernel op for op: the eight scalars are
float32 values (so ``1 - b1`` is a float32 subtraction, as in the JAX
kernel, and not the Python-float constant of the loop), divisions are IEEE
and nothing is fused into an FMA, so kernel and plain version agree bit
for bit except for the update-norm partial sums, which add in another
order.  Zero-padded rows (0 payloads, 0 scales) decode to 0, update to 0
and keep finite fresh scales through the 1e-12 guards.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.quantizer import _EPS, _div
from repro_torch.kernels import _build

#: scalar vector layout, one fp32 slot each (SMEM on the TPU; a device
#: array here, so the step never syncs to the host for clip or lr)
SCALARS = ("clip", "lr", "b1", "b2", "eps", "wd", "c1", "c2")
#: rows per block of the CUDA kernel: one update-norm partial each
ROWS_PER_BLOCK = 64


class MomentCodec(NamedTuple):
    """Per-moment codec parameters the kernel bakes in (the QuantSpec
    fields of the blockwise int path)."""
    qmin: int
    qmax: int
    symmetric: bool
    sqrt_domain: bool


def codec_of(spec) -> MomentCodec:
    return MomentCodec(qmin=spec.qmin, qmax=spec.qmax,
                       symmetric=spec.symmetric,
                       sqrt_domain=spec.sqrt_domain)


def _dequant(q, s, z, codec: MomentCodec) -> torch.Tensor:
    deq = s * (q.to(torch.float32) + z)
    return torch.square(deq) if codec.sqrt_domain else deq


def _requant(x: torch.Tensor, codec: MomentCodec
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """quantize_int's blockwise row codec: one (scale, zero) per row."""
    if codec.sqrt_domain:
        x = torch.sqrt(torch.clamp_min(x, 0.0))
    if codec.symmetric:
        absmax = torch.amax(x.abs(), dim=-1, keepdim=True)
        scale = _div(absmax.clamp_min(_EPS), codec.qmax)
        zero = torch.zeros_like(scale)
    else:
        xmin = torch.amin(x, dim=-1, keepdim=True)
        xmax = torch.amax(x, dim=-1, keepdim=True)
        scale = _div((xmax - xmin).clamp_min(_EPS), codec.qmax - codec.qmin)
        zero = torch.round(xmin / scale) - codec.qmin
    q = torch.clamp(torch.round(x / scale) - zero, codec.qmin, codec.qmax)
    return q.to(torch.int8), scale, zero


def fused_adamw_blocks_plain(g, p, m1_q, m1_scale, m1_zero, m2_q, m2_scale,
                             m2_zero, scalars, *, m1_codec: MomentCodec,
                             m2_codec: MomentCodec, weight_decay: bool):
    """Plain PyTorch version of :func:`fused_adamw_blocks` (same contract,
    same in-place updates)."""
    clip, lr, b1, b2, eps, wd, c1, c2 = scalars.unbind(0)
    gf = g.to(torch.float32) * clip
    pf = p.to(torch.float32)
    mom1 = b1 * _dequant(m1_q, m1_scale, m1_zero, m1_codec) + (1 - b1) * gf
    mom2 = (b2 * _dequant(m2_q, m2_scale, m2_zero, m2_codec)
            + (1 - b2) * torch.square(gf))
    upd = (mom1 / c1) / (torch.sqrt(mom2 / c2) + eps)
    if weight_decay:
        upd = upd + wd * pf
    delta = lr * upd
    p.copy_(pf - delta)
    for (q, s, z), mom, codec in (((m1_q, m1_scale, m1_zero), mom1, m1_codec),
                                  ((m2_q, m2_scale, m2_zero), mom2, m2_codec)):
        nq, ns, nz = _requant(mom, codec)
        q.copy_(nq)
        s.copy_(ns)
        z.copy_(nz)
    return (p, (m1_q, m1_scale, m1_zero), (m2_q, m2_scale, m2_zero),
            torch.sum(torch.square(delta)))


def fused_adamw_blocks(g, p, m1_q, m1_scale, m1_zero, m2_q, m2_scale,
                       m2_zero, scalars, *, m1_codec: MomentCodec,
                       m2_codec: MomentCodec, weight_decay: bool):
    """One fused AdamW step over a (rows, block_size) bucket, **in place**:
    ``p`` and the six moment tensors are overwritten with their new values
    (the JAX kernel returns fresh arrays; the caller here owns the bucket).

    ``g``, ``p``: fp32 (rows, bs); ``m?_q``: int8 (rows, bs); ``m?_scale``,
    ``m?_zero``: fp32 (rows, 1); ``scalars``: fp32 (8,) in :data:`SCALARS`
    order, on the tensors' device.  Returns (p, (m1_q, m1_scale, m1_zero),
    (m2_q, m2_scale, m2_zero), update_sumsq) with ``update_sumsq`` the sum
    of (lr * update)^2 over the bucket, a 0-d tensor.

    CPU tensors take :func:`fused_adamw_blocks_plain`; CUDA tensors launch
    the kernel (bs a multiple of 32 up to 256, any row count) or raise."""
    rows, bs = g.shape
    args = (g, p, m1_q, m1_scale, m1_zero, m2_q, m2_scale, m2_zero)
    for name, t, dt, shape in (
            ("g", g, torch.float32, (rows, bs)),
            ("p", p, torch.float32, (rows, bs)),
            ("m1_q", m1_q, torch.int8, (rows, bs)),
            ("m1_scale", m1_scale, torch.float32, (rows, 1)),
            ("m1_zero", m1_zero, torch.float32, (rows, 1)),
            ("m2_q", m2_q, torch.int8, (rows, bs)),
            ("m2_scale", m2_scale, torch.float32, (rows, 1)),
            ("m2_zero", m2_zero, torch.float32, (rows, 1)),
            ("scalars", scalars, torch.float32, (len(SCALARS),))):
        if (t.dtype != dt or tuple(t.shape) != shape
                or t.device != g.device or not t.is_contiguous()):
            raise ValueError(f"fused_adamw_blocks: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {g.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if g.device.type == "cpu":
        return fused_adamw_blocks_plain(
            *args, scalars, m1_codec=m1_codec, m2_codec=m2_codec,
            weight_decay=weight_decay)
    if g.device.type != "cuda":
        raise ValueError(f"fused_adamw_blocks: unsupported device {g.device}")
    if bs % 32 or not 32 <= bs <= 256:
        raise ValueError(f"fused_adamw_blocks: block size {bs}; the CUDA "
                         "kernel takes 32, 64, 128 or 256")
    for c in (m1_codec, m2_codec):
        if c.qmin < -128 or c.qmax > 127:
            raise ValueError(f"fused_adamw_blocks: codec {c} exceeds int8")
    partial = torch.empty(-(-rows // ROWS_PER_BLOCK), dtype=torch.float32,
                          device=g.device)
    lib = _build.load("opt_update")
    rc = lib.repro_fused_adamw(
        _build.ptr(scalars), *(_build.ptr(t) for t in args),
        _build.ptr(partial), rows, bs,
        m1_codec.qmin, m1_codec.qmax, int(m1_codec.symmetric),
        int(m1_codec.sqrt_domain), m2_codec.qmin, m2_codec.qmax,
        int(m2_codec.symmetric), int(m2_codec.sqrt_domain),
        int(bool(weight_decay)), _build.stream_of(g))
    _build.check(lib, rc, "fused_adamw_blocks")
    fused_adamw_blocks.launches += 1
    return (p, (m1_q, m1_scale, m1_zero), (m2_q, m2_scale, m2_zero),
            torch.sum(partial))


fused_adamw_blocks.launches = 0
