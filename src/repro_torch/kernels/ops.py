"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``):
the fused fake quantization of the training path (``fused_fake_quant``
over the qdq kernels) and the composite linears around the int8 matmul
kernels -- the quantize -> int8-matmul -> dequant path that realizes the
paper's W8A8 recipe with real integer compute, forward and backward
(``int8_payload_linear``, ``int8_linear``, ``int8_prepared_linear`` and
its expert-batched instance ``int8_prepared_linear_experts``,
``int8_bwd_dx``, ``int8_bwd_dw`` and their expert-batched instances
``int8_bwd_dx_experts``, ``int8_bwd_dw_experts``).  The activation quantization and the
column / tensor / gradient absmax reduces stay plain torch, as they stay
in XLA in the JAX package, except at the decode step: there a prepared
linear is one kernel that quantizes its activations per token itself
(``int8_quant_matmul``).  The kernels take any shape, so nothing is padded
to the TPU's (8, 128) tiles."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qconfig import Granularity, QuantSpec, RoundMode
from repro_torch.core.quantizer import _EPS, _div, quantize_int
from repro_torch.kernels.int8_matmul import (int8_matmul,
                                             int8_matmul_experts,
                                             int8_matmul_nt,
                                             int8_matmul_nt_experts,
                                             int8_matmul_tn,
                                             int8_matmul_tn_experts,
                                             int8_quant_matmul,
                                             int8_quant_matmul_experts,
                                             takes_quant_fwd)
from repro_torch.kernels.qdq import qdq_row, qdq_scaled


def fused_fake_quant_eligible(spec: Optional[QuantSpec],
                              x: torch.Tensor) -> bool:
    """Can :func:`fused_fake_quant` stand in for
    ``core.quantizer.fake_quant_nograd`` on this call?  The kernels cover
    the hot training shapes: 2-D+ inputs, symmetric nearest-rounded specs
    with no block-wise or sqrt-domain codec."""
    return (spec is not None and x.ndim >= 2 and spec.symmetric
            and spec.block_size == 0 and not spec.sqrt_domain
            and spec.round_mode is RoundMode.NEAREST)


def fused_fake_quant(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Fused equivalent of ``core.quantizer.fake_quant_nograd`` for 2-D+
    inputs with symmetric specs (the hot training path): x reshaped to
    (rows, F); per-token specs run :func:`qdq_row`, per-channel and
    per-tensor specs reduce their absmax here and stream it into
    :func:`qdq_scaled` as a (1, F) or (1, 1) scale."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    if spec.granularity is Granularity.PER_TOKEN:
        out = qdq_row(x2, spec.bits)
    else:
        xf = x2.to(torch.float32)
        if spec.granularity is Granularity.PER_CHANNEL:
            absmax = torch.amax(xf.abs(), dim=0, keepdim=True)
            scale = _div(absmax.clamp_min(_EPS), float(spec.qmax))
            # the reference pads columns to 128 and guards their 0 scales;
            # nothing is padded here, so this never fires -- kept so the
            # two stay line for line comparable
            scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        else:
            absmax = torch.amax(xf.abs())
            scale = _div(absmax.clamp_min(_EPS),
                         float(spec.qmax)).reshape(1, 1)
        out = qdq_scaled(x2, scale, spec.bits)
    return out.reshape(shape)


def int8_payload_linear(xq: torch.Tensor, x_scale: torch.Tensor,
                        wq: torch.Tensor, w_scale: torch.Tensor,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Rank-1-dequant int8 matmul on pre-quantized operands: ``xq`` (M, K)
    int8 with a per-token (M, 1) or per-tensor (1, 1) scale, ``wq`` (K, N)
    int8 with a per-channel (1, N) or per-tensor (1, 1) scale."""
    m, n = xq.shape[0], wq.shape[1]
    row = x_scale.to(torch.float32).reshape(-1, 1).expand(m, 1).contiguous()
    col = w_scale.to(torch.float32).reshape(1, -1).expand(1, n).contiguous()
    return int8_matmul(xq.contiguous(), wq.contiguous(), row, col,
                       out_dtype=out_dtype)


def int8_payload_linear_experts(xq: torch.Tensor, x_scale: torch.Tensor,
                                wq: torch.Tensor, w_scale: torch.Tensor,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`int8_payload_linear` for every expert in one launch of
    ``int8_matmul_experts``: ``xq`` (E, C, K) int8 with per-token (E, C, 1)
    or per-expert (E, 1, 1) scales, ``wq`` (E, K, N) int8 with per-channel
    (E, 1, N) or per-expert (E, 1, 1) scales -> (E, C, N)."""
    e, c, _ = xq.shape
    row = x_scale.to(torch.float32).reshape(e, -1, 1).expand(e, c, 1)
    return int8_matmul_experts(xq.contiguous(), wq.contiguous(), row,
                               w_scale, out_dtype=out_dtype)


def int8_linear(x: torch.Tensor, w: torch.Tensor, a_spec: QuantSpec,
                w_spec: QuantSpec,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Spec-driven real-int8 linear: quantize x per ``a_spec`` (per-token or
    per-tensor) and w per ``w_spec`` (per-channel or per-tensor), run the
    int8 matmul with the rank-1 dequant epilogue.  x: (..., K); w: (K, N).
    The caller gates eligibility (``core.qpolicy.int8_backend_supported``)."""
    out_dtype = out_dtype or x.dtype
    shape = x.shape
    xq, row_scale, _ = quantize_int(x.reshape(-1, shape[-1]), a_spec)
    wq, col_scale, _ = quantize_int(w, w_spec)
    out = int8_payload_linear(xq, row_scale, wq, col_scale,
                              out_dtype=out_dtype)
    return out.reshape(*shape[:-1], w.shape[1])


def int8_prepared_linear(x: torch.Tensor, wq: torch.Tensor,
                         w_scale: torch.Tensor, a_spec: QuantSpec,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Real-int8 linear on a prepared weight: ``wq`` (K, N) int8 payload and
    ``w_scale`` (1, N) fp32, quantized once (``repro_torch.infer.prepare``).
    Only the activations are quantized, per ``a_spec``: on the card at the
    decode step's few rows by ``int8_quant_matmul``, one launch with the
    quantization in its prologue (``takes_quant_fwd``), else here, then
    ``int8_matmul``; both give the same bits."""
    out_dtype = out_dtype or x.dtype
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if takes_quant_fwd(x2, a_spec, out_dtype):
        out = int8_quant_matmul(x2.contiguous(), wq.contiguous(), w_scale,
                                a_spec, out_dtype=out_dtype)
    else:
        xq, row_scale, _ = quantize_int(x2, a_spec)  # zero == 0 (symmetric)
        out = int8_payload_linear(xq, row_scale, wq, w_scale,
                                  out_dtype=out_dtype)
    return out.reshape(*shape[:-1], wq.shape[1])


def int8_prepared_linear_experts(x: torch.Tensor, wq: torch.Tensor,
                                 w_scale: torch.Tensor, a_spec: QuantSpec,
                                 out_dtype: Optional[torch.dtype] = None
                                 ) -> torch.Tensor:
    """:func:`int8_prepared_linear` for every expert in one call (the
    reference's ``vmap`` of it): x (E, C, K), wq (E, K, N) int8 payloads,
    w_scale (E, 1, N) or (E, 1, 1) fp32 -> (E, C, N), expert e's slice that
    of ``int8_prepared_linear(x[e], wq[e], w_scale[e], a_spec)``.  On the
    card at the decode step's few rows an expert, one launch of the fused
    entry's expert-batched instance; else the activations quantized here
    -- per token over all the experts' rows at once (a token's scale is its
    row's, whichever expert holds it), any other spec expert by expert --
    then one launch of ``int8_matmul_experts``."""
    out_dtype = out_dtype or x.dtype
    e, c, _ = x.shape
    if takes_quant_fwd(x[0], a_spec, out_dtype):
        return int8_quant_matmul_experts(x.contiguous(), wq.contiguous(),
                                         w_scale, a_spec, out_dtype=out_dtype)
    if a_spec.granularity is Granularity.PER_TOKEN:
        xq, row_scale, _ = quantize_int(x.reshape(e * c, -1), a_spec)
        xq = xq.reshape(x.shape)
    else:
        parts = [quantize_int(x[i], a_spec)[:2] for i in range(e)]
        xq = torch.stack([q for q, _ in parts])
        row_scale = torch.stack([s.reshape(1, 1).expand(c, 1)
                                 for _, s in parts])
    return int8_matmul_experts(xq.contiguous(), wq.contiguous(),
                               row_scale, w_scale, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Training backward: both matmuls on int8 kernels against the stored forward
# payloads.  Folding the other operand's dequant scale into the fp gradient
# moves every scale off the contracted axis, so each int32 sum dequantizes
# with one multiply:
#
#   dx[m,k] = sum_n g[m,n] * (w_int[k,n]*sw[n])  ~ sh[m] * sum_n hq[m,n]*w_int[k,n]
#   dW[k,n] = sum_m (x_int[m,k]*sx[m]) * g[m,n]  ~ sh[n] * sum_m x_int[m,k]*hq[m,n]
#
# with h = g*sw quantized per token (sh) for dx and h = g*sx per channel
# for dW.  The absmax reduce runs here, in plain torch (XLA ops in the
# reference).  On the card each kernel call then quantizes h once into
# K-major int8 payloads (round, clip) and multiplies them on the int8 tensor
# cores with the rank-1 epilogue (kernels/int8_matmul.py, its stages).
# ---------------------------------------------------------------------------

def int8_bwd_dx(g: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dx = qdq_token(g * w_scale) @ wq^T.  g: fp (M, N); wq: int8 (K, N)
    stored forward payload; w_scale: fp32 per-channel (1, N) or per-tensor
    (1, 1) -> (M, K) ``out_dtype`` (default g's)."""
    out_dtype = out_dtype or g.dtype
    n = g.shape[1]
    fold = w_scale.to(torch.float32).reshape(1, -1).expand(1, n).contiguous()
    absmax = torch.amax(g.to(torch.float32).abs() * fold, dim=1, keepdim=True)
    q_scale = _div(absmax.clamp_min(_EPS), 127.0)
    return int8_matmul_nt(g.contiguous(), wq.contiguous(), fold, q_scale,
                          out_dtype=out_dtype)


def int8_bwd_dw(xq: torch.Tensor, x_scale: torch.Tensor, g: torch.Tensor,
                out_dtype=torch.float32) -> torch.Tensor:
    """dW = xq^T @ qdq_channel(g * x_scale).  xq: int8 (M, K) stored forward
    payload; x_scale: fp32 per-token (M, 1) or per-tensor (1, 1); g: fp
    (M, N) -> (K, N) ``out_dtype``."""
    m = g.shape[0]
    fold = x_scale.to(torch.float32).reshape(-1, 1).expand(m, 1).contiguous()
    absmax = torch.amax(g.to(torch.float32).abs() * fold, dim=0, keepdim=True)
    q_scale = _div(absmax.clamp_min(_EPS), 127.0)
    return int8_matmul_tn(xq.contiguous(), g.contiguous(), fold, q_scale,
                          out_dtype=out_dtype)


def int8_bwd_dx_experts(g: torch.Tensor, wq: torch.Tensor,
                        w_scale: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """:func:`int8_bwd_dx` for every expert in one call (the reference's
    ``vmap`` of it): g fp (E, C, N); wq int8 (E, K, N); w_scale fp32 (E, 1,
    N) or one an expert (E, 1, 1) -> (E, C, K), expert e's slice that of
    ``int8_bwd_dx(g[e], wq[e], w_scale[e])``: each row's absmax over N
    with its expert's fold, then one ``int8_matmul_nt_experts``."""
    out_dtype = out_dtype or g.dtype
    e, _, n = g.shape
    fold = w_scale.to(torch.float32).reshape(e, 1, -1).expand(
        e, 1, n).contiguous()
    absmax = torch.amax(g.to(torch.float32).abs() * fold, dim=2,
                        keepdim=True)
    q_scale = _div(absmax.clamp_min(_EPS), 127.0)
    return int8_matmul_nt_experts(g.contiguous(), wq.contiguous(), fold,
                                  q_scale, out_dtype=out_dtype)


def int8_bwd_dw_experts(xq: torch.Tensor, x_scale: torch.Tensor,
                        g: torch.Tensor,
                        out_dtype=torch.float32) -> torch.Tensor:
    """:func:`int8_bwd_dw` for every expert in one call: xq int8 (E, C, K);
    x_scale fp32 per token (E, C, 1) or one an expert (E, 1, 1); g fp (E,
    C, N) -> (E, K, N), expert e's slice that of ``int8_bwd_dw(xq[e],
    x_scale[e], g[e])``: each column's absmax over its expert's C rows,
    then one ``int8_matmul_tn_experts``."""
    e, c, _ = g.shape
    fold = x_scale.to(torch.float32).reshape(e, -1, 1).expand(
        e, c, 1).contiguous()
    absmax = torch.amax(g.to(torch.float32).abs() * fold, dim=1,
                        keepdim=True)
    q_scale = _div(absmax.clamp_min(_EPS), 127.0)
    return int8_matmul_tn_experts(xq.contiguous(), g.contiguous(), fold,
                                  q_scale, out_dtype=out_dtype)
