"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``):
the fused fake quantization of the training path (``fused_fake_quant``
over the qdq kernels) and the composite linears around the int8 matmul
kernels -- the quantize -> int8-matmul -> dequant path that realizes the
paper's W8A8 recipe with real integer compute, forward and backward
(``int8_payload_linear``, ``int8_linear``, ``int8_prepared_linear``,
``int8_bwd_dx``, ``int8_bwd_dw``).  The activation quantization and the
column / tensor / gradient absmax reduces stay plain torch, as they stay
in XLA in the JAX package; the kernels take any shape, so nothing is
padded to the TPU's (8, 128) tiles."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qconfig import Granularity, QuantSpec, RoundMode
from repro_torch.core.quantizer import _EPS, _div, quantize_int
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_nt,
                                             int8_matmul_tn)
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
    Only the activations are quantized here, per ``a_spec``."""
    out_dtype = out_dtype or x.dtype
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    xq, row_scale, _ = quantize_int(x2, a_spec)     # zero == 0 (symmetric)
    out = int8_payload_linear(xq, row_scale, wq, w_scale, out_dtype=out_dtype)
    return out.reshape(*shape[:-1], wq.shape[1])


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
# for dW.  The absmax reduce runs here; round, clip and cast in the kernel.
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
