"""Composite linears around the int8 matmul kernels: the quantize ->
int8-matmul -> dequant path that realizes the paper's W8A8 recipe with real
integer compute, forward and backward (port of ``repro/kernels/ops.py``:
``int8_payload_linear``, ``int8_linear``, ``int8_prepared_linear``,
``int8_bwd_dx``, ``int8_bwd_dw``).  The activation quantization and the
gradient's absmax reduce stay plain torch, as they stay in XLA in the JAX
package; the kernels take any M, N, K, so nothing is padded to 128."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qconfig import QuantSpec
from repro_torch.core.quantizer import _EPS, _div, quantize_int
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_nt,
                                             int8_matmul_tn)


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
