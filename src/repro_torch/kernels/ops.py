"""Composite linears around the int8 matmul kernel: the quantize ->
int8-matmul -> dequant path that realizes the paper's W8A8 recipe with real
integer compute (port of ``repro/kernels/ops.py:int8_payload_linear`` and
``int8_prepared_linear``).  The activation quantization stays plain torch,
as it stays in XLA in the JAX package; the kernel takes any M, N, K, so no
padding to 128."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qconfig import QuantSpec
from repro_torch.core.quantizer import quantize_int
from repro_torch.kernels.int8_matmul import int8_matmul


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
