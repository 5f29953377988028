"""Fused fake quantization, one pass over the tensor (paper Eq. 1):
quantize to the integer grid and dequantize again, the gradient quantizer
of every ``fake_quant`` recipe with a G spec (ports of
``repro/kernels/qdq.py``, both in ``csrc/qdq.cu``).

* :func:`qdq_row`    -- per-row (per-token) scales, reduced in the kernel;
* :func:`qdq_scaled` -- a streamed (1, F) per-channel or (1, 1) per-tensor
  scale, reduced outside (its reduction spans rows).

Each wrapper launches its kernel on CUDA tensors and runs its plain
version -- a copy of ``repro/kernels/ref.py:qdq_row_ref`` /
``qdq_scaled_ref`` -- on CPU tensors.  Both versions compute in float32
with an IEEE division (a tensor divisor: PyTorch's CUDA division by a
Python scalar is a reciprocal multiply), round half to even, clip and
multiply back, then round once to the input's dtype: bit for bit the same.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import _EPS, _div
from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _qmax(bits: int) -> int:
    if not 2 <= bits <= 16:
        raise ValueError(f"qdq: bits must be in [2, 16], got {bits}")
    return 2 ** (bits - 1) - 1


def qdq_row_plain(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of :func:`qdq_row`."""
    qmax = _qmax(bits)
    xf = x.to(torch.float32)
    absmax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    scale = _div(absmax.clamp_min(_EPS), float(qmax))
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    return (q * scale).to(x.dtype)


def qdq_scaled_plain(x: torch.Tensor, scale: torch.Tensor,
                     bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of :func:`qdq_scaled`."""
    qmax = _qmax(bits)
    xf = x.to(torch.float32)
    sf = scale.to(torch.float32)
    q = torch.clamp(torch.round(xf / sf), -qmax - 1, qmax)
    return (q * sf).to(x.dtype)


def _check_x(what: str, x: torch.Tensor) -> None:
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: x must be a non-empty (rows, F) tensor, "
                         f"got shape {tuple(x.shape)}")
    if x.device.type == "cuda" and (x.dtype not in _DTYPE_CODES
                                    or not x.is_contiguous()):
        raise ValueError(f"{what}: x must be a contiguous float32 or "
                         f"bfloat16 tensor, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def qdq_row(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """x: (rows, F) float32 or bfloat16 -> fake-quantized x, one symmetric
    scale per row: ``s = max(max|x[r]|, 1e-12) / qmax``, ``qmax =
    2**(bits-1) - 1``.

    CPU tensors take :func:`qdq_row_plain`; CUDA tensors launch the kernel
    (any rows, F) or raise."""
    code = _DTYPE_CODES.get(x.dtype)
    # the fake-quant step's call: only what the kernel needs is checked
    if (x.is_cuda and code is not None and x.dim() == 2 and x.numel()
            and x.is_contiguous() and 2 <= bits <= 16):
        out = torch.empty_like(x)
        rows, f = x.shape
        lib = _build.load("qdq")
        rc = lib.repro_qdq_row(x.data_ptr(), out.data_ptr(), rows, f, bits,
                               code, _build.stream_of(x))
        if rc:
            _build.check(lib, rc, "qdq_row")
        qdq_row.launches += 1
        return out
    _check_x("qdq_row", x)
    if x.device.type == "cpu":
        return qdq_row_plain(x, bits)
    raise ValueError(f"qdq: bits must be in [2, 16], got {bits}")


def qdq_scaled(x: torch.Tensor, scale: torch.Tensor,
               bits: int = 8) -> torch.Tensor:
    """x: (rows, F) float32 or bfloat16; scale: float32 (1, F) per channel
    or (1, 1) per tensor -> fake-quantized x with that scale (no guard:
    the caller passes scales > 0, as ``kernels/ops.fused_fake_quant``
    does).

    CPU tensors take :func:`qdq_scaled_plain`; CUDA tensors launch the
    kernel (any rows, F) or raise."""
    _check_x("qdq_scaled", x)
    f = x.shape[1]
    if scale.ndim != 2 or scale.shape[0] != 1 or scale.shape[1] not in (1, f):
        raise ValueError(f"qdq_scaled: scale must be (1, {f}) or (1, 1), got "
                         f"{tuple(scale.shape)}")
    if x.device.type == "cpu":
        return qdq_scaled_plain(x, scale, bits)
    _qmax(bits)
    if (scale.dtype != torch.float32 or scale.device != x.device
            or not scale.is_contiguous()):
        raise ValueError(f"qdq_scaled: scale must be a contiguous float32 "
                         f"tensor on {x.device}, got {scale.dtype} on "
                         f"{scale.device}")
    out = torch.empty_like(x)
    lib = _build.load("qdq")
    rc = lib.repro_qdq_scaled(_build.ptr(x), _build.ptr(scale),
                              _build.ptr(out), x.shape[0], f,
                              int(scale.shape[1] == f and f > 1), bits,
                              _DTYPE_CODES[x.dtype], _build.stream_of(x))
    _build.check(lib, rc, "qdq_scaled")
    qdq_scaled.launches += 1
    return out


qdq_row.launches = 0
qdq_scaled.launches = 0
