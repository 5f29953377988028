"""W8A8 int8 matmul with the fused per-row / per-column dequant epilogue.

:func:`int8_matmul` launches ``csrc/int8_matmul.cu`` on CUDA tensors (the
port of ``repro/kernels/int8_matmul.py:int8_matmul``) and runs
:func:`int8_matmul_plain` on CPU tensors.  Both compute

    y[m, n] = ((float) sum_k x[m, k] * w[k, n]) * g(rs[m]) * g(cs[n])

with an exact integer sum and ``g`` mapping a 0 scale to 1, then cast to
the carrier -- bit for bit ``repro.kernels.ref.int8_matmul_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def scale_guard(scale: torch.Tensor) -> torch.Tensor:
    """0-scale padding lanes -> 1.0 (their payloads are 0, so products stay
    0); the counterpart of ``repro.kernels.int8_matmul.scale_guard``."""
    scale = scale.to(torch.float32)
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      row_scale: torch.Tensor, col_scale: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version.  The int32 sum is exact on both devices: the
    CPU multiplies int32 tensors; CUDA has no integer matmul, and a float32
    one is not exact at K = 3072 (|sum| <= 127*128*K ~ 5e7 > 2**24), so the
    card sums in float64, exact below 2**53."""
    if x.is_cuda:
        acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    else:
        acc = torch.matmul(x.to(torch.int32), w.to(torch.int32))
    acc = acc.to(torch.float32)
    return ((acc * scale_guard(row_scale).reshape(-1, 1))
            * scale_guard(col_scale).reshape(1, -1)).to(out_dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, row_scale: torch.Tensor,
                col_scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x: int8 (M, K); w: int8 (K, N); row_scale fp32 (M, 1) or (M,);
    col_scale fp32 (1, N) or (N,) -> (M, N) ``out_dtype``.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernel (any M, N, K) or raise."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if row_scale.numel() != m or col_scale.numel() != n:
        raise ValueError(f"int8_matmul: scales {tuple(row_scale.shape)}, "
                         f"{tuple(col_scale.shape)} for ({m}, {n}) output")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, row_scale, col_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    for name, t, dt in (("x", x, torch.int8), ("w", w, torch.int8),
                        ("row_scale", row_scale, torch.float32),
                        ("col_scale", col_scale, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be a contiguous {dt} "
                             f"tensor on {x.device}, got {t.dtype} on "
                             f"{t.device}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul: unsupported out_dtype {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = _build.load("int8_matmul")
    rc = lib.repro_int8_matmul(_build.ptr(x), _build.ptr(w), _build.ptr(row_scale),
            _build.ptr(col_scale), _build.ptr(out), m, n, k,
            _DTYPE_CODES[out_dtype], _build.stream_of(x))
    _build.check(lib, rc, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
