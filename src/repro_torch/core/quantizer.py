"""Linear quantization primitives (paper Section 3.1, Eq. 1), ported from
``repro.core.quantizer`` for the serving path: the scale formula, the
integer-storage codec and nearest-rounding fake quantization.

Scale granularity convention (as in the reference):

  * PER_TENSOR  : scalar scale.
  * PER_CHANNEL : one scale per element of the LAST dim.
  * PER_TOKEN   : one scale per row, i.e. reduced over the LAST dim only.

Payloads and scales match the JAX package bit for bit: the same float32
ops in the same order, and both frameworks round half to even.  Stochastic
rounding, the block-wise / sqrt-domain codecs and the straight-through
estimator belong to training and are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.qconfig import Granularity, QuantSpec, RoundMode

_EPS = 1e-12


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device.  PyTorch's CUDA kernel
    turns a Python-scalar divisor into a multiply by its reciprocal, which
    can differ by an ulp; a tensor divisor keeps the true division the JAX
    package (and the CUDA kernels here) compute."""
    return x / torch.full_like(x, c)


def _reduce_axes(ndim: int, granularity: Granularity) -> Tuple[int, ...]:
    """Axes over which the scale statistic is computed (keepdim=True)."""
    if granularity is Granularity.PER_TENSOR:
        return tuple(range(ndim))
    if granularity is Granularity.PER_CHANNEL:
        return tuple(range(ndim - 1))
    if granularity is Granularity.PER_TOKEN:
        return (ndim - 1,)
    raise ValueError(granularity)


def _check_nearest_flat(spec: QuantSpec) -> None:
    if (spec.round_mode is not RoundMode.NEAREST or spec.block_size
            or spec.sqrt_domain):
        raise NotImplementedError(
            f"[{spec.describe()}]: stochastic, block-wise and sqrt-domain "
            "codecs are training codecs, not ported yet")


def compute_scale_zero(x: torch.Tensor, spec: QuantSpec,
                       axes: Optional[Tuple[int, ...]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (scale, zero_point), keepdim-shaped over the reduced axes.

    Symmetric: s = max(absmax, 1e-12) / P, z = 0.  Asymmetric: full-range
    affine, s = max(max - min, 1e-12) / (P - N), z = round(min / s) - N.
    ``axes`` overrides the granularity-derived reduction axes."""
    if axes is None:
        axes = _reduce_axes(x.ndim, spec.granularity)
    xf = x.to(torch.float32)
    if spec.symmetric:
        absmax = torch.amax(xf.abs(), dim=axes, keepdim=True)
        scale = _div(absmax.clamp_min(_EPS), spec.qmax)
        zero = torch.zeros_like(scale)
    else:
        xmin = torch.amin(xf, dim=axes, keepdim=True)
        xmax = torch.amax(xf, dim=axes, keepdim=True)
        scale = _div((xmax - xmin).clamp_min(_EPS), spec.qmax - spec.qmin)
        zero = torch.round(xmin / scale) - spec.qmin
    return scale, zero


def storage_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def quantize_int(x: torch.Tensor, spec: QuantSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize to real integers (nearest rounding).  Returns (q, scale,
    zero): q holds X_int of paper Eq. 1 in int8/int16 storage."""
    _check_nearest_flat(spec)
    scale, zero = compute_scale_zero(x, spec)
    xf = x.to(torch.float32)
    q = torch.clamp(torch.round(xf / scale) - zero, spec.qmin, spec.qmax)
    return q.to(storage_dtype(spec.bits)), scale, zero


def dequantize_int(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int`."""
    return (scale * (q.to(torch.float32) + zero)).to(dtype)


def fake_quant_nograd(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """quantize -> dequantize (paper Eq. 1) with nearest rounding, in the
    input's dtype; the arithmetic of the reference's ``_fake_quant_raw``."""
    _check_nearest_flat(spec)
    xf = x.to(torch.float32)
    scale, zero = compute_scale_zero(xf, spec)
    x_int = torch.clamp(torch.round(xf / scale) - zero, spec.qmin, spec.qmax)
    return (scale * (x_int + zero)).to(x.dtype)
