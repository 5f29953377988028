"""Linear quantization primitives (paper Section 3.1, Eq. 1), ported from
``repro.core.quantizer``: the scale formula, the integer-storage codec
(per-tensor / per-channel / per-token and block-wise), the sqrt-domain
codec for Adam's second moment, and fake quantization with the
straight-through estimator.

Scale granularity convention (as in the reference):

  * PER_TENSOR  : scalar scale.
  * PER_CHANNEL : one scale per element of the LAST dim.
  * PER_TOKEN   : one scale per row, i.e. reduced over the LAST dim only.

Payloads and scales match the JAX package bit for bit: the same float32
ops in the same order, and both frameworks round half to even.  Stochastic
rounding is not ported (ROADMAP section 1, item 3): a stochastic spec
raises.
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


def _check_nearest(spec: QuantSpec) -> None:
    if spec.round_mode is not RoundMode.NEAREST:
        raise NotImplementedError(
            f"[{spec.describe()}]: stochastic rounding is not ported yet "
            "(ROADMAP section 1, item 3)")


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


def _blocked_view(x: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, int]:
    """Flatten to (n_blocks, block_size), zero-padding the tail."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block_size), n


def _row_spec(spec: QuantSpec) -> QuantSpec:
    """The block-wise codec is the per-token codec over (n_blocks, bs)."""
    return QuantSpec(bits=spec.bits, granularity=Granularity.PER_TOKEN,
                     symmetric=spec.symmetric, round_mode=spec.round_mode)


def _fake_quant_raw(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """quantize -> dequantize (paper Eq. 1), in the input's dtype; the
    arithmetic of the reference's ``_fake_quant_raw``."""
    xf = x.to(torch.float32)
    scale, zero = compute_scale_zero(xf, spec)
    x_int = torch.clamp(torch.round(xf / scale) - zero, spec.qmin, spec.qmax)
    return (scale * (x_int + zero)).to(x.dtype)


def _fake_quant_blockwise(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Dettmers-style block-wise fake quantization: contiguous blocks of
    ``spec.block_size`` elements, one (scale, zero) each."""
    blocks, n = _blocked_view(x.to(torch.float32), spec.block_size)
    deq = _fake_quant_raw(blocks, _row_spec(spec))
    return deq.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def fake_quant_nograd(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Fake quantization with no gradient rule of its own (values that are
    not differentiated through, e.g. optimizer states).  Sqrt-domain specs
    quantize sqrt(max(x, 0)) and square the result (Adam m2)."""
    _check_nearest(spec)
    if spec.sqrt_domain:
        root = torch.sqrt(torch.clamp_min(x, 0.0))
        q = (_fake_quant_blockwise(root, spec) if spec.block_size
             else _fake_quant_raw(root, spec))
        return torch.square(q).to(x.dtype)
    if spec.block_size:
        return _fake_quant_blockwise(x, spec)
    return _fake_quant_raw(x, spec)


class _FakeQuantSTE(torch.autograd.Function):
    """Forward error injection, identity backward (straight-through
    estimator, Bengio et al. 2013): the reference's ``fake_quant``
    custom VJP."""

    @staticmethod
    def forward(ctx, x, spec):
        return fake_quant_nograd(x, spec)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """STE-wrapped fake quantization: d qdq(x) / dx == 1."""
    return _FakeQuantSTE.apply(x, spec)


def maybe_fake_quant(x: torch.Tensor, spec: Optional[QuantSpec]
                     ) -> torch.Tensor:
    """fp passthrough when the component is not quantized."""
    return x if spec is None else fake_quant(x, spec)


# ---------------------------------------------------------------------------
# Integer-storage codec (optimizer states, kernels, residuals)
# ---------------------------------------------------------------------------

def storage_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def quantize_int(x: torch.Tensor, spec: QuantSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize to real integers.  Returns (q, scale, zero): q holds X_int of
    paper Eq. 1 in int8/int16 storage.  Block-wise specs return the
    (n_blocks, block_size) payload and (n_blocks, 1) sidecars."""
    _check_nearest(spec)
    if spec.block_size:
        blocks, _ = _blocked_view(x.to(torch.float32), spec.block_size)
        scale, zero = compute_scale_zero(blocks, _row_spec(spec))
        q = torch.clamp(torch.round(blocks / scale) - zero, spec.qmin,
                        spec.qmax)
        return q.to(storage_dtype(spec.bits)), scale, zero
    scale, zero = compute_scale_zero(x, spec)
    xf = x.to(torch.float32)
    q = torch.clamp(torch.round(xf / scale) - zero, spec.qmin, spec.qmax)
    return q.to(storage_dtype(spec.bits)), scale, zero


def dequantize_int(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   spec: Optional[QuantSpec] = None, shape=None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int`.  ``shape`` is required for block-wise
    codecs (to strip the tail padding)."""
    deq = scale * (q.to(torch.float32) + zero)
    if spec is not None and spec.block_size:
        if shape is None:
            raise ValueError("blockwise dequantize needs the original shape")
        n = 1
        for d in shape:
            n *= d
        deq = deq.reshape(-1)[:n].reshape(shape)
    return deq.to(dtype)
