"""Quantized linear layer with the paper's Fig-1 forward/backward semantics
(port of ``repro.core.qlinear``):

Forward  : y  = qdq_A(x) @ qdq_W(w)
Backward : dx = g @ qdq_W(w)^T            (real-valued g, paper Fig. 10)
           dW = qdq_A(x)^T @ qdq_G(g)     (g quantized on the weight path)

with the straight-through estimator for the x / w cotangents.  Two
``torch.autograd.Function`` implementations share these semantics:

* the fake-quant reference (fp matmuls over qdq'd tensors -- the paper's
  simulation); symmetric nearest codecs keep their residuals as int8
  ``QState`` payloads and dequantize on read (bit-identical values, about
  4x less residual memory);
* the real-int8 path (:func:`int8_quantized_linear`): the forward quantizes
  each operand once, runs the int8 matmul kernel and keeps the int8
  payloads as residuals; when the recipe carries an in-contract G8 spec
  (:func:`int8_bwd_supported`) both backward matmuls run on the transposed
  int8 kernels against those payloads, otherwise the backward dequantizes
  on read and replays the reference VJP with plain matmuls.

The recipe's ``grads_dx`` spec turns on the paper's instability ablation
(quantized gradients on the dx path too).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.qadam import QState
from repro_torch.core.qconfig import Granularity, QuantRecipe, RoundMode
from repro_torch.core.quantizer import (dequantize_int, fake_quant_nograd,
                                        quantize_int)
from repro_torch.kernels.ops import (fused_fake_quant,
                                     fused_fake_quant_eligible, int8_bwd_dw,
                                     int8_bwd_dx, int8_payload_linear)


def _flat2d(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1, a.shape[-1])


def _train_fake_quant(x: torch.Tensor, spec) -> torch.Tensor:
    """``fake_quant_nograd`` with the hot symmetric 2-D+ cases routed
    through the fused qdq kernels (``kernels/ops.fused_fake_quant``, #1/#2):
    on a CUDA tensor they launch, on a CPU tensor their plain versions run
    (the same values as ``fake_quant_nograd``).  The tensor's device
    decides; there is no switch and no plain stand-in on the card.  Other
    specs keep ``fake_quant_nograd``, as in the reference."""
    if fused_fake_quant_eligible(spec, x):
        return fused_fake_quant(x, spec)
    return fake_quant_nograd(x, spec)


def residual_compressible(spec) -> bool:
    """Can the residual of this operand be stored as an int8 ``QState``
    instead of the qdq'd fp copy?  Needs a codec whose
    ``dequantize_int(quantize_int(x))`` equals ``fake_quant_nograd(x)`` bit
    for bit: symmetric, nearest rounding, <= 8 bits, no sqrt domain."""
    return (spec is not None and spec.symmetric
            and spec.round_mode is RoundMode.NEAREST
            and spec.bits <= 8 and not spec.sqrt_domain)


def _encode_residual(t: torch.Tensor, spec):
    """(value the matmul consumes, residual to store)."""
    if spec is None:
        return t, t
    if residual_compressible(spec):
        q, scale, zero = quantize_int(t, spec)
        deq = dequantize_int(q, scale, zero, spec, shape=t.shape,
                             dtype=t.dtype)
        return deq, QState(q, scale, zero)
    tq = _train_fake_quant(t, spec)
    return tq, tq


def _decode_residual(res, spec, shape, dtype) -> torch.Tensor:
    """Dequantize on read: the exact tensor the forward matmul consumed."""
    if isinstance(res, QState):
        return dequantize_int(res.q, res.scale, res.zero, spec, shape=shape,
                              dtype=dtype)
    return res


def _qlinear_bwd_core(recipe: QuantRecipe, xq: torch.Tensor,
                      wq: torch.Tensor, x_shape, g: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference Fig-1 VJP over the (dequantized) forward operands, shared
    by the fake-quant path and the int8 path's out-of-contract backward."""
    g_dx = g
    if recipe.grads_dx is not None:                  # instability ablation
        g_dx = _train_fake_quant(g, recipe.grads_dx)
    dx = torch.matmul(g_dx, wq.t()).reshape(x_shape)
    g_dw = g
    if recipe.grads is not None:
        g_dw = _train_fake_quant(g, recipe.grads)
    # fp32 accumulation, cast to the weight's dtype (the reference's
    # preferred_element_type=f32 dot_general)
    dw = torch.matmul(_flat2d(xq).t().to(torch.float32),
                      _flat2d(g_dw).to(torch.float32)).to(wq.dtype)
    return dx, dw


def _pack(res):
    return (tuple(res), True) if isinstance(res, QState) else ((res,), False)


class _QLinear(torch.autograd.Function):
    """Fake-quant Fig-1 linear (the reference's ``_qlinear`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, recipe):
        xv, xr = _encode_residual(x, recipe.acts)
        wv, wr = _encode_residual(w, recipe.weights)
        (xt, ctx.x_q), (wt, ctx.w_q) = _pack(xr), _pack(wr)
        ctx.save_for_backward(*xt, *wt)
        ctx.n_x = len(xt)
        ctx.recipe, ctx.x_shape = recipe, x.shape
        ctx.dtypes = (x.dtype, w.dtype)
        ctx.w_shape = w.shape
        return torch.matmul(xv, wv)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        xt, wt = saved[:ctx.n_x], saved[ctx.n_x:]
        xr = QState(*xt) if ctx.x_q else xt[0]
        wr = QState(*wt) if ctx.w_q else wt[0]
        r = ctx.recipe
        xq = _decode_residual(xr, r.acts, ctx.x_shape, ctx.dtypes[0])
        wq = _decode_residual(wr, r.weights, ctx.w_shape, ctx.dtypes[1])
        dx, dw = _qlinear_bwd_core(r, xq, wq, ctx.x_shape, g)
        return dx, dw, None


def quantized_linear(x: torch.Tensor, w: torch.Tensor,
                     recipe: Optional[QuantRecipe]) -> torch.Tensor:
    """Fake-quant entry point; a plain matmul when the recipe quantizes no
    linear-layer component."""
    if recipe is None or not recipe.any_linear_quant:
        return torch.matmul(x, w)
    return _QLinear.apply(x, w, recipe)


# ---------------------------------------------------------------------------
# Real-int8 backend: capabilities and the int8 Function
# ---------------------------------------------------------------------------

_INT8_GRANS_W = (Granularity.PER_CHANNEL, Granularity.PER_TENSOR)
_INT8_GRANS_A = (Granularity.PER_TOKEN, Granularity.PER_TENSOR)


def int8_backend_supported(recipe: Optional[QuantRecipe]) -> bool:
    """True when the recipe's forward is the int8 kernel's rank-1-rescale
    W8A8 contract: symmetric 8-bit weights+acts, nearest rounding, no
    block-wise codec (per-tensor/per-channel W x per-tensor/per-token A)."""
    if recipe is None:
        return False
    w, a = recipe.weights, recipe.acts
    return (w is not None and a is not None
            and w.bits == 8 and a.bits == 8
            and w.symmetric and a.symmetric
            and w.block_size == 0 and a.block_size == 0
            and not w.sqrt_domain and not a.sqrt_domain
            and w.round_mode is RoundMode.NEAREST
            and a.round_mode is RoundMode.NEAREST
            and w.granularity in _INT8_GRANS_W
            and a.granularity in _INT8_GRANS_A)


def int8_decode_attn_supported(spec) -> bool:
    """True when the int8-KV attention kernels (decode step and q8 prefill)
    consume a cache stored under ``spec``: symmetric 8-bit nearest-rounded
    PER_TOKEN -- one scale per (position, head) row."""
    return (spec is not None and spec.bits == 8 and spec.symmetric
            and spec.block_size == 0 and not spec.sqrt_domain
            and spec.round_mode is RoundMode.NEAREST
            and spec.granularity is Granularity.PER_TOKEN)


def int8_bwd_supported(recipe: Optional[QuantRecipe]) -> bool:
    """True when the backward is the transposed int8 kernels' contract: the
    forward contract plus a symmetric 8-bit nearest-rounded PER_TOKEN
    gradient spec and no dx-path ablation.  The hardware path quantizes the
    output gradient on both backward matmuls (an int8 dot needs two int8
    operands); recipes outside the contract replay the reference VJP on
    dequantized residuals."""
    if not int8_backend_supported(recipe):
        return False
    g = recipe.grads
    return (g is not None and recipe.grads_dx is None
            and g.bits == 8 and g.symmetric
            and g.block_size == 0 and not g.sqrt_domain
            and g.round_mode is RoundMode.NEAREST
            and g.granularity is Granularity.PER_TOKEN)


class _QLinearInt8(torch.autograd.Function):
    """W8A8 linear on the int8 kernels (the reference's ``_qlinear_int8``):
    each operand is quantized once and its int8 payload kept as the
    residual."""

    @staticmethod
    def forward(ctx, x, w, recipe):
        xq, x_scale, _ = quantize_int(_flat2d(x), recipe.acts)
        wq, w_scale, _ = quantize_int(w, recipe.weights)
        y = int8_payload_linear(xq, x_scale, wq, w_scale, out_dtype=x.dtype)
        ctx.save_for_backward(xq, x_scale, wq, w_scale)
        ctx.recipe, ctx.x_shape = recipe, x.shape
        ctx.dtypes = (x.dtype, w.dtype)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xq, x_scale, wq, w_scale = ctx.saved_tensors
        r, (x_dtype, w_dtype) = ctx.recipe, ctx.dtypes
        if int8_bwd_supported(r):
            g2 = _flat2d(g)
            dx = int8_bwd_dx(g2, wq, w_scale, out_dtype=x_dtype)
            dw = int8_bwd_dw(xq, x_scale, g2, out_dtype=w_dtype)
            return dx.reshape(ctx.x_shape), dw, None
        # out of contract (fp dW path, grads_dx ablation, coarse g):
        # dequantize on read and replay the reference VJP
        xd = dequantize_int(xq, x_scale, torch.zeros_like(x_scale), r.acts,
                            dtype=x_dtype)
        wd = dequantize_int(wq, w_scale, torch.zeros_like(w_scale), r.weights,
                            dtype=w_dtype)
        dx, dw = _qlinear_bwd_core(r, xd, wd, ctx.x_shape, g)
        return dx, dw, None


def int8_quantized_linear(x: torch.Tensor, w: torch.Tensor,
                          recipe: QuantRecipe) -> torch.Tensor:
    """W8A8 linear with real integer compute: always on the forward, and on
    both backward matmuls when :func:`int8_bwd_supported` accepts the
    recipe.  The caller checks :func:`int8_backend_supported`."""
    if not int8_backend_supported(recipe):
        raise ValueError(
            f"recipe [{recipe.describe() if recipe else 'fp'}] is outside the "
            "int8 kernel contract; use quantized_linear")
    return _QLinearInt8.apply(x, w, recipe)
