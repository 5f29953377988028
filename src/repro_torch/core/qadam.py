"""Quantized Adam optimizer states (paper Section 4.4), ported from
``repro.core.qadam``.

The moments are stored between steps quantized and dequantized for the
update.  Two storage modes, as in the reference:

``fake`` (paper-faithful)
    fp32 moments passed through quantize -> dequantize after every update.

``int`` (production)
    int8/int16 payloads plus fp32 scale / zero-point sidecars: the real
    memory saving, and the layout the fused AdamW kernel consumes
    (``kernels/opt_update.py``).

The same container holds prepared serving weights (``infer/prepare.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.qconfig import QuantSpec, RoundMode
from repro_torch.core.quantizer import (dequantize_int, fake_quant_nograd,
                                        quantize_int)

# Parameters smaller than this (or 1-D) keep fp moments: per-channel scales
# on tiny tensors cost more than they save (8-bit-optimizer practice).
MIN_QUANT_SIZE = 4096


def quantizable(param: torch.Tensor) -> bool:
    return param.ndim >= 2 and param.numel() >= MIN_QUANT_SIZE


class QState(NamedTuple):
    """Integer-stored tensor: payload + codec sidecar."""
    q: torch.Tensor          # int8/int16 payload (blockwise: (nblocks, bs))
    scale: torch.Tensor      # fp32 scales, granularity-shaped
    zero: torch.Tensor       # fp32 zero points (zeros when symmetric)


def encode(value: torch.Tensor, spec: Optional[QuantSpec], storage: str) -> Any:
    """Compress one moment tensor according to the spec and storage mode."""
    if spec is None or not quantizable(value):
        return value
    if spec.sqrt_domain:
        if storage == "int":
            root = torch.sqrt(torch.clamp_min(value, 0.0))
            return QState(*quantize_int(root, spec))
        return fake_quant_nograd(value, spec)
    if storage == "int":
        return QState(*quantize_int(value, spec))
    if storage == "fake":
        return fake_quant_nograd(value, spec)
    raise ValueError(f"unknown storage mode {storage!r}")


def decode(state: Any, spec: Optional[QuantSpec], shape,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Recover the fp moment for the Adam update."""
    if spec is None or not isinstance(state, QState):
        return state
    deq = dequantize_int(state.q, state.scale, state.zero, spec,
                         shape=shape, dtype=dtype)
    if spec.sqrt_domain:
        deq = torch.square(deq)
    return deq


def init_state(param: torch.Tensor, spec: Optional[QuantSpec],
               storage: str) -> Any:
    """Zero moment in the chosen representation, on the param's device."""
    zeros = torch.zeros(param.shape, dtype=torch.float32, device=param.device)
    return encode(zeros, spec, storage)


def state_nbytes(state) -> int:
    """Bytes held by one tensor or QState."""
    if isinstance(state, QState):
        return sum(x.numel() * x.element_size() for x in state)
    return state.numel() * state.element_size()


# ---------------------------------------------------------------------------
# Blockwise layout helpers and fused-kernel eligibility.  For a blockwise
# spec, encode flattens the tensor, zero-pads the tail to a block multiple
# and stores q (nblocks, block_size) int8 with (nblocks, 1) fp32 scale and
# zero: one quantization block per row, so per-leaf states of one block
# size concatenate along rows into one kernel bucket and split back.
# ---------------------------------------------------------------------------

def blockwise_state_shapes(shape, spec: QuantSpec
                           ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((nblocks, block_size), (nblocks, 1)) for a blockwise-encoded tensor
    of ``shape``."""
    n = 1
    for d in shape:
        n *= d
    nblocks = -(-n // spec.block_size)
    return (nblocks, spec.block_size), (nblocks, 1)


def flatten_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flatten to the (nblocks, block_size) codec layout, zero-padding the
    tail block (the quantizer's blocked view)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block_size)


def unflatten_blocks(blocks: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`flatten_blocks`: strip tail padding, restore shape."""
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


def fused_spec_eligible(spec: Optional[QuantSpec]) -> bool:
    """Can the fused AdamW kernel hold this moment codec in registers?  The
    blockwise int8 family: block_size > 0 (row-aligned scales), <= 8 bits,
    nearest rounding.  Symmetric, asymmetric and sqrt-domain all fit."""
    return (spec is not None and spec.block_size > 0 and spec.bits <= 8
            and spec.round_mode is RoundMode.NEAREST)


def fused_pair_eligible(m1_spec: Optional[QuantSpec],
                        m2_spec: Optional[QuantSpec]) -> bool:
    """Both moments kernel-eligible with one shared block size (grad and
    param tiles are laid out once per bucket)."""
    return (fused_spec_eligible(m1_spec) and fused_spec_eligible(m2_spec)
            and m1_spec.block_size == m2_spec.block_size)
