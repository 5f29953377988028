"""Integer-stored tensor container, ported from ``repro.core.qadam``.

Serving needs only the container: prepared weights are stored as an int8
payload plus fp32 scale and zero-point sidecars.  The quantized-moment
optimizer itself comes with the training slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QState(NamedTuple):
    """Integer-stored tensor: payload + codec sidecar."""
    q: torch.Tensor          # int8/int16 payload
    scale: torch.Tensor      # fp32 scales, granularity-shaped
    zero: torch.Tensor       # fp32 zero points (zeros when symmetric)


def state_nbytes(state) -> int:
    """Bytes held by one tensor or QState."""
    if isinstance(state, QState):
        return sum(x.numel() * x.element_size() for x in state)
    return state.numel() * state.element_size()
