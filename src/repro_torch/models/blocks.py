"""Pre-norm residual decoder block of the dense family (port of the dense
branch of ``repro/models/blocks.py``)."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.qpolicy import QuantPolicy
from repro_torch.models.attention import Cache, attn_apply
from repro_torch.models.common import layernorm
from repro_torch.models.mlp import mlp_apply


def block_apply(params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
                layer: int, cache: Optional[Cache] = None,
                cache_offset: Union[int, torch.Tensor, None] = None
                ) -> torch.Tensor:
    """h + attn(ln1(h)), then + mlp(ln2(h)); writes this layer's cache when
    one is given (serving), attends causally over h without one
    (training)."""
    nl = cfg.n_layers
    x = layernorm(h, params["ln1"]["scale"], params["ln1"]["bias"])
    h = h + attn_apply(params["attn"], x, cfg, policy=policy, cache=cache,
                       cache_offset=cache_offset, layer=layer, n_layers=nl)
    x = layernorm(h, params["ln2"]["scale"], params["ln2"]["bias"])
    return h + mlp_apply(params["mlp"], x, cfg, policy=policy, layer=layer,
                         n_layers=nl)
