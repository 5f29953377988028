"""Pre-norm residual decoder block of the dense family (port of the dense
branch of ``repro/models/blocks.py``): GPT-2's LayerNorm or llama's
RMSNorm by ``cfg.norm``."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.qpolicy import QuantPolicy
from repro_torch.models.attention import Cache, attn_apply
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import mlp_apply


def block_apply(params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
                layer: int, cache: Optional[Cache] = None,
                cache_offset: Union[int, torch.Tensor, None] = None,
                page_table: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rope=None) -> torch.Tensor:
    """h + attn(norm1(h)), then + mlp(norm2(h)); writes this layer's cache
    when one is given (serving; ``page_table``, ``mask`` and ``rope`` as
    in ``attn_apply``), attends causally over h without one (training)."""
    nl = cfg.n_layers
    x = apply_norm(h, params["ln1"], cfg.norm)
    h = h + attn_apply(params["attn"], x, cfg, policy=policy, cache=cache,
                       cache_offset=cache_offset, page_table=page_table,
                       mask=mask, rope=rope, layer=layer, n_layers=nl)
    x = apply_norm(h, params["ln2"], cfg.norm)
    return h + mlp_apply(params["mlp"], x, cfg, policy=policy, layer=layer,
                         n_layers=nl)
