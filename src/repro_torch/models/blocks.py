"""Pre-norm residual decoder block of the dense family (port of the dense
branch of ``repro/models/blocks.py``): GPT-2's LayerNorm or llama's
RMSNorm by ``cfg.norm``.

The block is two halves split at the attention context, the tensor the
reference's recomputation keeps (``attn_ctx``): :func:`block_context`
(norm, q/k/v, attention) and :func:`block_finish` (the output projection,
the residual, norm, MLP).  ``lm.lm_loss`` checkpoints each half on its own
under ``cfg.remat``; :func:`block_apply` runs both."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.qpolicy import QuantPolicy
from repro_torch.models.attention import Cache, attn_context, attn_out
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import mlp_apply


def block_context(params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
                  layer: int, **attn_kw) -> torch.Tensor:
    """The attention context of norm1(h) (``attn_context``; ``attn_kw`` its
    cache, ``cache_offset``, ``page_table``, ``mask``, ``rope`` and
    ``kv_path``)."""
    x = apply_norm(h, params["ln1"], cfg.norm)
    return attn_context(params["attn"], x, cfg, policy=policy, layer=layer,
                        n_layers=cfg.n_layers, **attn_kw)


def block_finish(params, h: torch.Tensor, ctx: torch.Tensor, cfg, *,
                 policy: QuantPolicy, layer: int) -> torch.Tensor:
    """h + attn_out(ctx), then + mlp(norm2(h))."""
    nl = cfg.n_layers
    h = h + attn_out(params["attn"], ctx, policy=policy, layer=layer,
                     n_layers=nl)
    x = apply_norm(h, params["ln2"], cfg.norm)
    return h + mlp_apply(params["mlp"], x, cfg, policy=policy, layer=layer,
                         n_layers=nl)


def block_apply(params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
                layer: int, cache: Optional[Cache] = None,
                cache_offset: Union[int, torch.Tensor, None] = None,
                page_table: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rope=None, kv_path: Optional[str] = None) -> torch.Tensor:
    """h + attn(norm1(h)), then + mlp(norm2(h)); writes this layer's cache
    when one is given (serving; ``page_table``, ``mask``, ``rope`` and
    ``kv_path`` as in ``attn_context``), attends causally over h without
    one (training)."""
    ctx = block_context(params, h, cfg, policy=policy, layer=layer,
                        cache=cache, cache_offset=cache_offset,
                        page_table=page_table, mask=mask, rope=rope,
                        kv_path=kv_path)
    return block_finish(params, h, ctx, cfg, policy=policy, layer=layer)
