"""Pre-norm residual decoder block of the dense and MoE families (port of
the attention branch of ``repro/models/blocks.py``): GPT-2's LayerNorm or
llama's RMSNorm by ``cfg.norm``, then the dense MLP or, under
``cfg.n_experts``, the mixture of experts (``models/moe.py``), whose
load-balance and z losses the block hands back (None on the dense branch,
the reference's zeros).

The block is two halves split at the attention context, the tensor the
reference's recomputation keeps (``attn_ctx``): :func:`block_context`
(norm, q/k/v, attention) and :func:`block_finish` (the output projection,
the residual, norm, MLP).  ``lm.lm_loss`` checkpoints each half on its own
under ``cfg.remat``; :func:`block_apply` runs both.

The SSM family's block (:func:`ssm_block`, the reference's ``ssm`` branch)
is pre-norm, the Mamba2 layer (``models/ssm.py``) and the residual: no
attention, no MLP, and no MoE losses (the reference's zeros; None here, as
on the dense branch).

The hybrid family (zamba2) runs groups of SSM blocks, each followed by
:func:`shared_block` (the reference's ``lm._shared_attn``): one attention +
MLP block whose weights every group shares, on concat(h, emb0) -- the
running residual and the embedding output, 2 * d_model wide -- projected
back to d_model (role ``shared_proj``) and added to h.  Its linears resolve
depth-less (``layer=None``).  It too is two halves split at the attention
context, :func:`shared_context` and :func:`shared_finish`, which the loss
checkpoints on their own."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.qpolicy import LinearCtx, QuantPolicy
from repro_torch.models.attention import Cache, attn_context, attn_out
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.moe import moe_apply
from repro_torch.models.ssm import SSMState, ssm_apply, ssm_decode_step

#: what a block returns: (h, aux, z_loss), the MoE losses None when dense
BlockOut = Tuple[torch.Tensor, Optional[torch.Tensor],
                 Optional[torch.Tensor]]


def block_context(params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
                  layer: int, **attn_kw) -> torch.Tensor:
    """The attention context of norm1(h) (``attn_context``; ``attn_kw`` its
    cache, ``cache_offset``, ``page_table``, ``mask``, ``rope`` and
    ``kv_path``)."""
    x = apply_norm(h, params["ln1"], cfg.norm)
    return attn_context(params["attn"], x, cfg, policy=policy, layer=layer,
                        n_layers=cfg.n_layers, **attn_kw)


def block_finish(params, h: torch.Tensor, ctx: torch.Tensor, cfg, *,
                 policy: QuantPolicy, layer: int) -> BlockOut:
    """h + attn_out(ctx), then + mlp(norm2(h)) (or the experts' output)
    -> (h, aux, z_loss)."""
    nl = cfg.n_layers
    h = h + attn_out(params["attn"], ctx, policy=policy, layer=layer,
                     n_layers=nl)
    x = apply_norm(h, params["ln2"], cfg.norm)
    if cfg.n_experts:
        y, aux, z = moe_apply(params["moe"], x, cfg, policy=policy,
                              layer=layer, n_layers=nl)
        return h + y, aux, z
    return h + mlp_apply(params["mlp"], x, cfg, policy=policy, layer=layer,
                         n_layers=nl), None, None


def block_apply(params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
                layer: int, cache: Optional[Cache] = None,
                cache_offset: Union[int, torch.Tensor, None] = None,
                page_table: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rope=None, kv_path: Optional[str] = None) -> BlockOut:
    """h + attn(norm1(h)), then + mlp(norm2(h)) -> (h, aux, z_loss); writes this layer's cache
    when one is given (serving; ``page_table``, ``mask``, ``rope`` and
    ``kv_path`` as in ``attn_context``), attends causally over h without
    one (training)."""
    ctx = block_context(params, h, cfg, policy=policy, layer=layer,
                        cache=cache, cache_offset=cache_offset,
                        page_table=page_table, mask=mask, rope=rope,
                        kv_path=kv_path)
    return block_finish(params, h, ctx, cfg, policy=policy, layer=layer)


def ssm_block(params, h: torch.Tensor, cfg, *, policy: QuantPolicy,
              layer: int, state: Optional[SSMState] = None,
              decode: bool = False
              ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """h + ssm(norm(h)) -> (h, the layer's new state, or None when
    ``state`` is None: training).  ``decode`` runs the one-token recurrent
    step from ``state``, else the chunked SSD over h (prefill starts from
    ``state``, the zeros of ``init_ssm_state``)."""
    x = apply_norm(h, params["norm"], cfg.norm)
    if decode:
        y, new = ssm_decode_step(params["ssm"], x, cfg, policy=policy,
                                 state=state, layer=layer,
                                 n_layers=cfg.n_layers)
    else:
        y, new = ssm_apply(params["ssm"], x, cfg, policy=policy, state=state,
                           return_state=state is not None, layer=layer,
                           n_layers=cfg.n_layers)
    return h + y, new


def shared_context(params, x2: torch.Tensor, cfg, *, policy: QuantPolicy,
                   **attn_kw) -> torch.Tensor:
    """The first half of :func:`shared_block`: the attention context of
    ln1(x2), x2 = concat(h, emb0) (``attn_kw`` as in :func:`block_context`:
    this invocation's cache, ``cache_offset``, ``mask``, ``rope``,
    ``kv_path``)."""
    x = apply_norm(x2, params["ln1"], cfg.norm)
    return attn_context(params["attn"], x, cfg, policy=policy, layer=None,
                        n_layers=cfg.n_layers, **attn_kw)


def shared_finish(params, h: torch.Tensor, x2: torch.Tensor,
                  ctx: torch.Tensor, cfg, *,
                  policy: QuantPolicy) -> torch.Tensor:
    """The second half of :func:`shared_block`: x2 += attn_out(ctx); x2 +=
    mlp(ln2(x2)); h + x2 @ proj -> h."""
    nl = cfg.n_layers
    x2 = x2 + attn_out(params["attn"], ctx, policy=policy, layer=None,
                       n_layers=nl)
    x = apply_norm(x2, params["ln2"], cfg.norm)
    x2 = x2 + mlp_apply(params["mlp"], x, cfg, policy=policy, layer=None,
                        n_layers=nl)
    return h + policy.linear(LinearCtx("shared_proj", None, nl), x2,
                             params["proj"])


def shared_block(params, h: torch.Tensor, emb0: torch.Tensor, cfg, *,
                 policy: QuantPolicy, **attn_kw) -> torch.Tensor:
    """zamba2's shared block: x2 = concat(h, emb0); x2 += attn(ln1(x2));
    x2 += mlp(ln2(x2)); h + x2 @ proj -> h (:func:`shared_context`, then
    :func:`shared_finish`).  ``attn_kw`` as in :func:`block_context`;
    every linear depth-less."""
    x2 = torch.cat([h, emb0], dim=-1)
    ctx = shared_context(params, x2, cfg, policy=policy, **attn_kw)
    return shared_finish(params, h, x2, ctx, cfg, policy=policy)
