"""Dense feed-forward (port of ``repro/models/mlp.py``), every projection
through the policy-dispatched linear (roles ``mlp_up`` for the expanding
projections, ``mlp_down`` for the contraction back to the residual):

* classic (GPT-2): fc1 -> act -> fc2;
* gated (llama's SwiGLU): ``act(x @ w_gate) * (x @ w_up)``, then ``w_down``.

Widths come from the weights, so the hybrid's shared block runs it on its
2 * d_model-wide input.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qpolicy import LinearCtx, QuantPolicy
from repro_torch.models.common import ACT_FNS


def mlp_apply(params, x: torch.Tensor, cfg, *, policy: QuantPolicy,
              layer: Optional[int] = None, n_layers: int = 0) -> torch.Tensor:
    act = ACT_FNS[cfg.act]
    up = LinearCtx("mlp_up", layer, n_layers)
    down = LinearCtx("mlp_down", layer, n_layers)
    if cfg.mlp_kind == "gated":
        g = policy.linear(up, x, params["w_gate"], params.get("b_gate"))
        u = policy.linear(up, x, params["w_up"], params.get("b_up"))
        return policy.linear(down, act(g) * u, params["w_down"],
                             params.get("b_down"))
    h = act(policy.linear(up, x, params["w_fc1"], params.get("b_fc1")))
    return policy.linear(down, h, params["w_fc2"], params.get("b_fc2"))
