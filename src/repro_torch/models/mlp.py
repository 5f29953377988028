"""Classic two-layer feed-forward (GPT-2): fc1 -> act -> fc2, both through
the policy-dispatched linear (roles ``mlp_up`` and ``mlp_down``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qpolicy import LinearCtx, QuantPolicy
from repro_torch.models.common import ACT_FNS


def mlp_apply(params, x: torch.Tensor, cfg, *, policy: QuantPolicy,
              layer: Optional[int] = None, n_layers: int = 0) -> torch.Tensor:
    act = ACT_FNS[cfg.act]
    h = act(policy.linear(LinearCtx("mlp_up", layer, n_layers), x,
                          params["w_fc1"], params.get("b_fc1")))
    return policy.linear(LinearCtx("mlp_down", layer, n_layers), h,
                         params["w_fc2"], params.get("b_fc2"))
