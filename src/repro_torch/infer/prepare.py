"""Prepared weights: resolve the QuantPolicy once and quantize each block
weight into a stored int8 payload + scales (port of
``repro/infer/prepare.py`` for the dense, MoE, SSM and hybrid families).

At inference the weights never change, so the engine quantizes them once
into :class:`QState` containers; ``QuantPolicy.linear`` recognizes a QState
and runs the int8 matmul kernel (backend ``int8_cuda``, W8A8 recipe) or the
dequant-read matmul.  The carrier-cast weight is quantized -- what the
model would have quantized in-trace -- and per-channel scales reduce over
the input axis (-2), so a stacked (L, d_in, d_out) weight gets (L, 1,
d_out) scales that the layer loop slices with the payload, and a stacked
expert weight (L, E, d_in, d_out) gets (L, E, 1, d_out): one scale grid
per expert, the reference's ``vmap`` slices.  Scales stay
fp32, never cast to the carrier.

The hybrid's shared block (``params["shared"]``: its ``attn`` and ``mlp``
through the same tables, its ``proj`` under ``shared_proj``) is depth-less:
its roles resolve with no layer, as its linears do.

Weights stay raw when the role resolves to fp, when a depth-banded policy
gives the layers of one stacked tensor different specs, or when the spec
is block-wise / sqrt-domain.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qadam import QState, state_nbytes
from repro_torch.core.qconfig import Granularity, QuantSpec
from repro_torch.core.qpolicy import Resolved, as_policy
from repro_torch.core.quantizer import compute_scale_zero, storage_dtype
from repro_torch.models.common import Params, tree_map

_ATTN_ROLES = {"wq": "attn_qkv", "wk": "attn_qkv", "wv": "attn_qkv",
               "wo": "attn_out"}
_MLP_ROLES = {"w_gate": "mlp_up", "w_up": "mlp_up", "w_fc1": "mlp_up",
              "w_down": "mlp_down", "w_fc2": "mlp_down"}
# the router is skipped: its call site casts the weight (fp by default)
_MOE_ROLES = {"w_gate": "mlp_up", "w_up": "mlp_up", "w_down": "mlp_down"}
# the SSM layer's five linears; its conv, A, dt, D and gate norm stay raw
_SSM_ROLES = {"in_z": "ssm_in", "in_x": "ssm_in", "in_bc": "ssm_in",
              "in_dt": "ssm_in", "out_proj": "ssm_out"}
_MODULE_TABLES = {"attn": _ATTN_ROLES, "mlp": _MLP_ROLES, "moe": _MOE_ROLES,
                  "ssm": _SSM_ROLES}


def quantize_weight(w: torch.Tensor, spec: QuantSpec) -> QState:
    """Quantize one (possibly layer-stacked) weight into payload + scales,
    reducing over the trailing matmul axes only (nearest rounding)."""
    xf = w.to(torch.float32, copy=True)
    if spec.granularity is Granularity.PER_CHANNEL:
        axes = (-2,)
    elif spec.granularity is Granularity.PER_TENSOR:
        axes = (-2, -1)
    else:                                    # PER_TOKEN: one scale per in-row
        axes = (-1,)
    scale, zero = compute_scale_zero(xf, spec, axes=axes)
    # in place on the fp32 copy, op for op the reference's chain: a stacked
    # Yi-6B MLP weight is 5.8 GB in fp32
    q = xf.div_(scale).round_().sub_(zero).clamp_(spec.qmin, spec.qmax)
    return QState(q.to(storage_dtype(spec.bits)), scale, zero)


def _preparable_spec(res: Optional[Resolved]) -> Optional[QuantSpec]:
    if res is None or res.recipe is None:
        return None
    spec = res.recipe.weights
    if spec is None or spec.block_size or spec.sqrt_domain:
        return None
    return spec


def prepare_params(cfg, params: Params, policy) -> Params:
    """A copy of ``params`` with every block weight the policy quantizes
    replaced by its stored-integer :class:`QState`; a weight already
    prepared stays as it is, so a prepared tree can serve another
    engine."""
    policy = as_policy(policy)
    n_layers = cfg.n_layers
    carrier = getattr(torch, cfg.dtype)

    def resolve_uniform(role: str, depthful: bool) -> Optional[Resolved]:
        if not depthful:
            return policy.resolve(role, None, n_layers)
        rs = [policy.resolve(role, i, n_layers) for i in range(n_layers)]
        return rs[0] if all(r == rs[0] for r in rs) else None

    def prep(w, role: str, depthful: bool = True):
        spec = _preparable_spec(resolve_uniform(role, depthful))
        if spec is None or isinstance(w, QState):    # raw, or prepared
            return w
        return quantize_weight(w.to(carrier), spec)

    def prep_modules(tree, depthful: bool):
        return {mod: ({k: (prep(v, _MODULE_TABLES[mod][k], depthful)
                           if k in _MODULE_TABLES[mod] else v)
                       for k, v in sub.items()}
                      if mod in _MODULE_TABLES else sub)
                for mod, sub in tree.items()}

    out = dict(params)
    out["blocks"] = prep_modules(params["blocks"], True)
    if "shared" in params:                  # zamba2: depth-less shared block
        shared = prep_modules(params["shared"], False)
        shared["proj"] = prep(params["shared"]["proj"], "shared_proj", False)
        out["shared"] = shared
    return out


def params_nbytes(params: Params) -> int:
    """Resident bytes of a (possibly prepared) parameter tree."""
    sizes = []
    tree_map(lambda x: sizes.append(state_nbytes(x)), params)
    return sum(sizes)
