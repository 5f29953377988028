"""Shared model machinery: the carrier cast, LayerNorm and activations
(port of the parts of ``repro/models/common.py`` the dense GPT-2 uses).

Parameters are plain nested dicts of tensors with the JAX package's tree
layout (block leaves stacked on a leading layer dim), so a JAX parameter
tree carries across leaf for leaf (``model_api.params_from_jax``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.qadam import QState

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict; QState is one leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_flatten(tree):
    """(leaves, structure) of a nested dict, leaves in sorted-key order --
    ``jax.tree_util``'s order for dicts, so leaf lists line up with the JAX
    package's; QState is one leaf."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        leaves.append(node)
        return None
    return leaves, walk(tree)


def tree_unflatten(structure, leaves):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)
    return walk(structure)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Carrier-precision cast: float tensors only.  Prepared quantized
    weights (QState payload + fp32 scale sidecars) are opaque -- casting
    their scales to the carrier would change the dequant grid.  A leaf that
    already has the dtype is returned as is (no copy)."""
    def cast(x):
        if isinstance(x, QState) or not x.is_floating_point():
            return x
        return x.to(dtype)
    return tree_map(cast, params)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 with the population variance, cast back to the
    input's dtype (the reference's formula, op for op)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


ACT_FNS: Dict[str, Callable] = {
    # jax.nn.gelu(approximate=True) is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
}
