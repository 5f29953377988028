"""Shared model machinery: the carrier cast, the norms, activations, the
rotary embedding (port of the parts of ``repro/models/common.py`` the
dense GPT-2 and llama families use) and :func:`checkpointed`, the port's
``jax.checkpoint``.

Parameters are plain nested dicts of tensors with the JAX package's tree
layout (block leaves stacked on a leading layer dim), so a JAX parameter
tree carries across leaf for leaf (``model_api.params_from_jax``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def checkpointed(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` whose backward recomputes it, the
    reference's ``jax.checkpoint``: nothing ``fn`` computes inside is kept
    for the backward, only its arguments (non-reentrant
    ``torch.utils.checkpoint``, so the backward runs the same autograd
    graph, and the recomputed values are the first forward's bits wherever
    its ops repeat theirs).  Under ``no_grad`` (serving, eval) it is a plain
    call."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


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


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input's dtype (the reference's
    formula, op for op; its ``plus_one`` variant is gemma's and is not
    ported)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def apply_norm(x: torch.Tensor, params, kind: str) -> torch.Tensor:
    """The block's norm by ``cfg.norm``: ``rmsnorm`` ({scale}) or
    ``layernorm`` ({scale, bias})."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    raise ValueError(f"norm {kind!r} is not ported (rmsnorm | layernorm)")


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles, each (..., S, 1, head_dim) fp32 in
    the layout :func:`apply_rope` multiplies by: cos twice over, sin
    negated on the first half.  ``positions`` (..., S) ints.

    The reference's numbers: inverse frequencies ``theta ** (-i / half)``
    and angles ``position * frequency`` in fp32.  The power is taken in
    float64 and rounded, which gives the fp32 value JAX's pow gives; cos
    and sin are also taken in float64 and rounded, the correctly rounded
    fp32 result (XLA's and PyTorch's fp32 cos each miss it by an ulp in a
    few elements of a hundred, in different places).  A forward builds the
    tables once and every layer's q and k take them."""
    half = head_dim // 2
    dev = positions.device
    # the exponent in fp32 (an IEEE division by a tensor on every device)
    expo = -torch.arange(half, dtype=torch.float32, device=dev) / torch.full(
        (), half, dtype=torch.float32, device=dev)
    freqs = torch.pow(torch.full((), float(theta), dtype=torch.float64,
                                 device=dev), expo.to(torch.float64)
                      ).to(torch.float32)
    angles = positions.to(torch.float32)[..., :, None] * freqs
    a64 = angles.to(torch.float64)
    cos = torch.cos(a64).to(torch.float32)
    sin = torch.sin(a64).to(torch.float32)
    return (torch.cat([cos, cos], dim=-1)[..., :, None, :],
            torch.cat([-sin, sin], dim=-1)[..., :, None, :])


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate x (..., S, heads, head_dim) by :func:`rope_tables`' (cos,
    sin): the reference's concatenated halves, ``[x1 cos - x2 sin, x2 cos +
    x1 sin]`` in fp32 (``x1 cos + x2 (-sin)`` is the same IEEE result),
    cast back to x's dtype."""
    cos, sin = tables
    half = x.shape[-1] // 2
    xf = x.to(torch.float32)
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of x (..., S, heads, head_dim) at ``positions``
    (..., S): the reference's ``rope`` in one call."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


ACT_FNS: Dict[str, Callable] = {
    # jax.nn.gelu(approximate=True) is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
}
