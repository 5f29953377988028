"""AdamW with optionally quantized moments (paper Section 4.4), ported from
``repro.optim.adamw``.

The moments are stored between steps in the representation the recipe
selects (fp, fake-quantized fp, or int8 payloads plus scales) and decoded
for the update.  Two update paths share those semantics:

* the reference **loop**: one leaf at a time, decode -> update -> encode as
  separate torch ops (the compared oracle, and the only path for fp or
  fake storage, non-blockwise moment codecs and non-quantizable leaves);
* the **fused** path: quantizable leaves with blockwise int8 moments are
  updated by one launch of ``kernels/opt_update.fused_adamw_leaves`` per
  param dtype, which reads every leaf where it lies and writes one fresh
  (rows, block_size) bucket in the reference's leaf order and padding (the
  JAX package concatenates the leaves into that bucket first and pads it
  to its tile; the padding rows update to 0 and are never read).  The
  caller's state is not modified, and the new params and moments are views
  into the bucket.

``adamw_update(..., fused=None)`` takes the fused path on CUDA tensors
whenever the moment pair is eligible; ``fused=True`` / ``False`` force the
choice (``fused=True`` on the CPU runs the kernel's plain version).  The
step counter, learning rate, clip factor and bias corrections stay on the
params' device, so a step never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import qadam
from repro_torch.core.qconfig import QuantRecipe
from repro_torch.core.quantizer import _div
from repro_torch.kernels import opt_update as _ok
from repro_torch.models.common import tree_flatten, tree_unflatten

@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 6e-4                 # paper Appendix A
    b1: float = 0.9
    b2: float = 0.95                 # nanoGPT-style (paper follows nanoGPT)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 300_000       # paper: 300k steps
    min_lr_ratio: float = 0.0        # cosine decays to ~0
    state_storage: str = "fake"      # fake (paper) | int (production int8)


class AdamState(NamedTuple):
    step: torch.Tensor               # int32 0-d, on the params' device
    m1: Any                          # params-shaped tree: tensors or QState
    m2: Any


def lr_schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup + half-cycle cosine (paper Appendix A), float32 on the
    step's device."""
    s = step.to(torch.float32)
    warm = torch.clamp_max(_div(s, float(max(cfg.warmup_steps, 1))), 1.0)
    frac = torch.clamp(_div((step - cfg.warmup_steps).to(torch.float32),
                            float(max(cfg.total_steps - cfg.warmup_steps, 1))),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in order (the reference's order)."""
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_factor(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Global-norm clip factor min(1, max_norm / max(gnorm, 1e-12)), folded
    into the gradient by both update paths."""
    return torch.clamp_max(
        torch.full_like(gnorm, max_norm) / torch.clamp_min(gnorm, 1e-12), 1.0)


def init_adam_state(params, recipe: Optional[QuantRecipe],
                    cfg: OptConfig) -> AdamState:
    recipe = recipe or QuantRecipe()
    leaves, struct = tree_flatten(params)
    dev = leaves[0].device

    def moments(spec):
        return tree_unflatten(struct, [qadam.init_state(p, spec,
                                                        cfg.state_storage)
                                       for p in leaves])
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     m1=moments(recipe.adam_m1), m2=moments(recipe.adam_m2))


def fused_default(recipe, cfg: OptConfig, device: torch.device) -> bool:
    """The fused kernel path runs on CUDA tensors whenever int storage and
    the moment codecs allow it."""
    recipe = recipe or QuantRecipe()
    return (device.type == "cuda" and cfg.state_storage == "int"
            and qadam.fused_pair_eligible(recipe.adam_m1, recipe.adam_m2))


def opt_path_desc(recipe, cfg: OptConfig, device) -> str:
    """The ``opt=`` segment of ``train.step.train_path_summary``: fp / fake
    / int8 storage x fused kernel or reference loop, as ``adamw_update``
    chooses by default for params on ``device``."""
    recipe = recipe or QuantRecipe()
    m1, m2 = recipe.adam_m1, recipe.adam_m2
    if m1 is None and m2 is None:
        return "fp-loop"
    if cfg.state_storage != "int":
        return "fake-loop"
    if fused_default(recipe, cfg, torch.device(device)):
        return f"int8-fused(b{m1.block_size})"
    return "int8-loop"


def _leaf_update(p, gf, m1, m2, lr, c1, c2, cfg: OptConfig):
    """Decoded-moment AdamW update of one leaf.  Returns (new_p, new_m1,
    new_m2, delta) with ``delta`` the applied fp32 step."""
    m1 = cfg.b1 * m1 + (1.0 - cfg.b1) * gf
    m2 = cfg.b2 * m2 + (1.0 - cfg.b2) * torch.square(gf)
    upd = (m1 / c1) / (torch.sqrt(m2 / c2) + cfg.eps)
    pf = p.to(torch.float32)
    if cfg.weight_decay and p.ndim >= 2:
        upd = upd + cfg.weight_decay * pf
    delta = lr * upd
    return (pf - delta).to(p.dtype), m1, m2, delta


def _fused_bucket(idxs: List[int], p_leaves, g_leaves, m1_leaves, m2_leaves,
                  clip, lr, c1, c2, cfg: OptConfig, recipe):
    """One fused-kernel launch over the leaves in ``idxs`` (one param dtype,
    the policy's moment specs), read where they lie.  Returns (new_p,
    new_m1, new_m2) keyed by leaf index -- views into one fresh bucket --
    and the bucket's sum of delta^2."""
    m1_spec, m2_spec = recipe.adam_m1, recipe.adam_m2
    bs = m1_spec.block_size
    for i in idxs:
        (nb, _), _ = qadam.blockwise_state_shapes(p_leaves[i].shape, m1_spec)
        for m in (m1_leaves[i], m2_leaves[i]):
            if tuple(m.q.shape) != (nb, bs):
                raise ValueError(f"moment payload {tuple(m.q.shape)} is not "
                                 f"the blockwise layout ({nb}, {bs})")

    dev = p_leaves[idxs[0]].device

    def const(v):
        return torch.full((), v, dtype=torch.float32, device=dev)
    scalars = torch.stack([clip.to(torch.float32), lr.to(torch.float32),
                           const(cfg.b1), const(cfg.b2), const(cfg.eps),
                           const(cfg.weight_decay), c1.to(torch.float32),
                           c2.to(torch.float32)])
    p_new, m1_new, m2_new, sumsq = _ok.fused_adamw_leaves(
        [g_leaves[i] for i in idxs], [p_leaves[i] for i in idxs],
        [m1_leaves[i] for i in idxs], [m2_leaves[i] for i in idxs], scalars,
        m1_codec=_ok.codec_of(m1_spec), m2_codec=_ok.codec_of(m2_spec),
        weight_decay=bool(cfg.weight_decay))
    return ({i: p for i, p in zip(idxs, p_new)},
            {i: qadam.QState(*m) for i, m in zip(idxs, m1_new)},
            {i: qadam.QState(*m) for i, m in zip(idxs, m2_new)}, sumsq)


def adamw_update(params, grads, state: AdamState, cfg: OptConfig,
                 recipe: Optional[QuantRecipe] = None,
                 fused: Optional[bool] = None
                 ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step: params fp32 master, grads any float dtype.  Returns
    (new_params, new_state, stats) with stats lr, grad_norm and
    update_norm, 0-d tensors on the params' device."""
    recipe = recipe or QuantRecipe()
    m1_spec, m2_spec = recipe.adam_m1, recipe.adam_m2
    p_leaves, struct = tree_flatten(params)
    g_leaves = tree_flatten(grads)[0]
    m1_leaves = tree_flatten(state.m1)[0]
    m2_leaves = tree_flatten(state.m2)[0]
    n = len(p_leaves)
    if fused is None:
        fused = fused_default(recipe, cfg, p_leaves[0].device)

    gnorm = global_norm(g_leaves)
    clip = clip_factor(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, stepf)
    c2 = 1.0 - torch.pow(cfg.b2, stepf)

    fused_ok = (fused and cfg.state_storage == "int"
                and qadam.fused_pair_eligible(m1_spec, m2_spec))
    new_p: List[Any] = [None] * n
    new_m1: List[Any] = [None] * n
    new_m2: List[Any] = [None] * n
    upd_sumsq = torch.zeros((), dtype=torch.float32,
                            device=p_leaves[0].device)

    # fused path: one kernel launch per param dtype over all its leaves
    buckets: Dict[torch.dtype, List[int]] = {}
    for i in range(n):
        if (fused_ok and qadam.quantizable(p_leaves[i])
                and isinstance(m1_leaves[i], qadam.QState)
                and isinstance(m2_leaves[i], qadam.QState)):
            buckets.setdefault(p_leaves[i].dtype, []).append(i)
    for idxs in buckets.values():
        out_p, out_m1, out_m2, sumsq = _fused_bucket(
            idxs, p_leaves, g_leaves, m1_leaves, m2_leaves, clip, lr, c1, c2,
            cfg, recipe)
        upd_sumsq = upd_sumsq + sumsq
        for i in idxs:
            new_p[i], new_m1[i], new_m2[i] = out_p[i], out_m1[i], out_m2[i]

    # reference loop: decode -> update -> encode, one leaf at a time
    for i in range(n):
        if new_p[i] is not None:
            continue
        p = p_leaves[i]
        gf = g_leaves[i].to(torch.float32) * clip
        m1 = qadam.decode(m1_leaves[i], m1_spec, p.shape)
        m2 = qadam.decode(m2_leaves[i], m2_spec, p.shape)
        new_p[i], m1, m2, delta = _leaf_update(p, gf, m1, m2, lr, c1, c2, cfg)
        upd_sumsq = upd_sumsq + torch.sum(torch.square(delta))
        new_m1[i] = qadam.encode(m1, m1_spec, cfg.state_storage)
        new_m2[i] = qadam.encode(m2, m2_spec, cfg.state_storage)

    stats = {"lr": lr, "grad_norm": gnorm,
             "update_norm": torch.sqrt(upd_sumsq)}
    return (tree_unflatten(struct, new_p),
            AdamState(step=step, m1=tree_unflatten(struct, new_m1),
                      m2=tree_unflatten(struct, new_m2)),
            stats)
