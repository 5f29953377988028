"""Train and eval step factories (port of ``repro.train.step``).

``make_train_step`` closes over (model, quantization policy, opt config)
and returns ``train_step(state, batch) -> (state, metrics)``: forward and
backward through the policy's Fig-1 linears, then one AdamW step.  As in
the reference, the fp32 master params are cast to bfloat16 first and the
model casts them again to ``cfg.dtype`` (so a float32 carrier computes over
bf16-rounded weights); gradients flow back through both casts to the fp32
leaves.  PyTorch runs eagerly, so there is no jit: the step is a plain
function, and the optimizer may update its bucket in place
(``optim/adamw.py``).

The ``recipe`` argument of every factory accepts the full policy surface:
None (fp), a :class:`QuantRecipe`, a :class:`QuantPolicy` or a policy
string, normalized by ``as_policy``; the policy's ``adam_m1`` / ``adam_m2``
select the optimizer's moment codecs.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.diagnostics import grad_quant_health
from repro_torch.core.qlinear import residual_compressible
from repro_torch.core.qpolicy import QuantPolicy, as_policy
from repro_torch.core.quantizer import _div
from repro_torch.models.attention import _pick_chunk
from repro_torch.models.common import (cast_params, tree_flatten,
                                       tree_unflatten)
from repro_torch.models.model_api import Model
from repro_torch.optim.adamw import (AdamState, OptConfig, adamw_update,
                                     init_adam_state, opt_path_desc)


class TrainState(NamedTuple):
    params: Any                      # fp32 master weights
    opt: AdamState


#: block-linear roles summarized by :func:`train_path_summary`
_SUMMARY_ROLES = ("attn_qkv", "attn_out", "mlp_up", "mlp_down",
                  "ssm_in", "ssm_out")


def _path_desc(backend: str, caps, recipe=None) -> str:
    if backend == "fp":
        return "fp"
    if not caps:
        specs = [] if recipe is None else \
            [s for s in (recipe.acts, recipe.weights) if s is not None]
        compressed = [residual_compressible(s) for s in specs]
        res = ("int8" if specs and all(compressed)
               else "mixed" if any(compressed) else "fp")
        return f"fake_quant(fwd=qdq,bwd=qdq,res={res})"
    bwd = "int8" if "bwd" in caps else "qdq"
    return f"{backend}(fwd=int8,bwd={bwd},res=int8)"


def recompute_desc(cfg, batch: int, seq: int) -> str:
    """The ``remat=`` and ``attend=`` segments of
    :func:`train_path_summary`: what the loss recomputes (``layer+ce``
    under ``cfg.remat``, else the CE chunks alone) and how its attention
    runs on a (batch, seq) micro-batch (``flash``, ``dense``, or ``q<n>``:
    ``_attend`` in q-chunks of n rows)."""
    remat = "layer+ce" if cfg.remat else "ce"
    if cfg.attention_impl == "flash_pallas":
        attend = "flash"
    else:
        chunk = _pick_chunk(seq, seq, batch, cfg.n_heads)
        attend = "dense" if chunk == seq else f"q{chunk}"
    return f"remat={remat} attend={attend}"


def train_path_summary(recipe, n_layers: int = 0,
                       opt_cfg: Optional[OptConfig] = None,
                       device="cuda", cfg=None, batch: int = 0,
                       seq: int = 0) -> str:
    """One line naming the path each block-linear role's train step runs
    (effective backend after fallback, which passes run quantized kernels,
    the residual codec) and, with ``opt_cfg``, the optimizer's update path
    that ``adamw_update`` takes by default for params on ``device``.  The
    reference's format, so the two packages print the same line for the
    same policy (with ``int8_cuda`` for ``int8_pallas``); with ``cfg`` and
    a micro-batch of (``batch``, ``seq``) the port adds
    :func:`recompute_desc`."""
    policy = as_policy(recipe)
    groups: Dict[str, list] = {}
    for role in _SUMMARY_ROLES:
        if policy.depth_sensitive(role):
            if n_layers:
                desc = "/".join(sorted({_path_desc(
                    *policy.effective_backend(role, i, n_layers),
                    policy.resolve(role, i, n_layers).recipe)
                    for i in range(n_layers)}))
            else:
                desc = "depth-banded(pass n_layers)"
        else:
            desc = _path_desc(*policy.effective_backend(role),
                              policy.resolve(role).recipe)
        groups.setdefault(desc, []).append(role)
    summary = " ".join(f"{'+'.join(roles)}={desc}"
                       for desc, roles in groups.items())
    if opt_cfg is not None:
        summary += f" opt={opt_path_desc(policy, opt_cfg, device)}"
    if cfg is not None:
        summary += " " + recompute_desc(cfg, batch, seq)
    return summary


def init_train_state(model: Model, generator: Optional[torch.Generator],
                     recipe, opt_cfg: OptConfig,
                     device="cuda") -> TrainState:
    """Random float32 params (``Model.init_params``) and zero moments."""
    policy = as_policy(recipe)
    params = model.init_params(generator, device=device)
    return TrainState(params=params,
                      opt=init_adam_state(params, policy, opt_cfg))


def value_and_grad(model: Model, recipe, params, batch):
    """(loss, metrics, grads) of one batch: the train step's forward and
    backward, with the reference's bfloat16 cast of the fp32 master params
    in front of the model's own cast to ``cfg.dtype``."""
    policy = as_policy(recipe)
    leaves, struct = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    compute = cast_params(tree_unflatten(struct, leaves), torch.bfloat16)
    loss, metrics = model.train_loss(compute, batch, policy=policy)
    grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(struct, list(grads))


def _health_err_spec(policy: QuantPolicy):
    """Spec the ``grad_qerr`` drift counter measures against: the policy
    default's gradient spec when one exists (the codec the backward
    injects), else its activation spec, else nothing."""
    r = policy.default
    if r is None:
        return None
    return r.grads if r.grads is not None else r.acts


def make_train_step(model: Model, recipe, opt_cfg: OptConfig,
                    accum_steps: int = 1, faults=None, health: bool = False):
    """Gradient step with optional micro-batch accumulation (``accum_steps``
    > 1 splits the leading batch dim and averages the gradients).  The
    optimizer takes ``adamw_update``'s default path: the fused kernel on
    CUDA params where the moment codecs allow it.

    ``faults`` (a ``train.faults.FaultPlan``) poisons the gradients on its
    planned steps, keyed on ``state.opt.step`` on the device (no host
    sync; a multiply by 1.0, bit for bit a no-op, on every other step).
    ``health=True`` adds the sentinel's quantization-health counters to
    the metrics (``grad_sat``, ``grad_qerr``: see
    ``core.diagnostics.grad_quant_health``) -- one more pass over the
    gradient leaves."""
    policy = as_policy(recipe)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if accum_steps == 1:
            _, metrics, grads = value_and_grad(model, policy, state.params,
                                               batch)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            loss, acc = 0.0, None
            for i in range(accum_steps):
                l, _, g = value_and_grad(model, policy, state.params,
                                         {k: v[i] for k, v in micro.items()})
                leaves, struct = tree_flatten(g)
                acc = leaves if acc is None else [a + b for a, b in
                                                  zip(acc, leaves)]
                loss = loss + l
            grads = tree_unflatten(struct, [_div(g, float(accum_steps))
                                            for g in acc])
            loss = _div(loss, float(accum_steps))
            metrics = {"ce": loss, "loss": loss}
        if faults is not None and faults.has_grad_faults():
            grads = faults.apply_grads(state.opt.step, grads)
        metrics = dict(metrics)
        if health:
            metrics.update(grad_quant_health(
                grads, state.opt.m1, policy.adam_m1,
                _health_err_spec(policy), beta1=opt_cfg.b1))
        new_params, new_opt, stats = adamw_update(
            state.params, grads, state.opt, opt_cfg, policy)
        metrics.update(stats)
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_eval_step(model: Model, recipe):
    """``eval_step(params, batch) -> metrics`` without gradients."""
    policy = as_policy(recipe)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.train_loss(params, batch, policy=policy)
        return metrics
    return eval_step
