"""Model facade of the port (counterpart of ``repro/models/model_api.py``):
``build_model(cfg)`` gives ``init_params``, ``train_loss``, ``prefill``,
``decode`` and ``init_decode_state`` for the dense decoder families: GPT-2
(learned positions, LayerNorm, classic MLP) and llama (RoPE, RMSNorm,
gated MLP, grouped KV heads, untied head);
:func:`params_from_jax` carries a JAX parameter tree across, and
:func:`train_state_from_jax` / :func:`train_state_to_numpy` a whole train
state (params, step, Adam moments) both ways.

Parameters are nested dicts of tensors in the JAX tree layout: ``embed``
(V_padded, d), ``pos_embed`` (max_seq, d; learned positions only),
``blocks`` with every leaf stacked (L, ...) -- ``ln1``/``ln2`` {scale,
bias} (RMSNorm: {scale}), ``attn`` {wq, wk, wv, wo[, bq, bk, bv, bo]},
``mlp`` {w_fc1, w_fc2[, b_fc1, b_fc2]} (gated: {w_gate, w_up, w_down}) --
``final_norm`` as ``ln1``, and ``lm_head`` (d, V_padded) when the head is
untied.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.qpolicy import as_policy
from repro_torch.models import lm
from repro_torch.models.attention import init_caches
from repro_torch.models.common import Params

DeviceLike = Union[str, torch.device, None]


#: what the port's dense decoder takes: each field's ported values (GPT-2's
#: and llama's)
SUPPORTED = {"family": ("dense",), "pos": ("learned", "rope"),
             "norm": ("layernorm", "rmsnorm"),
             "mlp_kind": ("classic", "gated"), "qk_norm": (False,),
             "embed_scale": (False,), "n_experts": (0,)}


def _check_supported(cfg: ArchConfig) -> None:
    """The dense GPT-2 and llama families only: qk-norm (qwen3), gemma's
    embedding scale and plus-one RMSNorm, experts and the other families
    raise."""
    bad = {k: getattr(cfg, k) for k, v in SUPPORTED.items()
           if getattr(cfg, k) not in v}
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} -- the port takes the dense GPT-2 and llama "
            f"families ({SUPPORTED}) so far (ROADMAP section 1, item 6)")


def _spec(cfg: ArchConfig) -> Dict[str, Any]:
    """name -> (shape, init, std) in the JAX tree layout; the init kinds and
    scales of ``repro.models`` (lm_spec, attn_spec, mlp_spec, norm_spec)."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def norm(n):
        if cfg.norm == "rmsnorm":
            return {"scale": ((n,), "ones")}
        return {"scale": ((n,), "ones"), "bias": ((n,), "zeros")}

    attn = {"wq": ((d, h * hd), "fan_in"), "wk": ((d, k * hd), "fan_in"),
            "wv": ((d, k * hd), "fan_in"), "wo": ((h * hd, d), "fan_in")}
    if cfg.mlp_kind == "gated":
        mlp = {"w_gate": ((d, ff), "fan_in"), "w_up": ((d, ff), "fan_in"),
               "w_down": ((ff, d), "fan_in")}
        mlp_bias = {"b_gate": ((ff,), "zeros"), "b_up": ((ff,), "zeros"),
                    "b_down": ((d,), "zeros")}
    else:
        mlp = {"w_fc1": ((d, ff), "fan_in"), "w_fc2": ((ff, d), "fan_in")}
        mlp_bias = {"b_fc1": ((ff,), "zeros"), "b_fc2": ((d,), "zeros")}
    if cfg.use_bias:
        attn.update({"bq": ((h * hd,), "zeros"), "bk": ((k * hd,), "zeros"),
                     "bv": ((k * hd,), "zeros"), "bo": ((d,), "zeros")})
        mlp.update(mlp_bias)
    blocks = {"ln1": norm(d), "attn": attn, "ln2": norm(d), "mlp": mlp}
    # block leaves carry the stacked layer dim, as in the reference
    blocks = {mod: {n: ((L,) + shape, init) for n, (shape, init) in leaves.items()}
              for mod, leaves in blocks.items()}
    # init_params draws the leaves in this order
    spec = {"embed": ((cfg.vocab_padded, d), "normal", 0.02)}
    if cfg.pos == "learned":
        spec["pos_embed"] = ((cfg.max_seq, d), "normal", 0.01)
    spec.update(blocks=blocks, final_norm=norm(d))
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, cfg.vocab_padded), "fan_in")
    return spec


def _init_leaf(shape, init, std=0.02, *, generator, device):
    if init == "zeros":
        return torch.zeros(shape, device=device)
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "fan_in":
        # the reference's rule, kept as is: shape[0] for a matrix, which for
        # a layer-stacked (L, d_in, d_out) block weight is L (see ROADMAP)
        std = 1.0 / math.sqrt(shape[0] if len(shape) >= 2 else shape[-1])
    gdev = generator.device if generator is not None else "cpu"
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=gdev) * std
    return x.to(device)


class Model:
    """The dense decoder's entry points (see module docstring)."""

    def __init__(self, cfg: ArchConfig):
        _check_supported(cfg)
        self.cfg = cfg

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = "cuda") -> Params:
        """Random float32 parameters drawn from ``generator`` (on its own
        device) with the reference's init kinds and scales, placed on
        ``device``.  Parity tests carry JAX parameters across with
        :func:`params_from_jax` instead."""
        device = resolve_device(device)

        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            return _init_leaf(*node, generator=generator, device=device)
        return walk(_spec(self.cfg))

    def train_loss(self, params: Params, batch, *, policy=None):
        """-> (loss, metrics) of ``lm.lm_loss``; differentiable in params."""
        return lm.lm_loss(params, batch, self.cfg, policy=policy)

    def prefill(self, params: Params, tokens: torch.Tensor, *, policy=None,
                max_seq: Optional[int] = None,
                last_pos: Optional[torch.Tensor] = None,
                segments: Optional[torch.Tensor] = None):
        """-> (logits, state ``{"caches": ...}``); ``last_pos`` and
        ``segments`` as in ``lm.lm_prefill``."""
        logits, caches = lm.lm_prefill(params, tokens, self.cfg,
                                       policy=policy, max_seq=max_seq,
                                       last_pos=last_pos, segments=segments)
        return logits, {"caches": caches}

    def decode(self, params: Params, state, token: torch.Tensor,
               pos: torch.Tensor, *, policy=None,
               page_table: Optional[torch.Tensor] = None):
        """-> (logits (B, V_padded), state); the state's caches (dense
        strips, or page pools with ``page_table``) are updated in place."""
        logits, caches = lm.lm_decode(params, state["caches"], token, pos,
                                      self.cfg, policy=policy,
                                      page_table=page_table)
        return logits, {"caches": caches}

    def init_decode_state(self, batch: int, max_seq: int,
                          dtype: Optional[torch.dtype] = None, policy=None,
                          device: DeviceLike = "cuda"):
        kv_spec = as_policy(policy).kv_spec()
        dtype = dtype or lm.carrier_dtype(self.cfg)
        return {"caches": init_caches(self.cfg, batch, max_seq, dtype,
                                      kv_spec=kv_spec,
                                      device=resolve_device(device))}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


def params_from_jax(np_tree: Dict[str, Any], cfg: ArchConfig,
                    device: DeviceLike = "cuda") -> Params:
    """A JAX parameter tree, with every leaf converted to a numpy array
    (``jax.tree_util.tree_map(np.asarray, params)``), as torch tensors on
    ``device``.  The layouts are the same, so this is a leaf-for-leaf copy;
    leaves of dtypes numpy cannot hand to torch (bfloat16) go through
    float32, which is exact."""
    device = resolve_device(device)
    expected = _spec(cfg)

    def conv(x):
        return _to_torch(x, device)

    def walk(node, spec, path):
        if set(node) != set(spec):
            raise ValueError(f"params_from_jax: keys at {path or '<root>'} "
                             f"{sorted(node)} vs {sorted(spec)}")
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, spec[k], f"{path}.{k}")
            else:
                out[k] = conv(v)
                if tuple(out[k].shape) != tuple(spec[k][0]):
                    raise ValueError(f"params_from_jax: {path}.{k} shape "
                                     f"{tuple(out[k].shape)} vs {spec[k][0]}")
        return out
    return walk(np_tree, expected, "")


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16
                                                        ).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map_moments(tree, fn):
    """Map ``fn`` over a moment tree whose leaves are arrays or 3-tuples
    (q, scale, zero) -- QState in either package."""
    if isinstance(tree, dict):
        return {k: _map_moments(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        from repro_torch.core.qadam import QState
        return QState(*(fn(t) for t in tree))
    return fn(tree)


def train_state_from_jax(np_state, cfg: ArchConfig,
                         device: DeviceLike = "cuda"):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree_util.tree_map(
    np.asarray, state)``: ``.params`` and ``.opt`` with ``.step``, ``.m1``
    and ``.m2``; QState moments as (q, scale, zero)) as the port's
    ``train.step.TrainState`` on ``device``."""
    from repro_torch.train.step import TrainState
    return TrainState(
        params=params_from_jax(np_state.params, cfg, device=device),
        opt=opt_state_from_jax(np_state.opt, device=device))


def opt_state_from_jax(np_opt, device: DeviceLike = "cuda"):
    """A JAX ``AdamState`` with numpy leaves (``.step``, ``.m1``, ``.m2``;
    QState moments as (q, scale, zero)) as the port's, on ``device``."""
    from repro_torch.optim.adamw import AdamState
    device = resolve_device(device)

    def conv(x):
        return _to_torch(x, device)
    return AdamState(step=conv(np_opt.step).to(torch.int32),
                     m1=_map_moments(np_opt.m1, conv),
                     m2=_map_moments(np_opt.m2, conv))


def train_state_to_numpy(state):
    """The port's ``TrainState`` with numpy leaves (QState moments as
    (q, scale, zero)): the inverse of :func:`train_state_from_jax`, and
    the layout of the JAX state converted the same way."""
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import AdamState
    from repro_torch.train.step import TrainState

    def conv(t):
        return t.detach().cpu().numpy()
    opt = state.opt
    return TrainState(
        params=tree_map(conv, state.params),
        opt=AdamState(step=conv(opt.step), m1=_map_moments(opt.m1, conv),
                      m2=_map_moments(opt.m2, conv)))


__all__ = ["Model", "build_model", "opt_state_from_jax", "params_from_jax",
           "train_state_from_jax", "train_state_to_numpy"]
