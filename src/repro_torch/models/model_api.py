"""Model facade of the port (counterpart of ``repro/models/model_api.py``):
``build_model(cfg)`` gives ``init_params``, ``train_loss``, ``prefill``,
``decode`` and ``init_decode_state`` for the dense decoder family: GPT-2
(learned positions, LayerNorm, classic MLP), llama (RoPE, RMSNorm, gated
MLP, grouped KV heads, untied head), gemma (the embedding scaled by
sqrt(d_model), RMSNorm with (1 + w), GeGLU, tied head) and qwen3 (RMSNorm
on q and k per head, qk-norm) -- and for the MoE family (granite,
phi-3.5-moe: the gated MLP replaced by top-k routed experts,
``models/moe.py``, in the reference's ``local`` mode) -- and for the SSM
family (mamba2: ``models/ssm.py``, no attention and no positions, its
decode state the per-layer SSM and conv states in place of KV caches) --
and for the hybrid family (zamba2: groups of Mamba2 layers, each followed
by one attention + MLP block whose weights are shared across the depth,
its decode state both the SSM states and a KV cache per invocation) --
and for the encoder-decoder family (seamless-m4t: ``models/encdec.py``,
its batches holding ``frames`` beside the tokens, its decode state the
fp self caches and the cross K/V its prefill computed once);
:func:`params_from_jax` carries a JAX parameter tree across, and
:func:`train_state_from_jax` / :func:`train_state_to_numpy` a whole train
state (params, step, Adam moments) both ways.

Parameters are nested dicts of tensors in the JAX tree layout: ``embed``
(V_padded, d), ``pos_embed`` (max_seq, d; learned positions only),
``blocks`` with every leaf stacked (L, ...) -- ``ln1``/``ln2`` {scale,
bias} (RMSNorm: {scale}), ``attn`` {wq, wk, wv, wo[, bq, bk, bv, bo][,
q_norm, k_norm (L, hd)]},
``mlp`` {w_fc1, w_fc2[, b_fc1, b_fc2]} (gated: {w_gate, w_up, w_down}) or,
under experts, ``moe`` {w_router (L, d, E), w_gate and w_up (L, E, d, ff),
w_down (L, E, ff, d)}; the SSM family's blocks are ``norm`` {scale} and
``ssm`` {in_z, in_x, in_bc, in_dt, conv_w, conv_b, A_log, dt_bias, D,
gate_norm, out_proj} (the hybrid's too) --
``final_norm`` as ``ln1``, ``lm_head`` (d, V_padded) when the head is
untied, and the hybrid's depth-less ``shared`` block over d2 = 2 * d:
``ln1`` and ``ln2`` over d2, ``attn`` and the gated ``mlp`` with inputs
d2 wide, and ``proj`` (d2, d).  The encoder-decoder's tree is the
reference's ``encdec_spec``: ``frame_proj`` (d, d), ``enc_blocks``
{ln1, attn, ln2, mlp} stacked (enc_layers, ...), ``enc_norm``, ``embed``,
``dec_blocks`` {ln1, self_attn, ln2, cross_attn, ln3, mlp} stacked (L,
...), ``final_norm`` and ``lm_head``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.qpolicy import as_policy
from repro_torch.models import encdec as ed
from repro_torch.models import lm
from repro_torch.models.common import Params
from repro_torch.models.moe import moe_spec
from repro_torch.models.ssm import ssm_spec

DeviceLike = Union[str, torch.device, None]


#: what the port takes: each field's ported values (GPT-2's, llama's,
#: gemma's and qwen3's; granite's and phi-3.5-moe's experts; mamba2's SSM
#: layers, which take no positions; zamba2's hybrid; seamless-m4t's
#: encoder-decoder)
SUPPORTED = {"family": ("dense", "moe", "ssm", "hybrid", "encdec"),
             "pos": ("learned", "rope", "none"),
             "norm": ("layernorm", "rmsnorm", "rmsnorm_p1"),
             "mlp_kind": ("classic", "gated"), "qk_norm": (False, True),
             "embed_scale": (False, True)}


def _check_supported(cfg: ArchConfig) -> None:
    """The dense, MoE, SSM, hybrid and encoder-decoder families only
    (experts exactly when the family is ``moe``, gated; the hybrid with a
    shared block every ``hybrid_attn_every`` > 0 layers, a whole number of
    groups, no experts; the encoder-decoder with ``enc_layers`` > 0, the
    ``audio_stub`` frontend, no learned positions, no experts and no SSM
    or hybrid fields): the VLM raises."""
    bad = {k: getattr(cfg, k) for k, v in SUPPORTED.items()
           if getattr(cfg, k) not in v}
    moe = cfg.family == "moe"
    if moe != (cfg.n_experts > 0) or (moe and cfg.mlp_kind != "gated"):
        bad.update(n_experts=cfg.n_experts, mlp_kind=cfg.mlp_kind)
    per = cfg.hybrid_attn_every
    if cfg.family == "hybrid" and (per <= 0 or cfg.n_layers % per):
        bad.update(hybrid_attn_every=per, n_layers=cfg.n_layers)
    if cfg.family == "encdec" and (
            cfg.enc_layers <= 0 or cfg.frontend != "audio_stub"
            or cfg.pos == "learned" or cfg.ssm_state or per):
        bad.update(enc_layers=cfg.enc_layers, frontend=cfg.frontend,
                   pos=cfg.pos, ssm_state=cfg.ssm_state,
                   hybrid_attn_every=per)
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} -- the port takes the dense, MoE, SSM, "
            f"hybrid and encoder-decoder families ({SUPPORTED}; experts "
            f"gated, and only under family='moe'; the hybrid's shared block "
            f"every hybrid_attn_every > 0 layers, which divides n_layers; "
            f"the encoder-decoder with enc_layers > 0 and the audio_stub "
            f"frontend, under RoPE or no positions) so far; the VLM waits "
            f"for ROADMAP section 1, item 6")


def _spec(cfg: ArchConfig) -> Dict[str, Any]:
    """name -> (shape, init[, std]) in the JAX tree layout; the init kinds
    and scales of ``repro.models`` (lm_spec, shared_block_spec, attn_spec,
    mlp_spec, moe_spec, ssm_spec, norm_spec)."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def norm(n):
        if cfg.norm == "rmsnorm":
            return {"scale": ((n,), "ones")}
        if cfg.norm == "rmsnorm_p1":       # stored as w - 1
            return {"scale": ((n,), "zeros")}
        return {"scale": ((n,), "ones"), "bias": ((n,), "zeros")}

    def attn(d_in):
        a = {"wq": ((d_in, h * hd), "fan_in"),
             "wk": ((d_in, k * hd), "fan_in"),
             "wv": ((d_in, k * hd), "fan_in"),
             "wo": ((h * hd, d_in), "fan_in")}
        if cfg.qk_norm:
            a.update({"q_norm": ((hd,), "ones"), "k_norm": ((hd,), "ones")})
        if cfg.use_bias:
            a.update({"bq": ((h * hd,), "zeros"), "bk": ((k * hd,), "zeros"),
                      "bv": ((k * hd,), "zeros"), "bo": ((d_in,), "zeros")})
        return a

    def mlp(d_in):
        if cfg.mlp_kind == "gated":
            m = {"w_gate": ((d_in, ff), "fan_in"),
                 "w_up": ((d_in, ff), "fan_in"),
                 "w_down": ((ff, d_in), "fan_in")}
            bias = {"b_gate": ((ff,), "zeros"), "b_up": ((ff,), "zeros"),
                    "b_down": ((d_in,), "zeros")}
        else:
            m = {"w_fc1": ((d_in, ff), "fan_in"),
                 "w_fc2": ((ff, d_in), "fan_in")}
            bias = {"b_fc1": ((ff,), "zeros"), "b_fc2": ((d_in,), "zeros")}
        if cfg.use_bias:
            m.update(bias)
        return m

    if cfg.family == "encdec":
        return _encdec_spec(cfg, norm(d), attn(d), mlp(d))
    blocks = {"ln1": norm(d), "attn": attn(d), "ln2": norm(d)}
    if cfg.family in ("ssm", "hybrid"):
        blocks = {"norm": norm(d), "ssm": ssm_spec(cfg)}
    elif cfg.n_experts:
        blocks["moe"] = moe_spec(cfg)
    else:
        blocks["mlp"] = mlp(d)
    blocks = _stacked(blocks, L)
    # init_params draws the leaves in this order
    spec = {"embed": ((cfg.vocab_padded, d), "normal", 0.02)}
    if cfg.pos == "learned":
        spec["pos_embed"] = ((cfg.max_seq, d), "normal", 0.01)
    spec.update(blocks=blocks, final_norm=norm(d))
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, cfg.vocab_padded), "fan_in")
    if cfg.family == "hybrid":
        # zamba2's shared block, not stacked: its fan_in leaves draw with
        # their true fan-in (the reference's rule reads shape[0])
        d2 = 2 * d
        spec["shared"] = {"ln1": norm(d2), "attn": attn(d2), "ln2": norm(d2),
                          "mlp": mlp(d2), "proj": ((d2, d), "fan_in")}
    return spec


def _stacked(blocks, n: int):
    """Block leaves with the stacked layer dim in front, as in the
    reference."""
    return {mod: {name: ((n,) + leaf[0],) + leaf[1:]
                  for name, leaf in leaves.items()}
            for mod, leaves in blocks.items()}


def _encdec_spec(cfg: ArchConfig, norm, attn, mlp) -> Dict[str, Any]:
    """The reference's ``encdec_spec``: ``frame_proj``, the encoder blocks
    (``ln1``, ``attn``, ``ln2``, ``mlp``) stacked over ``enc_layers``,
    ``enc_norm``, ``embed``, the decoder blocks (``ln1``, ``self_attn``,
    ``ln2``, ``cross_attn``, ``ln3``, ``mlp``) stacked over ``n_layers``,
    ``final_norm`` and the untied ``lm_head``."""
    d = cfg.d_model
    spec = {"frame_proj": ((d, d), "fan_in"),
            "enc_blocks": _stacked({"ln1": norm, "attn": attn, "ln2": norm,
                                    "mlp": mlp}, cfg.enc_layers),
            "enc_norm": norm,
            "embed": ((cfg.vocab_padded, d), "normal", 0.02),
            "dec_blocks": _stacked({"ln1": norm, "self_attn": attn,
                                    "ln2": norm, "cross_attn": attn,
                                    "ln3": norm, "mlp": mlp}, cfg.n_layers),
            "final_norm": norm}
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
    """The model's entry points (see module docstring); each dispatches on
    the family: ``lm`` for the decoder-only families, ``encdec`` for the
    encoder-decoder."""

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
        """-> (loss, metrics) of ``lm.lm_loss`` (``encdec.encdec_loss``,
        whose batch holds ``frames`` too); differentiable in params."""
        if self.cfg.family == "encdec":
            return ed.encdec_loss(params, batch, self.cfg, policy=policy)
        return lm.lm_loss(params, batch, self.cfg, policy=policy)

    def prefill(self, params: Params, batch, *, policy=None,
                max_seq: Optional[int] = None,
                last_pos: Optional[torch.Tensor] = None,
                segments: Optional[torch.Tensor] = None,
                kv_path: Optional[str] = None):
        """-> (logits, state).  The decoder-only families take ``batch`` as
        the prompt tokens (B, S) and return ``{"caches": ..., "ssm": ...}``
        (the SSM family's caches None, the others' SSM states None);
        ``last_pos``, ``segments`` and ``kv_path`` as in ``lm.lm_prefill``.
        The encoder-decoder takes the reference's batch ``{"frames",
        "tokens"}`` and returns ``{"self": ..., "cross": ...}``
        (``encdec.encdec_prefill``); the three options are decoder-only
        there and raise, as in the reference."""
        if self.cfg.family == "encdec":
            if last_pos is not None or segments is not None:
                raise NotImplementedError(
                    "last_pos / segments (bucketed-prompt prefill) is "
                    "decoder-only")
            if kv_path is not None:
                raise NotImplementedError("int8 KV cache is decoder-only")
            return ed.encdec_prefill(params, batch, self.cfg, policy=policy,
                                     max_seq=max_seq)
        logits, caches, ssm = lm.lm_prefill(params, batch, self.cfg,
                                            policy=policy, max_seq=max_seq,
                                            last_pos=last_pos,
                                            segments=segments,
                                            kv_path=kv_path)
        return logits, {"caches": caches, "ssm": ssm}

    def decode(self, params: Params, state, token: torch.Tensor,
               pos: torch.Tensor, *, policy=None,
               page_table: Optional[torch.Tensor] = None,
               kv_path: Optional[str] = None):
        """-> (logits (B, V_padded), state); the state's caches (dense
        strips, or page pools with ``page_table``) are updated in place,
        its SSM states are new tensors (those of ``state`` are left as they
        were); ``kv_path`` as in ``lm.lm_decode``.  The encoder-decoder
        (``encdec.encdec_decode``) writes its self caches in place and
        refuses ``page_table`` and ``kv_path``."""
        if self.cfg.family == "encdec":
            if page_table is not None:
                raise NotImplementedError("paged KV cache is decoder-only")
            if kv_path is not None:
                raise NotImplementedError("int8 KV cache is decoder-only")
            return ed.encdec_decode(params, state, token, pos, self.cfg,
                                    policy=policy)
        logits, caches, ssm = lm.lm_decode(
            params, state.get("caches"), token, pos, self.cfg, policy=policy,
            page_table=page_table, kv_path=kv_path,
            ssm_states=state.get("ssm"))
        return logits, {"caches": caches, "ssm": ssm}

    def init_decode_state(self, batch: int, max_seq: int, enc_len: int = 0,
                          dtype: Optional[torch.dtype] = None, policy=None,
                          device: DeviceLike = "cuda"):
        """``{"caches": ..., "ssm": ...}`` of ``lm.init_decode_caches``;
        the encoder-decoder's ``{"self": ..., "cross": ...}`` with
        ``enc_len`` cross rows (an int8 KV spec raises there, as in the
        reference)."""
        kv_spec = as_policy(policy).kv_spec()
        dtype = dtype or lm.carrier_dtype(self.cfg)
        device = resolve_device(device)
        if self.cfg.family == "encdec":
            if kv_spec is not None:
                raise NotImplementedError("int8 KV cache is decoder-only")
            return ed.init_state(self.cfg, batch, max_seq, enc_len, dtype,
                                 device=device)
        caches, ssm = lm.init_decode_caches(self.cfg, batch, max_seq, dtype,
                                            kv_spec=kv_spec, device=device)
        return {"caches": caches, "ssm": ssm}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


def enc_len_for(cfg: ArchConfig, seq: int) -> int:
    """Encoder frames of a ``seq``-token example: ``seq // frame_ratio``,
    at least 1 (the reference's)."""
    return max(seq // max(cfg.frame_ratio, 1), 1)


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


__all__ = ["Model", "build_model", "enc_len_for", "opt_state_from_jax",
           "params_from_jax",
           "train_state_from_jax", "train_state_to_numpy"]
