"""Mamba2 layer, state-space duality (port of ``repro/models/ssm.py``): the
chunked SSD for training and prefill, and a recurrent step for decode.

The paper's technique reaches the layer through its five linears -- the
input projection's four segments ``in_z``, ``in_x``, ``in_bc``, ``in_dt``
(role ``ssm_in``) and ``out_proj`` (``ssm_out``) -- which run through
``policy.linear`` and so on the int8 kernels under the W8A8 recipe.  The
scan's internals (A, dt, the conv, the state recurrence) are plain ops in
the reference (XLA) and plain torch here, in fp32 where the reference
computes in fp32: outside the paper's linear-layer scope.

Rounded where the reference rounds: the intra-chunk tensors ``decay``,
``cb`` and ``att`` in the carrier (the (B, nc, 128, 128, H) tensors are the
memory hot spot at training shapes), ``y_intra`` summed in fp32 from
carrier operands (``preferred_element_type=f32``), the chunk states, the
inter-chunk scan and the decode step's state in fp32.  The intra-chunk
products are laid out (B, nc, H, l, m) rather than the reference's (B,
nc, l, m, H), so that each is one batched matmul; the values are the
same, summed in another order.

The decode step returns a new state and leaves the one it is given as it
is, as the reference's functional step does (the engine commits the new
state only once the step has returned).

Reference: Dao & Gu, "Transformers are SSMs" (arXiv:2405.21060).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.qpolicy import LinearCtx, QuantPolicy
from repro_torch.models.common import rmsnorm

#: the SSD chunk length (a sequence whose length it does not divide runs as
#: one chunk, as in the reference's ``ssm_apply``)
CHUNK = 128

SSMState = Dict[str, torch.Tensor]


class SSMDims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    n_state: int
    n_groups: int
    conv_width: int
    conv_dim: int


def ssm_dims(cfg) -> SSMDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    g, n = 1, cfg.ssm_state
    return SSMDims(d_inner, d_inner // p, p, n, g, cfg.ssm_conv,
                   d_inner + 2 * g * n)


def ssm_spec(cfg) -> Dict[str, tuple]:
    """name -> (shape, init[, scale]) of one layer, the reference's
    ``ssm_spec``: the input projection split into its four segments (z, x,
    B and C, dt), each its own quantized linear.  ``out_proj`` carries the
    reference's scale 1 / n_layers, which its ``fan_in`` init does not
    read (``model_api._init_leaf``, as the reference's ``_init_leaf``)."""
    d = cfg.d_model
    dm = ssm_dims(cfg)
    gn = dm.n_groups * dm.n_state
    return {
        "in_z": ((d, dm.d_inner), "fan_in"),
        "in_x": ((d, dm.d_inner), "fan_in"),
        "in_bc": ((d, 2 * gn), "fan_in"),
        "in_dt": ((d, dm.n_heads), "fan_in"),
        "conv_w": ((dm.conv_width, dm.conv_dim), "fan_in"),
        "conv_b": ((dm.conv_dim,), "zeros"),
        "A_log": ((dm.n_heads,), "ones"),
        "dt_bias": ((dm.n_heads,), "zeros"),
        "D": ((dm.n_heads,), "ones"),
        "gate_norm": ((dm.d_inner,), "ones"),
        "out_proj": ((dm.d_inner, d), "fan_in", 1.0 / max(cfg.n_layers, 1)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``, op for op."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _in_projections(params, u: torch.Tensor, policy: QuantPolicy,
                    ctx: LinearCtx):
    """(z, xbc, dt_raw), xbc = concat(x, B, C) for the conv."""
    z = policy.linear(ctx, u, params["in_z"])
    x = policy.linear(ctx, u, params["in_x"])
    bc = policy.linear(ctx, u, params["in_bc"])
    dt_raw = policy.linear(ctx, u, params["in_dt"])
    return z, torch.cat([x, bc], dim=-1), dt_raw


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along the sequence.  xbc: (B, S, C); conv_w:
    (W, C); ``tail`` the (B, W - 1, C) left context (zeros when None).
    The W shifted products summed in fp32, SiLU, cast to xbc's dtype ->
    (out, new tail: the last W - 1 rows of tail + xbc, a fresh tensor)."""
    w = conv_w.shape[0]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], w - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
    padded = torch.cat([tail, xbc], dim=1)
    s = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(w):
        out = out + (padded[:, i:i + s].to(torch.float32)
                     * conv_w[i].to(torch.float32))
    out = F.silu(out + conv_b.to(torch.float32)).to(xbc.dtype)
    new_tail = padded[:, s:].clone() if w > 1 else tail
    return out, new_tail


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(..., G, N) -> (..., G * rep, N) in fp32: each group's row for each
    of its heads (the reference's ``jnp.repeat(..., rep, axis=-2)``)."""
    t = t.to(torch.float32)
    return t.unsqueeze(-2).expand(*t.shape[:-1], rep, t.shape[-1]).reshape(
        *t.shape[:-2], t.shape[-2] * rep, t.shape[-1])


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor,
                init_state: Optional[torch.Tensor] = None,
                chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Dao & Gu 2024, section 6).  x: (B, S, H, P); dt: (B, S,
    H), already through softplus; a: (H,), negative; bmat, cmat: (B, S, G,
    N) with G dividing H.  -> (y (B, S, H, P) in x's dtype, final state (B,
    H, N, P) fp32)."""
    b, s, h, p = x.shape
    n = bmat.shape[3]
    rep = h // bmat.shape[2]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    intra = x.dtype
    # (b, nc, h, l, ...) throughout: heads ahead of the chunk's rows
    xf = x.to(torch.float32).reshape(b, nc, chunk, h, p).transpose(2, 3)
    dtf = dt.to(torch.float32).reshape(b, nc, chunk, h).transpose(2, 3)
    bf = _heads(bmat, rep).reshape(b, nc, chunk, h, n).transpose(2, 3)
    cf = _heads(cmat, rep).reshape(b, nc, chunk, h, n).transpose(2, 3)

    cum = torch.cumsum(dtf * a[:, None], dim=-1)             # (b,nc,h,l)
    # intra-chunk: att[i, j] = exp(cum_i - cum_j) (C_i . B_j) dt_j, j <= i
    seg = cum[..., :, None] - cum[..., None, :]              # (b,nc,h,i,j)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    seg = torch.where(causal, seg, float("-inf"))
    decay = torch.exp(seg).to(intra)
    cb = torch.matmul(cf.to(intra), bf.to(intra).transpose(-1, -2))
    att = cb * decay * dtf[..., None, :].to(intra)
    y_intra = torch.matmul(att.to(torch.float32),
                           xf.to(intra).to(torch.float32))  # (b,nc,h,l,p)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    last = cum[..., -1:]                                     # (b,nc,h,1)
    wgt = torch.exp(last - cum) * dtf                        # (b,nc,h,l)
    states = torch.matmul((bf * wgt[..., None]).transpose(-1, -2), xf)
    chunk_decay = torch.exp(last[..., 0])                    # (b,nc,h)

    carry = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.to(torch.float32))
    prev = []
    for c in range(nc):                  # the reference's scan: emit PREV
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,n,p)

    # inter-chunk: y_i += (C_i . h_prev) exp(cum_i)
    y_inter = torch.matmul(cf, prev_states) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).transpose(2, 3).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  bmat: torch.Tensor, cmat: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None):
    """Sequential-scan oracle for tests: h_t = exp(dt a) h + dt B (x) x,
    y_t = C_t . h_t."""
    b, s, h, p = x.shape
    n = bmat.shape[3]
    rep = h // bmat.shape[2]
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    bf, cf = _heads(bmat, rep), _heads(cmat, rep)
    st = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.to(torch.float32))
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * a)                               # (b,h)
        upd = (dtf[:, t, :, None, None] * bf[:, t, :, :, None]
               * xf[:, t, :, None, :])
        st = st * da[:, :, None, None] + upd
        ys.append(torch.matmul(cf[:, t, :, None, :], st)[:, :, 0])
    return torch.stack(ys, dim=1).to(x.dtype), st


def _split_xbc(xbc: torch.Tensor, dm: SSMDims):
    di, gn = dm.d_inner, dm.n_groups * dm.n_state
    lead = xbc.shape[:-1]
    return (xbc[..., :di],
            xbc[..., di:di + gn].reshape(*lead, dm.n_groups, dm.n_state),
            xbc[..., di + gn:].reshape(*lead, dm.n_groups, dm.n_state))


def _gate_out(params, y: torch.Tensor, z: torch.Tensor, policy: QuantPolicy,
              layer: Optional[int], n_layers: int) -> torch.Tensor:
    """rmsnorm(y * silu(z)) through ``out_proj`` (role ``ssm_out``)."""
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype),
                params["gate_norm"])
    return policy.linear(LinearCtx("ssm_out", layer, n_layers), y,
                         params["out_proj"])


def ssm_apply(params, u: torch.Tensor, cfg, *, policy: QuantPolicy,
              state: Optional[SSMState] = None, return_state: bool = False,
              layer: Optional[int] = None, n_layers: int = 0):
    """The whole-sequence Mamba2 layer.  u: (B, S, d); ``state`` the carry
    {"ssm": (B, H, N, P) fp32, "conv": (B, W - 1, C)} to start from (None:
    zeros) -> (out (B, S, d), the new state under ``return_state``, else
    None)."""
    dm = ssm_dims(cfg)
    z, xbc, dt_raw = _in_projections(params, u, policy,
                                     LinearCtx("ssm_in", layer, n_layers))
    tail = state["conv"] if state is not None else None
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 tail)
    xs, bmat, cmat = _split_xbc(xbc, dm)
    dt = _softplus(dt_raw.to(torch.float32)
                   + params["dt_bias"].to(torch.float32))
    a = -torch.exp(params["A_log"].to(torch.float32))
    x4 = xs.reshape(*xs.shape[:2], dm.n_heads, dm.head_dim)
    s_len = u.shape[1]
    chunk = CHUNK if s_len % CHUNK == 0 else s_len
    y4, final = ssd_chunked(x4, dt, a, bmat, cmat,
                            init_state=None if state is None
                            else state["ssm"], chunk=chunk)
    y4 = y4 + (params["D"].to(torch.float32)[None, None, :, None]
               * x4.to(torch.float32)).to(y4.dtype)
    out = _gate_out(params, y4.reshape(*xs.shape[:2], dm.d_inner), z, policy,
                    layer, n_layers)
    return out, ({"ssm": final, "conv": new_tail} if return_state else None)


def ssm_decode_step(params, u: torch.Tensor, cfg, *, policy: QuantPolicy,
                    state: SSMState, layer: Optional[int] = None,
                    n_layers: int = 0):
    """One token's recurrent update, O(1) in the context.  u: (B, 1, d);
    ``state`` as in :func:`ssm_apply` (read, never written) -> (out (B, 1,
    d), the new state, fresh tensors)."""
    dm = ssm_dims(cfg)
    z, xbc, dt_raw = _in_projections(params, u, policy,
                                     LinearCtx("ssm_in", layer, n_layers))
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 state["conv"])
    xs, bmat, cmat = _split_xbc(xbc[:, 0], dm)
    rep = dm.n_heads // dm.n_groups
    bf, cf = _heads(bmat, rep), _heads(cmat, rep)                # (B,H,N)
    dt = _softplus(dt_raw[:, 0].to(torch.float32)
                   + params["dt_bias"].to(torch.float32))       # (B,H)
    a = -torch.exp(params["A_log"].to(torch.float32))
    da = torch.exp(dt * a)
    x3 = xs.reshape(-1, dm.n_heads, dm.head_dim).to(torch.float32)
    upd = dt[:, :, None, None] * bf[..., None] * x3[:, :, None, :]
    new_ssm = state["ssm"] * da[:, :, None, None] + upd
    y3 = torch.matmul(cf[:, :, None, :], new_ssm)[:, :, 0]      # (B,H,P)
    y3 = y3 + params["D"].to(torch.float32)[None, :, None] * x3
    y = y3.reshape(-1, 1, dm.d_inner).to(u.dtype)
    out = _gate_out(params, y, z, policy, layer, n_layers)
    return out, {"ssm": new_ssm, "conv": new_tail}


def init_ssm_state(cfg, batch: int, dtype: torch.dtype,
                   device="cpu") -> SSMState:
    """Zero states stacked over the layers: "ssm" (L, B, H, N, P) fp32 and
    "conv" (L, B, W - 1, C) in ``dtype``."""
    dm = ssm_dims(cfg)
    L = cfg.n_layers
    return {"ssm": torch.zeros((L, batch, dm.n_heads, dm.n_state,
                                dm.head_dim), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((L, batch, dm.conv_width - 1, dm.conv_dim),
                                dtype=dtype, device=device)}
