"""Mixture-of-Experts with capacity-based token dispatch (port of
``repro/models/moe.py`` in its ``local`` mode: no mesh, every expert on the
one device).

A token's router picks its top-k experts; each (token, expert) pair takes
the expert's next free row of a (E, C, d) buffer, first come first served
in row order, and a pair past the capacity C is dropped (its token keeps
the residual stream alone).  The experts' gated FFN runs on the whole
buffer at once -- the reference's ``jax.vmap`` over ``policy.linear`` --
and each token sums its kept pairs' outputs weighted by the renormalized
gates.  A Switch-style load-balance loss and the router z-loss come back
beside the output.

Matched to the reference where PyTorch differs from JAX:

* top-k: ``jax.lax.top_k`` puts the lower expert first on equal logits;
  ``torch.topk`` promises no order, so the top k are the first k of a
  stable descending sort;
* the combine ``y.at[token_idx].add(out_rows * w)`` runs on the CPU as
  sequential adds in index order, in the carrier (readings in
  ``tests/test_torch_moe.py``); a token's k pairs are contiguous, so it is
  k ordered adds here, bit for bit, and never a float ``index_add_``
  (atomics on the card);
* dropped pairs go to the dummy slot ``E * C``; that row is written and
  discarded, so the duplicate writes there are harmless.

The backward is the reference's transpose, and uses no float atomics (the
card's ``index_add_`` adds in no fixed order):

* the dispatch gather ``take(x2, token_idx)`` transposes into a
  scatter-add in index order in the carrier: a token's k cotangent rows
  are contiguous, so it is k ordered adds onto zeros, the combine's mirror
  (:class:`_TokenRows`);
* the gathers of the buffer's and the experts' rows by slot transpose into
  writes of one row each, since every kept slot is unique (the dummy
  slot's row is discarded; :class:`_SlotRows`, and ``index_put`` for the
  buffer);
* routing, slots and keep carry no gradient; the gates' gradient flows
  through the softmax of the top logits, and the aux and z losses add
  theirs to ``w_router`` (fp32).

A checkpointed MoE block recomputes its routes in the backward
(``models/lm.py``); :func:`route_check_contexts` records each router call's
experts in the forward and fails the recomputation if one differs.

The expert-parallel modes (``ep_alltoall``, ``ep_masked``,
``ff_sharded``) need a mesh and raise (ROADMAP section 1, item 8).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from repro_torch.core.qpolicy import LinearCtx, QuantPolicy, as_policy
from repro_torch.models.common import ACT_FNS

#: token-chunked dispatch above this many tokens (the reference's bound on
#: the (E * C, d) scatter buffers; capacity is per chunk)
MAX_DISPATCH_TOKENS = 16384


def moe_spec(cfg) -> Dict[str, tuple]:
    """name -> (shape, init) of one layer's expert leaves, the reference's
    ``moe_spec``.  Its ``w_down`` carries ``scale=1 / n_layers``, which its
    ``fan_in`` init never reads; so neither does the port's."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"w_router": ((d, e), "fan_in"),
            "w_gate": ((e, d, ff), "fan_in"),
            "w_up": ((e, d, ff), "fan_in"),
            "w_down": ((e, ff, d), "fan_in")}


def _route(x2: torch.Tensor, w_router: torch.Tensor, cfg,
           policy: QuantPolicy, ctx: LinearCtx, top_e=None):
    """Router in fp32 (role ``router``, fp by the default rules) -> (gates
    (T, k) renormalized over the top k, top_e (T, k), aux, z_loss).  A
    given ``top_e`` takes the place of the router's own choice (the gates
    then come from the logits at those experts): two devices can then
    dispatch alike where a near-tied logit would flip."""
    logits = policy.linear(ctx, x2.to(torch.float32),
                           w_router.to(torch.float32))        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if top_e is None:
        order = torch.sort(logits, dim=-1, descending=True, stable=True)
        top_logits = order.values[:, :cfg.top_k]
        top_e = order.indices[:, :cfg.top_k]
    else:
        top_logits = torch.gather(logits, 1, top_e)
    gates = torch.softmax(top_logits, dim=-1)
    # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e
    sel = torch.nn.functional.one_hot(top_e[:, 0], cfg.n_experts).to(
        torch.float32)
    aux = cfg.n_experts * torch.sum(torch.mean(sel, dim=0)
                                    * torch.mean(probs, dim=0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, top_e, aux, z_loss


def _dispatch_indices(top_e: torch.Tensor, n_experts: int, capacity: int,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Slots, first come first served by row: (slot (T*k,), keep (T*k,),
    token_idx (T*k,)); a dropped pair gets the dummy slot E * capacity."""
    t = top_e.shape[0]
    flat_e = top_e.reshape(-1)
    # the running count scans each expert's row of the (E, T*k) one-hot:
    # the card scans an innermost dim in one pass, an outer dim of T*k
    # rows in a loop over them (1.1 s of a Granite train step)
    onehot = (torch.arange(n_experts, device=flat_e.device)[:, None]
              == flat_e[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1) - 1                       # (E, T*k)
    mypos = torch.gather(pos, 0, flat_e[None, :])[0]
    keep = mypos < capacity
    slot = torch.where(keep, flat_e * capacity + mypos,
                       torch.full_like(flat_e, n_experts * capacity))
    token_idx = torch.arange(t, device=top_e.device).repeat_interleave(k)
    return slot, keep, token_idx


class _TokenRows(torch.autograd.Function):
    """x2 (T, d) -> (T * k, d), each token's row k times in a row (the
    reference's ``take(x2, repeat(arange(T), k))``).  Backward: each
    token's k cotangent rows added onto zeros one by one in index order,
    in the carrier -- the CPU's scatter-add of the reference's transpose,
    bit for bit."""

    @staticmethod
    def forward(ctx, x2, k):
        ctx.k = k
        return x2.repeat_interleave(k, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.reshape(-1, ctx.k, g.shape[-1])
        dx = torch.zeros_like(g[:, 0])
        for j in range(ctx.k):
            dx = dx + g[:, j]
        return dx, None


class _SlotRows(torch.autograd.Function):
    """src[idx] for a slot index whose entries are unique but for the
    dropped pairs' dummy slot.  Backward: each cotangent row written to its
    source row, no sum -- every kept slot is one pair's; the dummy row,
    which the caller discards, takes any of its pairs' rows."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.rows = src.shape[0]
        return src[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        out = g.new_zeros((ctx.rows, g.shape[-1]))
        out[idx] = g
        return out, None


#: the route log of the checkpointed MoE block running now: (mode, log,
#: position), mode "record" in its forward, "check" in its recomputation
_ROUTES: List[list] = []


@contextlib.contextmanager
def _route_mode(mode: str, log: list):
    _ROUTES.append([mode, log, 0])
    try:
        yield
    finally:
        _ROUTES.pop()


def route_check_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for a checkpointed MoE
    block: its forward records each router call's top experts, its
    recomputation compares its own against them in call order and raises
    on a difference (the backward would pair another route's slots with
    the forward's rows)."""
    log: list = []
    return _route_mode("record", log), _route_mode("check", log)


def _note_route(top_e: torch.Tensor, layer) -> None:
    if not _ROUTES:
        return
    state = _ROUTES[-1]
    mode, log, i = state
    if mode == "record":
        log.append(top_e)
        return
    state[2] = i + 1
    if i >= len(log) or not torch.equal(log[i], top_e):
        raise RuntimeError(
            f"moe layer {layer}: the recomputation routed router call {i} "
            f"otherwise than the forward did")


def _expert_ffn(buf: torch.Tensor, params, cfg, policy: QuantPolicy, layer,
                n_layers: int) -> torch.Tensor:
    """(E, C, d) -> (E, C, d): the gated FFN of every expert on its rows.
    ``policy.linear`` takes the (E, d, ff) weights whole: prepared int8
    weights run #3's expert-batched instance, one launch a projection; the
    per-expert scales of the reference's ``vmap`` are kept either way
    (``core/qpolicy.py``)."""
    act = ACT_FNS[cfg.act]
    up = LinearCtx("mlp_up", layer, n_layers)
    down = LinearCtx("mlp_down", layer, n_layers)
    g = policy.linear(up, buf, params["w_gate"])
    u = policy.linear(up, buf, params["w_up"])
    return policy.linear(down, act(g) * u, params["w_down"])


def _local_moe(x2: torch.Tensor, params, cfg, policy: QuantPolicy,
               capacity: int, layer, n_layers: int):
    """Capacity dispatch, the experts and the combine on one token set:
    x2 (T, d) -> (y (T, d), aux, z_loss)."""
    t, d = x2.shape
    e, k = cfg.n_experts, cfg.top_k
    gates, top_e, aux, z_loss = _route(x2, params["w_router"], cfg, policy,
                                       LinearCtx("router", layer, n_layers))
    _note_route(top_e, layer)
    slot, keep, _ = _dispatch_indices(top_e, e, capacity, k)
    buf = torch.zeros((e * capacity + 1, d), dtype=x2.dtype,
                      device=x2.device)
    buf[slot] = _TokenRows.apply(x2, k)
    h = _expert_ffn(buf[:e * capacity].reshape(e, capacity, d), params, cfg,
                    policy, layer, n_layers).reshape(e * capacity, -1)
    out_rows = _SlotRows.apply(torch.cat([h, h.new_zeros((1, h.shape[-1]))]),
                               slot)
    w = (gates.reshape(-1) * keep.to(torch.float32)).to(x2.dtype)
    contrib = (out_rows * w[:, None]).reshape(t, k, -1)
    y = torch.zeros((t, h.shape[-1]), dtype=x2.dtype, device=x2.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y, aux, z_loss


def _capacity(tokens: int, cfg) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(cap, cfg.top_k)


def dispatch_chunk(tokens: int) -> int:
    """The tokens of one dispatch: all of them up to
    ``MAX_DISPATCH_TOKENS``, else the largest halving of the bound that
    divides them (so a prefill of T tokens dispatches T / chunk times)."""
    if tokens <= MAX_DISPATCH_TOKENS:
        return tokens
    chunk = MAX_DISPATCH_TOKENS
    while tokens % chunk:
        chunk //= 2
    return chunk


def _local_moe_chunked(x2: torch.Tensor, params, cfg, policy: QuantPolicy,
                       layer, n_layers: int):
    """Above ``MAX_DISPATCH_TOKENS`` tokens, dispatch in equal chunks
    (:func:`dispatch_chunk`), each with its own capacity; aux and z are
    the chunks' means."""
    t, d = x2.shape
    chunk = dispatch_chunk(t)
    if chunk == t:
        return _local_moe(x2, params, cfg, policy, _capacity(t, cfg), layer,
                          n_layers)
    cap = _capacity(chunk, cfg)
    outs = [_local_moe(xc, params, cfg, policy, cap, layer, n_layers)
            for xc in x2.split(chunk)]
    ys, auxs, zs = zip(*outs)
    return (torch.cat(ys), torch.mean(torch.stack(auxs)),
            torch.mean(torch.stack(zs)))


def moe_apply(params, x: torch.Tensor, cfg, *, policy=None, rules=None,
              layer=None, n_layers: int = 0):
    """x (B, S, d) -> (y, aux_loss, z_loss), the reference's ``local``
    mode; a mesh's ``rules`` with more than one tensor rank raise."""
    if rules is not None and getattr(rules, "tp_size", 1) != 1:
        raise NotImplementedError(
            "moe_apply: the expert-parallel modes (ep_alltoall, ep_masked, "
            "ff_sharded) need a mesh, not ported yet (ROADMAP section 1, "
            "item 8)")
    policy = as_policy(policy)
    b, s, d = x.shape
    y, aux, z = _local_moe_chunked(x.reshape(-1, d), params, cfg, policy,
                                   layer, n_layers)
    return y.reshape(b, s, d), aux, z
