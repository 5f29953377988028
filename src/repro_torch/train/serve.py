"""Batched greedy serving (port of ``repro/train/serve.py``).

:func:`greedy_generate` routes a decoder-only family (``infer.
ENGINE_FAMILIES``) with a tokens-only batch to the inference engine
(prepared weights, per-slot positions, admit-on-free scheduling), and
everything else -- the encoder-decoder, whose batch carries ``frames`` --
to :func:`greedy_generate_reference`: one prefill, then a fixed budget of
decode steps, as the reference's loop.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.common import tree_map


def greedy_generate(model, params, batch: Dict, max_new_tokens: int, *,
                    policy=None, eos_id: Optional[int] = None,
                    max_seq: Optional[int] = None,
                    device="cuda") -> np.ndarray:
    """(B, max_new_tokens) int32 generations of ``batch`` (``{"tokens": (B,
    S)[, "frames": (B, S_enc, d)]}``, numpy arrays or tensors) on
    ``device``.  ``policy`` is anything ``as_policy`` accepts.  Decoder-only
    families with a tokens-only batch run the engine
    (``infer.Engine.generate``); the rest run
    :func:`greedy_generate_reference`."""
    from repro_torch.infer import ENGINE_FAMILIES, Engine
    b, s = batch["tokens"].shape
    total = max_seq or (s + max_new_tokens)
    if model.cfg.family in ENGINE_FAMILIES and set(batch) == {"tokens"}:
        prompt = batch["tokens"]
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.cpu().numpy()
        eng = Engine(model, params, policy, max_slots=b, max_seq=total,
                     device=device)
        return eng.generate(prompt, max_new_tokens, eos_id=eos_id)
    return greedy_generate_reference(model, params, batch, max_new_tokens,
                                     policy=policy, eos_id=eos_id,
                                     max_seq=max_seq, device=device)


def _on_device(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device)


def greedy_generate_reference(model, params, batch: Dict,
                              max_new_tokens: int, *, policy=None,
                              eos_id: Optional[int] = None,
                              max_seq: Optional[int] = None,
                              device="cuda") -> np.ndarray:
    """The scheduler-free loop: prefill into ``max_seq`` rows (default S +
    ``max_new_tokens``), the first token from its logits, then
    ``max_new_tokens`` decode steps at positions S, S + 1, ....  Every
    emitted token -- the first too -- passes the eos done-mask before it is
    emitted: once a row emits ``eos_id``, every later token of it is
    ``eos_id``.  Greedy: the first of the largest logits."""
    device = resolve_device(device)
    batch = {k: _on_device(v, device) for k, v in batch.items()}
    params = tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                      else t, params)
    b, s = batch["tokens"].shape
    total = max_seq or (s + max_new_tokens)
    out = torch.empty((b, max_new_tokens), dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, state = model.prefill(params, batch, policy=policy,
                                      max_seq=total)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        done = torch.zeros((b,), dtype=torch.bool, device=device)
        for i in range(max_new_tokens):
            # the done mask is consulted BEFORE emitting (the first token too)
            if eos_id is not None:
                tok = torch.where(done[:, None], torch.full_like(tok, eos_id),
                                  tok)
                done = done | (tok[:, 0] == eos_id)
            out[:, i] = tok[:, 0]
            pos = torch.full((b,), s + i, dtype=torch.int32, device=device)
            logits, state = model.decode(params, state, tok, pos,
                                         policy=policy)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return out.cpu().numpy()
