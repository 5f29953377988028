"""Token sampling shared by every request in an engine batch (port of
``repro/infer/sampling.py``): greedy when ``temperature == 0``, otherwise
temperature-scaled categorical with optional top-k and nucleus (top-p)
truncation, drawn from an explicit ``torch.Generator``.  The draws differ
from ``jax.random``'s; the greedy path is identical."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy (argmax; top_k / top_p ignored).
    top_k == 0 and top_p == 1.0 disable their truncations."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _NEG)


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the smallest prefix of descending-probability tokens whose
    cumulative mass reaches ``p`` (the top-1 token always survives)."""
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    keep = (probs.cumsum(dim=-1) - probs) < p
    kth = torch.where(keep, desc, torch.full_like(desc, float("inf"))
                      ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < kth, _NEG)


def sample(logits: torch.Tensor, sp: SamplingParams,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32 next tokens (on the logits' device)."""
    if sp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.to(torch.float32) / sp.temperature
    if sp.top_k:
        lg = _top_k_mask(lg, min(sp.top_k, lg.shape[-1]))
    if sp.top_p < 1.0:
        lg = _top_p_mask(lg, sp.top_p)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
