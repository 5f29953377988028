"""Deterministic synthetic corpus (OpenWebText stand-in), the port's own
copy of ``repro.data.synthetic``: numpy only, so the same seed gives the
same tokens in both packages.

A mixture of order-2 Markov sources with shared sparse transition structure
plus periodic copy spans.  Properties that matter for the study:

* learnable: entropy well below ln(V), so validation-loss orderings between
  quantization schemes are meaningful;
* deterministic & shardable: ``batch(step, dp_rank, dp_size)`` is a pure
  function of (seed, step, rank) -- any pod can recompute any shard after a
  failure without coordination (fault-tolerance primitive);
* checkpoint-free: loader state is just the step counter.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 1234
    branching: int = 4          # candidate next-tokens per bigram state
    copy_period: int = 64       # every copy_period tokens, repeat a span
    copy_len: int = 16

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v, k = self.vocab_size, self.branching
        # sparse bigram transition table: (V, K) successors + logits
        self.succ = rng.randint(0, v, size=(v, k)).astype(np.int32)
        logits = rng.randn(v, k).astype(np.float64) * 1.5
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.probs = (p / p.sum(axis=1, keepdims=True)).astype(np.float64)
        self.cum = np.cumsum(self.probs, axis=1)

    def _gen(self, rng: np.random.RandomState, batch: int, length: int
             ) -> np.ndarray:
        out = np.empty((batch, length), np.int32)
        cur = rng.randint(0, self.vocab_size, size=batch).astype(np.int32)
        u = rng.random_sample((batch, length))
        for t in range(length):
            idx = (u[:, t, None] < self.cum[cur]).argmax(axis=1)
            cur = self.succ[cur, idx]
            out[:, t] = cur
        # copy spans: repeat the previous copy_len tokens periodically
        # (gives the model a long-range structure to learn)
        for start in range(self.copy_period, length - self.copy_len,
                           self.copy_period):
            out[:, start:start + self.copy_len] = \
                out[:, start - self.copy_len:start]
        return out

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1, *,
              batch_size: int, seq_len: int, split: str = "train"
              ) -> np.ndarray:
        """(batch_size, seq_len + 1) int32 tokens for this rank at this step.
        ``split='valid'`` draws from a disjoint seed stream."""
        tag = {"train": 0, "valid": 1 << 30}[split]
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + tag + step * 977 + dp_rank) % (2 ** 31))
        return self._gen(rng, batch_size, seq_len + 1)

    def entropy_floor(self, n: int = 8192) -> float:
        """Monte-Carlo estimate of the per-token entropy of the Markov part
        (the achievable CE floor, ignoring copy spans)."""
        ent = -np.sum(self.probs * np.log(self.probs), axis=1)
        rng = np.random.RandomState(0)
        seq = self._gen(rng, 1, n)[0]
        return float(ent[seq].mean())
