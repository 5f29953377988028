"""Shard-aware batch loader over a corpus (the port's copy of
``repro.data.loader`` for the token-only families).  State = {"step": int}:
restoring it resumes the exact data stream."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import SyntheticCorpus


@dataclasses.dataclass
class Loader:
    corpus: SyntheticCorpus
    cfg: ArchConfig
    batch_size: int                 # global batch
    seq_len: int
    dp_rank: int = 0
    dp_size: int = 1
    split: str = "train"
    step: int = 0

    def __post_init__(self):
        if self.cfg.family in ("vlm", "encdec"):
            raise NotImplementedError(
                f"{self.cfg.family} batches (patches / frames) are not "
                "ported yet (ROADMAP section 1, item 6)")

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

    def peek(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Batch for an arbitrary step (pure): {"tokens": (B, S + 1)}."""
        step = self.step if step is None else step
        toks = self.corpus.batch(step, self.dp_rank, self.dp_size,
                                 batch_size=self.batch_size // self.dp_size,
                                 seq_len=self.seq_len, split=self.split)
        return {"tokens": toks}

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.peek()
        self.step += 1
        return batch

    def __iter__(self):
        return self
