"""Serving-side step statistics (port of the host bookkeeping of
``repro/infer/resilience.py``).

An :class:`EngineMonitor` is attached to every
:class:`~repro_torch.infer.engine.Engine` and records, per decode step:

* **step latency** over a rolling window -- it feeds the scheduler's
  retry-after hints and its deadline-aware shed estimate;
* **numeric quarantines** -- a running request whose logits row went
  non-finite was evicted (finish reason ``"numerics"``).

The reference also drives its fused -> dequant -> fp degradation ladder
from these records; the port has no ladder (a kernel exception
propagates), so nothing here demotes or promotes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    if not xs:
        return float("nan")
    ys = sorted(xs)
    return ys[min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))]


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """``latency_window`` decode steps feed the rolling latency."""
    latency_window: int = 256


class EngineMonitor:
    def __init__(self, cfg: Optional[MonitorConfig] = None):
        self.cfg = cfg or MonitorConfig()
        self._lat_ms: Deque[float] = deque(maxlen=self.cfg.latency_window)
        self.quarantined = 0

    def record_step(self, ms: float) -> None:
        self._lat_ms.append(float(ms))

    def record_quarantine(self) -> None:
        self.quarantined += 1

    def mean_step_s(self) -> Optional[float]:
        """Rolling mean decode-step seconds; None before any step ran (the
        scheduler's shed estimate does not guess without history)."""
        if not self._lat_ms:
            return None
        return sum(self._lat_ms) / len(self._lat_ms) / 1e3

    def step_ms(self) -> Dict[str, float]:
        xs = list(self._lat_ms)
        return {"n": len(xs), "p50": percentile(xs, 50),
                "p99": percentile(xs, 99),
                "mean": (sum(xs) / len(xs)) if xs else float("nan")}

    def summary(self) -> Dict[str, object]:
        return {"quarantined": self.quarantined, "step_ms": self.step_ms()}


__all__ = ["EngineMonitor", "MonitorConfig"]
