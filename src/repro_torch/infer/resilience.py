"""Serving-side health monitor: the engine's view of its own step stream
(port of ``repro/infer/resilience.py``).

An :class:`EngineMonitor` is attached to every
:class:`~repro_torch.infer.engine.Engine` and records, per decode step:

* **step latency** over a rolling window -- it feeds the scheduler's
  retry-after hints, its deadline-aware shed estimate and the
  ``slow_step`` counter;
* **numeric quarantines** -- a running request whose logits row went
  non-finite was evicted (finish reason ``"numerics"``); ``numeric_limit``
  of them inside ``numeric_window`` steps demote the engine one rung down
  its ladder (fused -> dequantize-on-read -> fp);
* **kernel errors** -- a decode-step exception the ladder absorbed;
* **demotions and promotions** -- every ladder transition with its step
  and reason, so a scripted fault plan's walk can be checked exactly;
* a **healthy streak** -- consecutive clean steps; at ``reprobe_after`` a
  degraded engine re-probes one rung up.

Pure host bookkeeping: nothing here touches a tensor.
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
    """Knobs of the serving degradation ladder.

    ``numeric_limit`` quarantines inside any ``numeric_window``-step span
    (since the last transition) demote the engine one rung; after
    ``reprobe_after`` consecutive healthy steps a degraded engine re-probes
    one rung up.  ``slow_step_ms`` (optional) only counts outliers: a slow
    step is a signal, not a demotion trigger.  ``latency_window`` decode
    steps feed the rolling latency."""
    latency_window: int = 256
    numeric_window: int = 8
    numeric_limit: int = 2
    reprobe_after: int = 12
    slow_step_ms: Optional[float] = None


class EngineMonitor:
    def __init__(self, cfg: Optional[MonitorConfig] = None):
        self.cfg = cfg or MonitorConfig()
        self._lat_ms: Deque[float] = deque(maxlen=self.cfg.latency_window)
        self._quarantine_steps: List[int] = []
        self.demotions: List[Dict[str, object]] = []
        self.promotions: List[Dict[str, object]] = []
        self.quarantined = 0
        self.kernel_errors = 0
        self.slow_steps = 0
        self.healthy_streak = 0
        self._last_transition_step = -1

    # -- recording (engine internals, scheduler thread) --------------------

    def record_step(self, ms: float) -> None:
        self._lat_ms.append(float(ms))
        self.healthy_streak += 1
        if self.cfg.slow_step_ms is not None and ms > self.cfg.slow_step_ms:
            self.slow_steps += 1

    def record_quarantine(self, step: int) -> None:
        self.quarantined += 1
        self.healthy_streak = 0
        self._quarantine_steps.append(int(step))

    def record_kernel_error(self, step: int) -> None:
        self.kernel_errors += 1
        self.healthy_streak = 0

    def record_demotion(self, step: int, frm: str, to: str,
                        why: str) -> None:
        self.demotions.append({"step": int(step), "from": frm, "to": to,
                               "why": why})
        self.healthy_streak = 0
        self._last_transition_step = int(step)

    def record_promotion(self, step: int, frm: str, to: str) -> None:
        self.promotions.append({"step": int(step), "from": frm, "to": to})
        # the re-engaged rung earns its own streak before probing higher
        self.healthy_streak = 0
        self._last_transition_step = int(step)

    # -- judgments ---------------------------------------------------------

    def should_demote(self, step: int) -> bool:
        """``numeric_limit`` quarantines within the trailing
        ``numeric_window`` steps, all after the last ladder transition."""
        lo = max(int(step) - self.cfg.numeric_window,
                 self._last_transition_step)
        recent = [s for s in self._quarantine_steps if s > lo or s == step]
        return len(recent) >= self.cfg.numeric_limit

    def should_reprobe(self) -> bool:
        return self.healthy_streak >= self.cfg.reprobe_after

    # -- metrics -----------------------------------------------------------

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
        return {"quarantined": self.quarantined,
                "kernel_errors": self.kernel_errors,
                "slow_steps": self.slow_steps,
                "healthy_streak": self.healthy_streak,
                "demotions": [dict(d) for d in self.demotions],
                "promotions": [dict(p) for p in self.promotions],
                "step_ms": self.step_ms()}


__all__ = ["EngineMonitor", "MonitorConfig"]
