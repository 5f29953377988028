"""Training stability sentinel: anomaly detection + the recovery ladder
(port of ``repro.train.sentinel``: pure Python, the same rules and
ladder, so both packages give the same verdicts on the same metrics).

The paper's central finding is that quantized pre-training fails as a
*stability* problem -- the loss diverges when gradients / optimizer states
stop being representable, not gradually but in spikes (Fig. 10/12).  The
:class:`StabilitySentinel` watches every step's host-side metrics and turns
"the run is dying" into a deterministic recovery action:

detection (cheap, rolling-window, all host-side):

* non-finite loss or global grad norm (NaN/inf guards);
* loss spike: ``loss > mean + spike_sigma * std`` over the last ``window``
  *healthy* steps (a floor keeps flat curves from hair-triggering);
* grad-norm spike: ``grad_norm > grad_factor * rolling median``;
* int8 overflow pressure: the train step's ``grad_sat`` counter (candidate
  first-moment mass outgrowing the stored Adam-moment scales,
  ``core.diagnostics.moment_saturation_rate``) above ``sat_threshold`` AND
  ``sat_factor``x its own rolling median -- the rate has a benign ambient
  level while the moment EMA warms up, so only a *step change* on top of
  the absolute floor is a spike (sustained pressure self-baselines here
  but keeps showing in the loss / grad-norm rules);
* quant-error drift: ``grad_qerr`` (relative quantization error of the
  gradient) jumping ``qerr_factor``x over its rolling median.

recovery ladder (escalating, driven by the Trainer):

1. **skip-batch** -- the poisoned update is discarded (the trainer keeps the
   pre-step state; the batch is consumed).  First line of defense: a single
   bad batch or a transient overflow costs one step of data.
2. **rollback** -- more than ``skip_limit`` spikes inside one window means
   the *state* is bad, not the batch: the trainer restores the newest intact
   checkpoint (``CheckpointManager.restore_latest`` falls back through the
   rotation past corrupt ones) and rewinds the loop.
3. **fp-fallback window** -- a rollback arms a step-indexed policy override:
   for the next ``fallback_steps`` steps the trainer runs the step built
   from ``core.qpolicy.fallback_policy`` (same optimization problem, real-
   int8 kernels off -- or fully fp), then re-engages the quantized path.
   This is the continual-QAT transition of Nielsen et al. used as a
   recovery action.  While the window is open further spikes only skip
   (rollback thrash is worse than losing a few batches).

The ladder is bounded: after ``max_rollbacks`` rollbacks the sentinel stops
escalating (skips only) and flags ``exhausted`` in :meth:`summary` -- a run
that cannot be saved should surface in monitoring, not loop forever.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from collections import deque
from typing import Deque, Dict, List, Optional


class Verdict(enum.Enum):
    OK = "ok"
    SKIP = "skip"
    ROLLBACK = "rollback"


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    window: int = 32            # rolling-stat window (healthy steps)
    min_history: int = 8        # observations before spike detection arms
    spike_sigma: float = 6.0    # loss deviation threshold (in rolling stds)
    spike_floor: float = 0.5    # absolute loss-jump floor (std can be ~0)
    grad_factor: float = 10.0   # grad_norm vs rolling median
    sat_threshold: float = 0.25  # int8 moment-saturation-rate floor
    sat_factor: float = 2.0     # grad_sat vs its rolling median
    qerr_factor: float = 4.0    # grad_qerr vs rolling median
    skip_limit: int = 2         # spikes skipped per window before rollback
    fallback_steps: int = 16    # fp/fake window length after a rollback
    max_rollbacks: int = 3      # escalation budget for the whole run


def _finite(x: Optional[float]) -> bool:
    return x is not None and math.isfinite(x)


def _median(xs) -> float:
    ys = sorted(xs)
    return ys[len(ys) // 2]


class StabilitySentinel:
    """See module docstring.  One instance per training run; not thread-safe
    (the train loop is single-threaded)."""

    #: metric keys consulted, in order of preference, for the loss signal
    LOSS_KEYS = ("loss", "ce")

    def __init__(self, cfg: Optional[SentinelConfig] = None):
        self.cfg = cfg or SentinelConfig()
        self._loss: Deque[float] = deque(maxlen=self.cfg.window)
        self._gnorm: Deque[float] = deque(maxlen=self.cfg.window)
        self._qerr: Deque[float] = deque(maxlen=self.cfg.window)
        # sat is ambient pressure, recorded on EVERY finite observation
        # (healthy or not) so its median baselines warm-up levels and a
        # flagged-but-persistent plateau cannot starve its own window
        self._sat: Deque[float] = deque(maxlen=self.cfg.window)
        self._spike_steps: List[int] = []       # recent spikes (pruned)
        self.fallback_until = -1                # exclusive step bound
        self.rollbacks = 0
        self.exhausted = False
        self.last_reasons: List[str] = []
        self.counts: Dict[str, int] = {
            "observed": 0, "spikes": 0, "skips": 0, "rollbacks": 0,
            "fallback_windows": 0, "fallback_steps_run": 0}
        self.spike_reasons: Dict[str, int] = {}

    # -- detection ---------------------------------------------------------

    def _spike_reasons(self, metrics: Dict[str, float]) -> List[str]:
        cfg = self.cfg
        loss = next((metrics[k] for k in self.LOSS_KEYS if k in metrics),
                    None)
        gnorm = metrics.get("grad_norm")
        reasons = []
        if loss is not None and not _finite(loss):
            reasons.append("nonfinite-loss")
        if gnorm is not None and not _finite(gnorm):
            reasons.append("nonfinite-grad")
        if reasons:
            return reasons                       # NaN outranks everything
        if _finite(loss) and len(self._loss) >= cfg.min_history:
            mean = sum(self._loss) / len(self._loss)
            var = sum((x - mean) ** 2 for x in self._loss) / len(self._loss)
            band = max(cfg.spike_sigma * math.sqrt(var), cfg.spike_floor)
            if loss > mean + band:
                reasons.append("loss-spike")
        if _finite(gnorm) and len(self._gnorm) >= cfg.min_history:
            if gnorm > cfg.grad_factor * max(_median(self._gnorm), 1e-12):
                reasons.append("grad-norm-spike")
        sat = metrics.get("grad_sat")
        if sat is not None:
            if not _finite(sat):
                reasons.append("moment-saturation")
            else:
                armed = len(self._sat) >= cfg.min_history
                if (armed and sat > cfg.sat_threshold
                        and sat > cfg.sat_factor
                        * max(_median(self._sat), 1e-12)):
                    reasons.append("moment-saturation")
                self._sat.append(sat)
        qerr = metrics.get("grad_qerr")
        if qerr is not None:
            if not _finite(qerr):
                reasons.append("qerr-nonfinite")
            elif (len(self._qerr) >= cfg.min_history
                    and qerr > cfg.qerr_factor
                    * max(_median(self._qerr), 1e-12)):
                reasons.append("qerr-drift")
        return reasons

    # -- the ladder --------------------------------------------------------

    def observe(self, step: int, metrics: Dict[str, float]) -> Verdict:
        """Judge one completed (but not yet applied) train step.  ``OK``
        commits the update; ``SKIP`` discards it; ``ROLLBACK`` asks the
        trainer to restore the newest intact checkpoint and rewind (the
        sentinel arms the fallback window as a side effect)."""
        self.counts["observed"] += 1
        in_fb = self.in_fallback(step)
        if in_fb:
            self.counts["fallback_steps_run"] += 1
        reasons = self._spike_reasons(metrics)
        self.last_reasons = reasons
        if not reasons:
            self._record_healthy(metrics)
            return Verdict.OK
        self.counts["spikes"] += 1
        for r in reasons:
            self.spike_reasons[r] = self.spike_reasons.get(r, 0) + 1
        self._spike_steps = [s for s in self._spike_steps
                             if step - s < self.cfg.window]
        self._spike_steps.append(step)
        escalate = len(self._spike_steps) > self.cfg.skip_limit
        if escalate and not in_fb and not self.exhausted:
            if self.rollbacks >= self.cfg.max_rollbacks:
                self.exhausted = True           # stop escalating; skip only
            else:
                self.rollbacks += 1
                self.counts["rollbacks"] += 1
                self.counts["fallback_windows"] += 1
                self.fallback_until = step + self.cfg.fallback_steps
                self._spike_steps.clear()
                return Verdict.ROLLBACK
        self.counts["skips"] += 1
        return Verdict.SKIP

    def _record_healthy(self, metrics: Dict[str, float]) -> None:
        loss = next((metrics[k] for k in self.LOSS_KEYS if k in metrics),
                    None)
        if _finite(loss):
            self._loss.append(loss)
        gnorm = metrics.get("grad_norm")
        if _finite(gnorm):
            self._gnorm.append(gnorm)
        qerr = metrics.get("grad_qerr")
        if _finite(qerr):
            self._qerr.append(qerr)

    def in_fallback(self, step: int) -> bool:
        """Is the step-indexed fallback override active for ``step``?  The
        trainer consults this to pick the fallback train step;
        past the bound the primary (int8) path re-engages automatically."""
        return step < self.fallback_until

    def notify_rollback(self, restored_step: int) -> None:
        """The trainer rewound to ``restored_step``: the fallback window
        must cover the whole replayed region plus the configured margin."""
        self.fallback_until = max(self.fallback_until,
                                  restored_step + self.cfg.fallback_steps)

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        return {**self.counts,
                "spike_reasons": dict(self.spike_reasons),
                "fallback_until": self.fallback_until,
                "exhausted": self.exhausted}
