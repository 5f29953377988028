"""Training loop with fault tolerance (port of ``repro.train.loop``):

* periodic and preemption-triggered checkpoints (SIGTERM -> save and exit);
* resume from the newest intact checkpoint (params, optimizer, loader
  state) -- restore falls back through the rotation past corrupt or
  half-written checkpoints;
* a step-keyed data stream, so restarts replay it exactly;
* periodic validation on a disjoint split;
* guarded stepping (``sentinel=``): every step's metrics are judged by a
  :class:`~repro_torch.train.sentinel.StabilitySentinel` before the update
  is committed, and its verdict drives the recovery ladder -- skip-batch,
  rollback to the newest intact checkpoint, and a fallback window in which
  ``fallback_step`` (built from ``core.qpolicy.fallback_policy``) runs for
  N steps before the primary path re-engages.  ``resilience_summary()``
  reports what the guards did; ``train/faults.py`` injects the faults.

The loop is the reference's line for line, so the two packages give the
same verdict at every step of the same plan.  Two differences: the port's
step is ``step_fn(state, batch)`` -- nothing on it consumes a random key
yet, so none is passed -- and each numpy batch from the loader is moved to
the device of the state before the step.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointCorrupt, CheckpointManager
from repro_torch.data import Loader
from repro_torch.train.faults import FaultPlan
from repro_torch.train.sentinel import StabilitySentinel, Verdict
from repro_torch.train.step import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 200
    eval_every: int = 100
    eval_batches: int = 4
    log_every: int = 10


class Trainer:
    def __init__(self, train_step: Callable, eval_step: Optional[Callable],
                 state: TrainState, loader: Loader,
                 ckpt: Optional[CheckpointManager] = None,
                 loop_cfg: Optional[LoopConfig] = None,
                 valid_loader: Optional[Loader] = None,
                 metadata: Optional[Dict] = None,
                 sentinel: Optional[StabilitySentinel] = None,
                 fallback_step: Optional[Callable] = None,
                 faults: Optional[FaultPlan] = None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.loader = loader
        self.valid_loader = valid_loader
        self.ckpt = ckpt
        self.cfg = loop_cfg or LoopConfig(total_steps=100)
        self.metadata = metadata or {}
        self.history: List[Dict[str, float]] = []
        self.sentinel = sentinel
        self.fallback_step = fallback_step
        self.faults = faults
        if faults is not None and ckpt is not None:
            faults.install(ckpt)
        self._preempted = False
        self._start_step: Optional[int] = None
        self._counters = {"saves": 0, "restores": 0, "skipped_batches": 0,
                          "rollback_failures": 0}

    def _on_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        dev = self.state.opt.step.device
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in batch.items()}

    # -- fault tolerance ----------------------------------------------------

    def install_preemption_handler(self) -> None:
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    def maybe_resume(self) -> int:
        """Restore the newest intact checkpoint (falling back through the
        rotation past corrupt ones) and resume its data stream.  Returns
        the loop step to resume from (0 when nothing is restorable)."""
        if self.ckpt is None:
            return 0
        try:
            self.state, meta, step = self.ckpt.restore_latest(self.state)
        except CheckpointCorrupt:
            return 0
        self.loader.load_state_dict(meta.get("loader", {"step": step}))
        self._counters["restores"] += 1
        self._start_step = step
        return step

    def _save(self, step: int) -> None:
        if self.ckpt is None:
            return
        meta = dict(self.metadata)
        meta["loader"] = self.loader.state_dict()
        self.ckpt.save(step, self.state, metadata=meta)
        self._counters["saves"] += 1

    def _rollback(self) -> Optional[int]:
        """Recovery ladder rung 2: restore the newest intact checkpoint.
        Returns the loop step to rewind to, or None when nothing is
        restorable (the caller degrades to skip-batch)."""
        if self.ckpt is None:
            self._counters["rollback_failures"] += 1
            return None
        self.ckpt.wait()                    # surface async-write errors now
        try:
            self.state, meta, step = self.ckpt.restore_latest(self.state)
        except CheckpointCorrupt:
            self._counters["rollback_failures"] += 1
            return None
        self.loader.load_state_dict(meta.get("loader", {"step": step}))
        self._counters["restores"] += 1
        return step

    # -- loop ----------------------------------------------------------------

    def run(self) -> List[Dict[str, float]]:
        start = (self._start_step if self._start_step is not None
                 else int(self.state.opt.step))
        t0 = time.time()
        executed = 0                        # steps run, replays included
        step = start
        while step < self.cfg.total_steps:
            batch = self._on_device(next(self.loader))
            guarded = self.sentinel is not None
            use_fb = (guarded and self.fallback_step is not None
                      and self.sentinel.in_fallback(step))
            step_fn = self.fallback_step if use_fb else self.train_step
            new_state, metrics = step_fn(self.state, batch)
            executed += 1
            if guarded:
                # the float() reads sync with the device -- the price of
                # judging the step before committing it
                row = {k: float(v) for k, v in metrics.items()}
                verdict = self.sentinel.observe(step, row)
            else:
                row = None
                verdict = Verdict.OK
            if self.faults is not None:
                self.faults.note_step(step)     # sigterm_run delivery point
            if verdict is Verdict.OK:
                self.state = new_state
            elif verdict is Verdict.SKIP:
                # rung 1: drop the poisoned update, keep the pre-step
                # state; the batch is consumed
                self._counters["skipped_batches"] += 1
            else:                               # Verdict.ROLLBACK
                at = self._rollback()
                if at is None:
                    # nothing to roll back to: degrade to skip-batch (the
                    # sentinel has armed the fallback window already)
                    self._counters["skipped_batches"] += 1
                else:
                    self.sentinel.notify_rollback(at)
                    step = at
                    continue                    # rewound: no log/save tick
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                if row is None:
                    row = {k: float(v) for k, v in metrics.items()}
                row["step"] = step + 1
                row["sec_per_step"] = (time.time() - t0) / max(executed, 1)
                if use_fb:
                    row["fallback"] = 1.0
                if (self.eval_step is not None
                        and self.valid_loader is not None
                        and (step + 1) % self.cfg.eval_every == 0):
                    row["valid_ce"] = self.evaluate()
                self.history.append(row)
            if self.ckpt and (step + 1) % self.cfg.ckpt_every == 0 \
                    and verdict is Verdict.OK:
                self._save(step + 1)
            if self._preempted:
                self._save(step + 1)
                break
            step += 1
        if self.ckpt:
            self.ckpt.wait()
        return self.history

    def evaluate(self) -> float:
        losses = []
        for i in range(self.cfg.eval_batches):
            batch = self._on_device(self.valid_loader.peek(step=i))
            m = self.eval_step(self.state.params, batch)
            losses.append(float(m["ce"]))
        return float(np.mean(losses))

    # -- reporting -----------------------------------------------------------

    def resilience_summary(self) -> Dict[str, object]:
        """What the fault-tolerance machinery did this run: loop counters
        (saves, restores, skips), the sentinel's ladder accounting, and
        which planned faults fired."""
        out: Dict[str, object] = dict(self._counters)
        out["preempted"] = self._preempted
        if self.sentinel is not None:
            out["sentinel"] = self.sentinel.summary()
        if self.faults is not None:
            out["faults_planned"] = self.faults.describe()
            out["faults_fired"] = self.faults.fired
        return out
