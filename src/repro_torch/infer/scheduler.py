"""Synchronous continuous-batching host loop for the serving engine (the
``run()`` mode of ``repro/infer/scheduler.py``).

Each tick admits queued requests into free slots (the engine's bucketed
prefill), runs one batched decode step over every slot, readmits into the
slots that step freed, and collects the finished responses.  The JAX
package's background thread, emit thread, deadlines and load shedding are
not ported yet (see ROADMAP).
"""
from __future__ import annotations

import time
from typing import Dict, List


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    if not xs:
        return float("nan")
    ys = sorted(xs)
    return ys[min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))]


class Scheduler:
    def __init__(self, engine):
        self.engine = engine
        self.steps = 0
        self._results: Dict[int, object] = {}
        self._times: Dict[int, Dict[str, float]] = {}

    def enqueue(self, req) -> None:
        """Called by ``Engine.submit`` after validation."""
        self._times[req.request_id] = {"submit": time.monotonic()}
        self.engine._queue.append(req)

    def step(self) -> bool:
        """One tick: admit, decode one step, readmit, collect.  Returns
        False when nothing is queued or running."""
        eng = self.engine
        eng._admit()
        if eng._running:
            eng._step()
            eng._admit()          # freed slots readmit immediately
        self.steps += 1
        now = time.monotonic()
        for resp in eng._drain_done():
            self._times[resp.request_id]["finish"] = now
            self._results[resp.request_id] = resp
        return bool(eng._running or eng._queue)

    def run(self) -> List[object]:
        """Process until idle; return every unclaimed response in
        request-id order."""
        while self.step():
            pass
        out = [self._results.pop(rid) for rid in sorted(self._results)]
        return out

    def latency_stats(self) -> Dict[str, float]:
        """Submit -> finish wall-clock latency over finished requests."""
        lats = [t["finish"] - t["submit"] for t in self._times.values()
                if "finish" in t]
        return {"n": len(lats), "p50_s": _percentile(lats, 50),
                "p99_s": _percentile(lats, 99)}
