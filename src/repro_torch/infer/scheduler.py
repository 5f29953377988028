"""Async continuous-batching host loop for the serving engine (port of
``repro/infer/scheduler.py``).

The :class:`~repro_torch.infer.engine.Engine` owns the device side
(prefill, decode and page-in, the page pool, slot bookkeeping); the
:class:`Scheduler` owns the host side around it:

* a thread-safe **submit queue**: ``enqueue`` may be called from any
  thread while the loop decodes;
* the **scheduling loop** (:meth:`step`): drain submissions, sweep
  deadlines, admit (the engine's head-of-line-fair ``_admit``), run one
  decode step, hand finished responses to the emit thread;
* a background **emit thread**: finished responses get their text from
  ``Engine.detokenizer`` (when set) and their completion events set off
  the scheduling loop;
* **latency accounting** per request (submit -> finish), summarized by
  :meth:`latency_stats`;
* **per-request deadlines**: a ``Request.timeout_s`` is armed at submit
  and every tick cancels expired requests through ``Engine.cancel``
  (finish reason ``"timeout"``, slot and pages freed);
* **load shedding** as an outcome (finish reason ``"shed"`` with a
  ``Response.retry_after_s`` hint), never an exception out of the loop, at
  three points: a bounded submit queue (``max_queue`` queued + running
  requests, checked in :meth:`enqueue`); deadline-aware shedding (a queued
  request that cannot finish before its deadline by the rolling decode-step
  estimate); and the idle inadmissible head (a request the pool, shrunk by
  pinned prefixes, can never hold).  The timeout sweep runs first, so an
  expired deadline is always a ``"timeout"``;
* a **dead-loop watchdog**: if the background loop dies, every pending
  completion event is set, so ``wait()`` re-raises the loop's exception
  instead of hanging, and ``stop()`` re-raises it too (and raises
  ``RuntimeError`` when the loop thread does not join).  ``fault_hook`` is
  called with the tick number at the top of every :meth:`step`; raising
  there kills the loop on purpose.

Two driving modes share every code path: ``run()`` drains synchronously
and returns the responses in request-id order; ``start()`` / ``stop()``
run the loop in a background thread and ``wait(ids)`` blocks on
completion events.  Every CUDA call of the engine happens on the thread
that runs :meth:`step`; the emit thread touches host objects only.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.infer.resilience import percentile


class Scheduler:
    def __init__(self, engine, max_queue: Optional[int] = None):
        self.engine = engine
        #: enqueue sheds when (queued + running) already holds this many
        #: requests; None = unbounded
        self.max_queue = max_queue
        self._inbox: "queue.Queue" = queue.Queue()
        self._emit_q: "queue.Queue" = queue.Queue()
        self._results: Dict[int, object] = {}
        self._events: Dict[int, threading.Event] = {}
        self._times: Dict[int, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._emit_thread: Optional[threading.Thread] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._loop_error: Optional[BaseException] = None
        self._deadlines: Dict[int, float] = {}        # rid -> monotonic bound
        #: called with the tick number at the top of every step(); raising
        #: there kills the loop (the watchdog's test hook)
        self.fault_hook: Optional[Callable[[int], None]] = None
        self.peak_live_bytes = 0
        self.steps = 0
        self.timeouts = 0
        self.peak_queue_depth = 0
        self._reasons: Dict[str, int] = {}     # finish_reason -> count
        self._good_tokens = 0                  # tokens of completed requests

    # -- submission (any thread) ------------------------------------------

    def queue_depth(self) -> int:
        """Requests waiting or running: the inbox, the engine's queue and
        its running slots (len() reads only, atomic under the GIL)."""
        return (self._inbox.qsize() + len(self.engine._queue)
                + len(self.engine._running))

    def _retry_after(self, req) -> float:
        """Back-off hint of a shed response: the rolling decode-step time
        times the work ahead, with a 50 ms floor for a cold engine."""
        step_s = self.engine.monitor.mean_step_s() or 0.05
        depth = max(1, len(self.engine._queue) + len(self.engine._running))
        budget = max(1, int(getattr(req, "max_new_tokens", 1)))
        return round(max(0.05, step_s * min(depth * budget, 10_000)), 3)

    def _shed_at_submit(self, req, now: float) -> None:
        """Bounded-queue rejection on the submitting thread; the ``"shed"``
        response goes through the emit thread like any other finish."""
        from repro_torch.infer.engine import Response
        resp = Response(request_id=req.request_id, prompt=list(req.tokens),
                        tokens=[], finish_reason="shed",
                        retry_after_s=self._retry_after(req))
        with self._lock:
            self._events[req.request_id] = threading.Event()
            self._times[req.request_id] = {"submit": now}
        self._ensure_emit_thread()
        self._emit_q.put(resp)

    def enqueue(self, req) -> None:
        """Called by ``Engine.submit`` after validation: records the arrival
        and hands the request to the loop, or sheds it when the bounded
        queue is full."""
        now = time.monotonic()
        if self.max_queue is not None \
                and self.queue_depth() >= self.max_queue:
            self._shed_at_submit(req, now)
            return
        with self._lock:
            self._events[req.request_id] = threading.Event()
            self._times[req.request_id] = {"submit": now}
            if req.timeout_s is not None:
                self._deadlines[req.request_id] = now + req.timeout_s
        self._inbox.put(req)

    # -- emit thread -------------------------------------------------------

    def _ensure_emit_thread(self) -> None:
        if self._emit_thread is None or not self._emit_thread.is_alive():
            self._emit_thread = threading.Thread(
                target=self._emit_loop, name="repro-torch-emit", daemon=True)
            self._emit_thread.start()

    def _emit_loop(self) -> None:
        detok = self.engine.detokenizer
        while True:
            resp = self._emit_q.get()
            if resp is None:                   # stop(): end the thread
                self._emit_q.task_done()
                return
            try:
                if detok is not None:
                    resp.text = detok(resp.tokens)
                now = time.monotonic()
                with self._lock:
                    t = self._times.setdefault(resp.request_id, {})
                    t["finish"] = now
                    reason = resp.finish_reason
                    if reason == "shed":
                        t["shed"] = True
                    self._reasons[reason] = self._reasons.get(reason, 0) + 1
                    if reason in ("eos", "length"):
                        self._good_tokens += len(resp.tokens)
                    self._results[resp.request_id] = resp
                    ev = self._events.get(resp.request_id)
                if ev is not None:
                    ev.set()
            finally:
                self._emit_q.task_done()

    def _emit(self, responses) -> None:
        for resp in responses:
            with self._lock:
                self._deadlines.pop(resp.request_id, None)
            self._ensure_emit_thread()
            self._emit_q.put(resp)

    # -- the loop ----------------------------------------------------------

    def _drain_inbox(self) -> None:
        while True:
            try:
                self.engine._queue.append(self._inbox.get_nowait())
            except queue.Empty:
                return

    def _sweep_timeouts(self) -> None:
        """Cancel every request past its deadline, queued or running (before
        admission, so an expired request is never admitted)."""
        with self._lock:
            now = time.monotonic()
            expired = [rid for rid, dl in self._deadlines.items()
                       if now >= dl]
            for rid in expired:
                del self._deadlines[rid]
        for rid in expired:
            if self.engine.cancel(rid, reason="timeout"):
                self.timeouts += 1

    def _sweep_sheds(self) -> None:
        """Shed queued requests that cannot finish before their deadline by
        the rolling decode-step estimate (one prefill step plus one step a
        budgeted token); no estimate before the first step."""
        step_s = self.engine.monitor.mean_step_s()
        if step_s is None:
            return
        queued = {r.request_id: r for r in self.engine._queue}
        if not queued:
            return
        now = time.monotonic()
        with self._lock:
            doomed = [(rid, queued[rid]) for rid, dl in self._deadlines.items()
                      if rid in queued
                      and now + (1 + int(queued[rid].max_new_tokens)) * step_s
                      > dl]
            for rid, _ in doomed:
                del self._deadlines[rid]
        for rid, req in doomed:
            self.engine.cancel(rid, reason="shed",
                               retry_after_s=self._retry_after(req))

    def step(self) -> bool:
        """One tick: drain submissions, sweep deadlines, admit, decode one
        step, emit finishes.  Returns False when fully idle."""
        if self.fault_hook is not None:
            self.fault_hook(self.steps)
        eng = self.engine
        self._drain_inbox()
        self._sweep_timeouts()
        self._sweep_sheds()
        self.peak_queue_depth = max(self.peak_queue_depth,
                                    len(eng._queue) + len(eng._running))
        eng._admit()
        if eng._running:
            eng._step()
            eng._admit()          # freed slots and pages readmit at once
        self.steps += 1
        self.peak_live_bytes = max(self.peak_live_bytes, eng.live_kv_bytes())
        self._emit(eng._drain_done())
        if eng._queue and not eng._running:
            # nothing runs and nothing was admitted: the head can never fit
            # (pinned prefixes shrank the pool).  A deadlined head waits for
            # the sweep ("timeout"); an undeadlined one gets the starvation
            # bound's patience on a paged engine (a pool that is dry for a
            # tick must not shed), then is shed -- never a CapacityError
            # out of the loop, which would stop serving for everyone
            from repro_torch.infer.engine import STARVATION_LIMIT
            req = eng._queue[0]
            rid = req.request_id
            with self._lock:
                deadlined = rid in self._deadlines
            if deadlined:
                return True
            if eng.paged and eng._skips.get(rid, 0) < STARVATION_LIMIT:
                eng._skips[rid] = eng._skips.get(rid, 0) + 1
                return True
            eng.cancel(rid, reason="shed",
                       retry_after_s=self._retry_after(req))
            self._emit(eng._drain_done())
            return True
        return bool(eng._running or eng._queue or not self._inbox.empty())

    def run(self) -> List[object]:
        """Synchronous drain: step until idle, wait for the emit thread,
        return every unclaimed response in request-id order.  The emit
        thread stays up for the next call (and keeps the engine alive)
        until :meth:`stop`."""
        if self._loop_thread is not None and self._loop_thread.is_alive():
            raise RuntimeError("scheduler loop already running; use wait()")
        while self.step():
            pass
        self._emit_q.join()
        with self._lock:
            out = [self._results.pop(rid) for rid in sorted(self._results)]
            for r in out:
                self._events.pop(r.request_id, None)
        return out

    # -- async serve mode --------------------------------------------------

    def start(self) -> None:
        """Run the scheduling loop in a background thread."""
        if self._loop_thread is not None and self._loop_thread.is_alive():
            return
        self._stop.clear()
        self._loop_error = None
        self._ensure_emit_thread()

        def loop():
            try:
                while not self._stop.is_set():
                    if not self.step():
                        time.sleep(1e-3)
            except BaseException as e:   # the watchdog: park the error for
                self._loop_error = e     # wait()/stop(), wake every waiter
                self._wake_all()

        self._loop_thread = threading.Thread(target=loop,
                                             name="repro-torch-sched",
                                             daemon=True)
        self._loop_thread.start()

    def _wake_all(self) -> None:
        """Set every pending completion event, so blocked ``wait()`` callers
        see the loop's error instead of hanging."""
        with self._lock:
            evs = [ev for rid, ev in self._events.items()
                   if rid not in self._results]
        for ev in evs:
            ev.set()

    def stop(self, join_timeout_s: float = 60.0) -> None:
        """Stop the background loop and the emit thread (after it has
        emitted every queued response).  Raises ``RuntimeError`` if the
        loop thread does not join within ``join_timeout_s`` (a wedged step
        is not a clean shutdown), and re-raises the loop's own error if it
        died."""
        self._stop.set()
        if self._loop_thread is not None:
            t = self._loop_thread
            t.join(timeout=join_timeout_s)
            if t.is_alive():
                raise RuntimeError(
                    f"scheduler loop thread failed to join within "
                    f"{join_timeout_s:g}s; a step is likely wedged (the "
                    "thread is a daemon and will not block interpreter "
                    "exit)")
            self._loop_thread = None
        if self._emit_thread is not None and self._emit_thread.is_alive():
            self._emit_q.put(None)             # after every queued response
            self._emit_thread.join(timeout=join_timeout_s)
        self._emit_thread = None
        if self._loop_error is not None:
            raise self._loop_error

    def wait(self, rids: List[int], timeout: Optional[float] = None) -> None:
        """Block until every listed request has a response.  Raises the
        loop's exception if the loop died, and ``TimeoutError`` when
        ``timeout`` seconds pass first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for rid in rids:
            if self._loop_error is not None:
                raise self._loop_error
            ev = self._events.get(rid)
            if ev is None:
                continue
            left = None if deadline is None else deadline - time.monotonic()
            if not ev.wait(left):
                if self._loop_error is not None:
                    raise self._loop_error
                raise TimeoutError(f"request {rid} not finished in time")
            if self._loop_error is not None:
                with self._lock:
                    has_result = rid in self._results
                if not has_result:
                    raise self._loop_error

    def result(self, rid: int):
        with self._lock:
            self._events.pop(rid, None)
            return self._results.pop(rid)

    # -- metrics -----------------------------------------------------------

    def latency_stats(self) -> Dict[str, float]:
        """Submit -> finish latency over finished requests (shed ones left
        out of the percentiles and ``n``), outcome counts, ``goodput_tok_s``
        (tokens of completed requests over the serving span) and the queue
        depth now and at its peak."""
        with self._lock:
            lats = [t["finish"] - t["submit"] for t in self._times.values()
                    if "finish" in t and not t.get("shed")]
            finishes = [t["finish"] for t in self._times.values()
                        if "finish" in t]
            submits = [t["submit"] for t in self._times.values()]
            reasons = dict(self._reasons)
            good_tokens = self._good_tokens
        span = (max(finishes) - min(submits)) if finishes else 0.0
        return {"n": len(lats),
                "p50_s": percentile(lats, 50),
                "p99_s": percentile(lats, 99),
                "mean_s": (sum(lats) / len(lats)) if lats else float("nan"),
                "completed": (reasons.get("eos", 0)
                              + reasons.get("length", 0)),
                "shed": reasons.get("shed", 0),
                "timeout": reasons.get("timeout", 0),
                "numerics": reasons.get("numerics", 0),
                "goodput_tok_s": good_tokens / max(span, 1e-9),
                "queue_depth": self.queue_depth(),
                "peak_queue_depth": self.peak_queue_depth}


__all__ = ["Scheduler"]
