"""Port parity of the async scheduler: the background loop, the emit thread
with the detokenizer, per-request timeouts, the three shed points, the
dead-loop watchdog and NaN quarantine, each held to the JAX scheduler's
finish reasons and counts on the same script (gpt2-mini, float32 carrier;
dense engines unless the script is paged).

Every test that starts the loop stops it (``stop`` joins the loop and the
emit thread with a timeout), and every ``wait`` has a timeout.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.infer import Engine as JEngine, Request as JRequest
from repro.models import build_model as jbuild
from repro.train import FaultPlan

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.infer import Engine, Request
from repro_torch.models import build_model, params_from_jax

POLICY = "kv_cache=a8t,*=w8c+a8t@int8_pallas"


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_smoke_config("gpt2-small"),
                               dtype="float32")
    tcfg = dataclasses.replace(tsmoke("gpt2-small"), dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def port(models, policy=None, **kw):
    return Engine(models[2], models[3], policy, device="cpu", **kw)


def both(models, policy=None, **kw):
    return ((JEngine(models[0], models[1], policy, **kw), JRequest),
            (port(models, policy, **kw), Request))


def outcome(eng, req_cls, reqs):
    """Submit ``reqs`` (dicts of Request fields), run, and return per
    request (finish reason, token count, retry hint set) and the
    scheduler's outcome counts."""
    ids = [eng.submit(req_cls(**r)) for r in reqs]
    by_id = {r.request_id: r for r in eng.run()}
    stats = eng.scheduler.latency_stats()
    return ([(by_id[i].finish_reason, len(by_id[i].tokens),
              by_id[i].retry_after_s is not None) for i in ids],
            {k: stats[k] for k in ("n", "completed", "shed", "timeout",
                                   "numerics")},
            eng.scheduler.timeouts)


def stop_all(sched, timeout=60.0):
    """Stop the loop and the emit thread; assert both are gone."""
    sched.stop(join_timeout_s=timeout)
    assert sched._loop_thread is None and sched._emit_thread is None


def test_async_start_wait_stop_matches_run(models):
    """Submissions land while the background loop runs; the responses
    arrive through events and equal a synchronous run's, on the paged
    int8 engine."""
    prompts = ([1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15], [4, 5],
               [20, 21, 22, 23, 24, 25])
    kw = dict(max_slots=2, max_seq=32, paged=True, page_size=8)
    ref = port(models, POLICY, **kw)
    for p in prompts:
        ref.submit(Request(tokens=p, max_new_tokens=5))
    want = [r.tokens for r in ref.run()]
    eng = port(models, POLICY, **kw)
    sched = eng.scheduler
    sched.start()
    try:
        ids = []
        for p in prompts:
            ids.append(eng.submit(Request(tokens=p, max_new_tokens=5)))
            time.sleep(0.005)
        sched.wait(ids, timeout=120)
    finally:
        stop_all(sched)
    out = [sched.result(i) for i in ids]
    assert [r.tokens for r in out] == want
    assert all(r.finish_reason == "length" and r.text is None for r in out)
    stats = sched.latency_stats()
    assert stats["n"] == 4 and stats["completed"] == 4
    assert 0 < stats["p50_s"] <= stats["p99_s"] < float("inf")
    assert stats["mean_s"] > 0 and stats["goodput_tok_s"] > 0
    assert 0 < sched.peak_live_bytes < port(models, POLICY, max_slots=2,
                                            max_seq=32).kv_cache_nbytes()
    assert eng.pool.live_pages == 0 and eng.live_kv_bytes() == 0


def test_start_twice_is_noop(models):
    sched = port(models, max_slots=1, max_seq=16).scheduler
    sched.start()
    try:
        t1 = sched._loop_thread
        sched.start()
        assert sched._loop_thread is t1
        with pytest.raises(RuntimeError, match="already running"):
            sched.run()
    finally:
        stop_all(sched)


def test_detokenizer_emits_text(models):
    detok = lambda toks: "|".join(map(str, toks))            # noqa: E731
    got = []
    for eng, req in both(models, max_slots=2, max_seq=16, paged=True,
                         page_size=4, detokenizer=detok):
        eng.submit(req(tokens=[1, 2, 3], max_new_tokens=4))
        [r] = eng.run()
        assert r.text == detok(r.tokens)
        got.append(r.text)
    assert got[0] == got[1]
    # run() leaves the emit thread up for the next call; stop() ends it
    assert eng.scheduler._emit_thread.is_alive()
    stop_all(eng.scheduler)


#: (engine kwargs, requests): the timeout scripts of the reference's tests
TIMEOUTS = {
    "running": (dict(max_slots=1, max_seq=256),
                [dict(tokens=[1, 2, 3], max_new_tokens=200,
                      timeout_s=0.01)]),
    "queued": (dict(max_slots=1, max_seq=256),
               [dict(tokens=[1, 2, 3], max_new_tokens=64),
                dict(tokens=[4, 5, 6], max_new_tokens=64, timeout_s=0.01)]),
    "paged": (dict(max_slots=2, max_seq=64, paged=True, page_size=8),
              [dict(tokens=list(range(1, 20)), max_new_tokens=40,
                    timeout_s=0.01)]),
    "mixed": (dict(max_slots=1, max_seq=256),
              [dict(tokens=[i + 1, i + 2], max_new_tokens=200,
                    timeout_s=0.05) for i in range(3)]),
}


def _slow_second_tick(tick):
    """Hold the second tick past every script's deadline, before its
    sweeps: each deadline then expires while its request is running or
    queued, in either framework.  Without it a fast first tick gives the
    deadline-aware shed an estimate first, and a queued request is shed
    before it can time out (the JAX engine's first tick compiles)."""
    if tick == 1:
        time.sleep(0.08)


@pytest.mark.parametrize("script", sorted(TIMEOUTS))
def test_timeouts_match_jax(models, script):
    """A deadline expired while decoding or while queued: finish reason
    "timeout", slot (and pages) freed, the engine serves on; the same
    reasons and counts as the JAX scheduler (token counts of a request cut
    while decoding depend on each framework's step time, so they are held
    to "fewer than asked")."""
    kw, reqs = TIMEOUTS[script]
    res = []
    for eng, req in both(models, "kv_cache=a8t,*=w8c"
                         if kw.get("paged") else None, **kw):
        eng.scheduler.fault_hook = _slow_second_tick
        free0 = eng.pool.free_pages if eng.paged else None
        reasons, counts, timeouts = outcome(eng, req, reqs)
        for (reason, n, _), r in zip(reasons, reqs):
            assert reason != "timeout" or n < r["max_new_tokens"]
        res.append(([r for r, _, _ in reasons], counts, timeouts))
        assert not eng._running and len(eng._free) == eng.max_slots
        if eng.paged:
            assert eng.pool.free_pages == free0
        eng.scheduler.fault_hook = None
        eng.submit(req(tokens=[1, 2, 3], max_new_tokens=3))
        [after] = eng.run()
        assert after.finish_reason == "length" and len(after.tokens) == 3
    assert res[0] == res[1]
    assert res[1][0] == {"running": ["timeout"], "paged": ["timeout"],
                         "queued": ["length", "timeout"],
                         "mixed": ["timeout"] * 3}[script]


#: (engine kwargs, prefix to pin, requests, steps to seed the monitor)
SHEDS = {
    "bounded_queue": (dict(max_slots=1, max_seq=32, max_queue=2), None,
                      [dict(tokens=[1, 2, 3], max_new_tokens=3)] * 5, 0),
    "max_queue_zero": (dict(max_slots=1, max_seq=16, max_queue=0), None,
                       [dict(tokens=[1, 2], max_new_tokens=2)], 0),
    "idle_inadmissible": (dict(max_slots=2, max_seq=48, paged=True,
                               page_size=8, n_pages=6),
                          list(range(1, 33)),
                          [dict(tokens=list(range(60, 68)),
                                max_new_tokens=8)], 0),
    "timeout_precedence": (dict(max_slots=2, max_seq=48, paged=True,
                                page_size=8, n_pages=6),
                           list(range(1, 33)),
                           [dict(tokens=list(range(60, 68)),
                                 max_new_tokens=8, timeout_s=0.01)], 0),
    "deadline_aware": (dict(max_slots=1, max_seq=64), None,
                       [dict(tokens=[1, 2, 3], max_new_tokens=30),
                        dict(tokens=[4, 5, 6], max_new_tokens=30,
                             timeout_s=2.0)], 8),
}


@pytest.mark.parametrize("script", sorted(SHEDS))
def test_shedding_matches_jax(models, script):
    """Shedding is an outcome, never an exception out of the loop: the
    bounded queue sheds at submit, a deadline the step estimate cannot
    make sheds while queued, and a head the pinned pool can never hold is
    shed after the starvation bound's patience (or times out first when it
    has a deadline).  Reasons, token counts, retry hints and outcome
    counts as the JAX scheduler's."""
    kw, prefix, reqs, seed_steps = SHEDS[script]
    res = []
    for eng, req in both(models, "*=w8c" if prefix else None, **kw):
        if prefix:
            eng.cache_prefix(prefix)
            assert eng.pool.free_pages == 1
        for _ in range(seed_steps):      # 1 s a step: 30 tokens miss 2 s
            eng.monitor.record_step(1000.0)
        res.append(outcome(eng, req, reqs))
        if prefix:
            assert eng.pool.free_pages == 1                # nothing leaked
    assert res[0] == res[1]
    reasons = [r for r, _, _ in res[1][0]]
    assert {"bounded_queue": ["length", "length", "shed", "shed", "shed"],
            "max_queue_zero": ["shed"], "idle_inadmissible": ["shed"],
            "timeout_precedence": ["timeout"],
            "deadline_aware": ["length", "shed"]}[script] == reasons


def test_shed_retry_hint_floor(models):
    eng = port(models, max_slots=1, max_seq=16, max_queue=0)
    eng.submit(Request(tokens=[1, 2], max_new_tokens=2))
    [r] = eng.run()
    assert r.finish_reason == "shed" and r.tokens == [] and r.prompt == [1, 2]
    # the cold engine's 50 ms a step x 1 (idle depth) x 2 budgeted tokens
    assert r.retry_after_s == pytest.approx(0.1)


class _LoopDied(RuntimeError):
    pass


def test_dead_loop_wakes_waiters(models):
    """The loop dies at tick 2 (the JAX fault plan's ``dead_sched@2``):
    a blocked ``wait`` wakes and re-raises the loop's error, so does
    ``stop``, and both threads are gone."""
    fired = []

    def hook(tick):
        if tick == 2:
            fired.append(tick)
            raise _LoopDied("dead_sched@2")

    eng = port(models, max_slots=2, max_seq=64)
    sched = eng.scheduler
    sched.fault_hook = hook
    sched.start()
    loop = sched._loop_thread
    rid = eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=50))
    try:
        with pytest.raises(_LoopDied):
            sched.wait([rid], timeout=60)
    finally:
        with pytest.raises(_LoopDied):
            stop_all(sched)
    loop.join(timeout=10)
    assert not loop.is_alive() and fired == [2]
    assert sched._emit_thread is None
    # the JAX scheduler under its own fault plan ends the same way
    jeng = JEngine(models[0], models[1], max_slots=2, max_seq=64)
    plan = FaultPlan.parse("dead_sched@2")
    jeng.scheduler.fault_hook = plan.scheduler_hook()
    jeng.scheduler.start()
    jrid = jeng.submit(JRequest(tokens=[1, 2, 3], max_new_tokens=50))
    jt = jeng.scheduler._loop_thread
    with pytest.raises(Exception) as jerr:
        jeng.scheduler.wait([jrid], timeout=60)
    with pytest.raises(type(jerr.value)):
        jeng.scheduler.stop(join_timeout_s=60)
    jt.join(timeout=10)
    assert plan.fired == ["dead_sched@2"]


def test_stop_raises_on_hung_loop(models):
    """A step wedged past the join timeout is not a clean shutdown: stop()
    raises RuntimeError; once the step ends the loop exits and a second
    stop() is clean."""
    entered = threading.Event()

    def hook(tick):
        if tick == 3:
            entered.set()
            time.sleep(1.5)

    eng = port(models, max_slots=1, max_seq=64)
    sched = eng.scheduler
    sched.fault_hook = hook
    sched.start()
    eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=4))
    assert entered.wait(timeout=60)
    t = sched._loop_thread
    with pytest.raises(RuntimeError, match="failed to join"):
        sched.stop(join_timeout_s=0.2)
    t.join(timeout=30)
    assert not t.is_alive()
    stop_all(sched)


def test_wait_races_timeout_cancellation(models):
    """A wait blocked on a request the deadline sweep cancels wakes with
    the "timeout" response."""
    eng = port(models, max_slots=1, max_seq=256)
    sched = eng.scheduler
    sched.start()
    try:
        rid = eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=200,
                                 timeout_s=0.05))
        sched.wait([rid], timeout=120)
        assert sched.result(rid).finish_reason == "timeout"
    finally:
        stop_all(sched)
    with pytest.raises(TimeoutError):
        sched.start()
        try:
            rid = eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=200))
            sched.wait([rid], timeout=0.01)
        finally:
            stop_all(sched)


def _poison_decode(monkeypatch, model, at_call: int, slot: int):
    """Make the model's ``at_call``-th decode (0-based) return a NaN logits
    row for ``slot`` (the JAX fault plan's ``nan_logit@N:slot=S``)."""
    orig = model.decode
    calls = []

    def decode(*args, **kwargs):
        logits, state = orig(*args, **kwargs)
        if len(calls) == at_call:
            logits = logits.clone()
            logits[slot] = float("nan")
        calls.append(1)
        return logits, state

    monkeypatch.setattr(model, "decode", decode)


@pytest.mark.parametrize("paged", [False, True])
def test_nan_quarantine_matches_jax(models, monkeypatch, paged):
    """A non-finite logits row at decode step 2 quarantines only its
    request ("numerics", tokens before it kept, slot and pages freed); its
    batchmate's tokens equal a clean solo run, as in the JAX engine."""
    kw = dict(max_slots=2, max_seq=32)
    if paged:
        kw.update(paged=True, page_size=8)
    reqs = [dict(tokens=[1, 2, 3], max_new_tokens=8),
            dict(tokens=[4, 5, 6], max_new_tokens=8)]
    clean = port(models, **kw)
    clean.submit(Request(**reqs[1]))
    [oracle] = clean.run()

    jeng = JEngine(models[0], models[1], **kw)
    plan = FaultPlan.parse("nan_logit@2:slot=0")
    jeng.fault_hooks = plan.engine_hooks()
    teng = port(models, **kw)
    _poison_decode(monkeypatch, teng.model, at_call=2, slot=0)
    got = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for r in reqs:
            eng.submit(req(**r))
        got.append([(r.finish_reason, r.tokens) for r in eng.run()])
        assert eng.scheduler.latency_stats()["numerics"] == 1
        assert eng.resilience_summary()["quarantined"] == 1
        assert not eng._running and len(eng._free) == 2
        if paged:
            assert eng.pool.live_pages == 0
    assert got[0] == got[1]
    victim, other = got[1]
    assert victim[0] == "numerics" and len(victim[1]) == 3
    assert other == ("length", oracle.tokens)
    assert teng.resilience_summary()["rung"] == "fp"


def test_monitor_window_matches_jax(models):
    """The rolling decode-step statistics the shed estimate and retry hints
    read: the same window, mean and percentiles as the JAX monitor, and an
    engine built with ``monitor=`` keeps its window."""
    from repro.infer import EngineMonitor as JMonitor, MonitorConfig as JCfg
    from repro_torch.infer import EngineMonitor, MonitorConfig
    steps = [5.0, 1.0, 9.0, 3.0, 7.0]
    jm, tm = JMonitor(JCfg(latency_window=3)), EngineMonitor(
        MonitorConfig(latency_window=3))
    assert tm.mean_step_s() is None and jm.mean_step_s() is None
    for ms in steps:
        jm.record_step(ms)
        tm.record_step(ms)
        assert tm.mean_step_s() == jm.mean_step_s()
        assert tm.step_ms() == jm.step_ms()
    eng = port(models, max_slots=1, max_seq=16,
               monitor=MonitorConfig(latency_window=2))
    eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=4))
    eng.run()
    assert eng.monitor.step_ms()["n"] == 2
    assert eng.resilience_summary()["decode_steps"] == 3
