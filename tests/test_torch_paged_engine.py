"""Port parity of the paged serving engine: the port's ``Engine(paged=True)``
against the JAX paged engine on gpt2-mini at the float32 carrier, with
``REPRO_FUSED_DECODE=1`` for the JAX side (the oracle rule of ROADMAP
section 3: the port's int8-KV path is the JAX fused path).

Held equal: greedy tokens under the slice's policy, W8 with the int8 KV
cache, and W8 with an fp KV cache (packed prefill); ``path_summary``'s
``kv=`` segment; the page tables, refcounts, ``live_kv_bytes`` and
``kv_decode_read_bytes`` after every scheduler tick of the same script;
and the outcomes of the reference's paged scenarios (capacity errors,
freed-page hygiene, head-of-line admission with the starvation bound,
preemption, prefix sharing).  Also: paged tokens equal the port's dense
engine's.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.infer import (CapacityError as JCapacityError, Engine as JEngine,
                         Request as JRequest)
from repro.models import build_model as jbuild

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.infer import CapacityError, Engine, Request
from repro_torch.models import build_model, params_from_jax

POLICY = "kv_cache=a8t,*=w8c+a8t@int8_pallas"
PROMPTS = ([1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15], [4, 5],
           [20, 21, 22, 23, 24, 25], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5])


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, torch model, torch params on the CPU):
    gpt2-mini at float32."""
    jcfg = dataclasses.replace(get_smoke_config("gpt2-small"),
                               dtype="float32")
    tcfg = dataclasses.replace(tsmoke("gpt2-small"), dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")


def engines(models, policy=None, **kw):
    jmodel, jparams, tmodel, tparams = models
    return (JEngine(jmodel, jparams, policy, **kw),
            Engine(tmodel, tparams, policy, device="cpu", **kw))


def tokens(eng, req_cls, prompts, max_new=5):
    ids = [eng.submit(req_cls(tokens=list(p), max_new_tokens=max_new))
           for p in prompts]
    by_id = {r.request_id: r for r in eng.run()}
    return [(by_id[i].tokens, by_id[i].finish_reason) for i in ids]


def kv_segment(eng):
    return eng.path_summary().split(" kv=")[1]


@pytest.mark.parametrize("policy", [POLICY, "kv_cache=a8t,*=w8c", "*=w8c"])
def test_paged_engine_matches_jax_tick_by_tick(models, fused, policy):
    """The same script through both paged engines, one scheduler tick at a
    time (more requests than slots, ragged prompts, slot and page reuse):
    after every tick the page tables, refcounts, live bytes and decode
    read bytes agree, and in the end every response does."""
    jeng, teng = engines(models, policy, max_slots=3, max_seq=32,
                         paged=True, page_size=8)
    assert kv_segment(teng) == kv_segment(jeng)
    ids = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        ids.append([eng.submit(req(tokens=list(p), max_new_tokens=6))
                    for p in PROMPTS])
    assert ids[0] == ids[1]
    assert teng.live_kv_bytes() == jeng.live_kv_bytes() == 0
    busy = True
    while busy:
        busy = jeng.scheduler.step()
        assert teng.scheduler.step() == busy
        assert np.array_equal(teng.pool.table, jeng.pool.table)
        assert np.array_equal(teng.pool.refcount, jeng.pool.refcount)
        assert teng.live_kv_bytes() == jeng.live_kv_bytes()
        assert teng.kv_decode_read_bytes() == jeng.kv_decode_read_bytes()
    got = [{r.request_id: (r.tokens, r.finish_reason)
            for r in eng.run()} for eng in (jeng, teng)]
    assert got[0] == got[1] and sorted(got[1]) == ids[1]
    assert teng.pool.live_pages == 0
    assert teng.kv_cache_nbytes() == jeng.kv_cache_nbytes()
    assert teng.scheduler.peak_live_bytes == jeng.scheduler.peak_live_bytes


@pytest.mark.parametrize("policy", [POLICY, "*=w8c"])
def test_paged_engine_equals_dense(models, policy):
    _, _, tmodel, tparams = models
    kw = dict(max_slots=3, max_seq=32, device="cpu")
    dense = Engine(tmodel, tparams, policy, **kw)
    paged = Engine(tmodel, tparams, policy, paged=True, page_size=8, **kw)
    assert (tokens(paged, Request, PROMPTS, 6)
            == tokens(dense, Request, PROMPTS, 6))
    assert paged.kv_cache_nbytes() > dense.kv_cache_nbytes()   # + trash page
    assert 0 < paged.scheduler.peak_live_bytes < dense.kv_cache_nbytes()
    assert paged.live_kv_bytes() == 0


def test_path_summary_and_geometry(models):
    jeng, teng = engines(models, POLICY, max_slots=2, max_seq=48, paged=True)
    assert teng.path_summary() == ("weights=prepared-int8(plain) "
                                   "kv=int8-paged-fused(p48)")
    assert (teng.page_size, teng.n_pages) == (jeng.page_size, jeng.n_pages)
    jeng, teng = engines(models, "*=w8c", max_slots=2, max_seq=48,
                         paged=True, page_size=12)
    assert kv_segment(teng) == kv_segment(jeng) == "fp-paged(p12)"
    # a page size that does not divide max_seq halves until it does
    jeng, teng = engines(models, max_slots=2, max_seq=48, paged=True,
                         page_size=20)
    assert teng.page_size == jeng.page_size == 2 and teng.n_pages == 1 + 2 * 24


def _capacity_fields(e):
    return {k: getattr(e, k) for k in (
        "tokens", "max_seq", "page_size", "pages_needed", "pages_total",
        "pages_free", "slots_total", "slots_free")}


def test_capacity_errors_match_jax(models):
    """tests/test_pages.py:110 and :135 -- a prompt with no decode row, a
    request that alone would exhaust the pool, the dense engine's refusal,
    and the truncation message that names the paged limits."""
    cases = [(dict(max_slots=2, max_seq=16, paged=True, page_size=4,
                   n_pages=4), (list(range(16)), 1)),
             (dict(max_slots=2, max_seq=16, paged=True, page_size=4,
                   n_pages=4), ([1, 2, 3], 20)),
             (dict(max_slots=1, max_seq=10), (list(range(10)), 1))]
    for kw, (toks, new) in cases:
        jeng, teng = engines(models, **kw)
        errs = []
        for eng, req, exc in ((jeng, JRequest, JCapacityError),
                              (teng, Request, CapacityError)):
            with pytest.raises(exc) as ei:
                eng.submit(req(tokens=toks, max_new_tokens=new))
            assert isinstance(ei.value, ValueError)
            errs.append(_capacity_fields(ei.value))
        assert errs[0] == errs[1]
    _, teng = engines(models, max_slots=1, max_seq=16, paged=True,
                      page_size=4)
    with pytest.raises(ValueError, match="truncated") as ei:
        teng.generate(np.arange(8)[None, :], 12)
    assert "pages" in str(ei.value) and "n_pages" in str(ei.value)


def test_freed_page_hygiene(models, fused):
    """tests/test_pages.py:178 -- a request decoding into recycled pages
    (the previous tenant's rows still in them) gives the tokens it gives
    on a never-used pool, and the JAX engine's."""
    kw = dict(max_slots=2, max_seq=32, paged=True, page_size=8)
    b_prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    jeng, teng = engines(models, POLICY, **kw)
    tokens(teng, Request, [[11, 12, 13, 14, 15, 16, 17, 18, 19]], 8)
    assert teng.pool.live_pages == 0
    reused = tokens(teng, Request, [b_prompt], 8)
    _, fresh = engines(models, POLICY, **kw)
    assert reused == tokens(fresh, Request, [b_prompt], 8)
    assert reused == tokens(jeng, JRequest, [b_prompt], 8)


def test_hol_admission_and_starvation_bound_match_jax(models):
    """tests/test_pages.py:218 -- a queue head that does not fit the free
    pages does not block smaller requests, and every request completes;
    the same admissions, tokens and skip counters as the JAX engine."""
    jeng, teng = engines(models, max_slots=2, max_seq=32, paged=True,
                         page_size=8, n_pages=9)
    prompts = [list(range(1, 21)), [1, 2], [3, 4, 5], [6, 7], [8, 9, 10],
               [11, 12]]
    news = [8, 6, 6, 6, 6, 6]
    outs, orders = [], []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        ids = [eng.submit(req(tokens=p, max_new_tokens=n))
               for p, n in zip(prompts, news)]
        order = []
        while eng.scheduler.step():
            order.append(sorted(st.req.request_id
                                for st in eng._running.values()))
        orders.append(order)
        by_id = {r.request_id: r for r in eng.run()}
        outs.append([(by_id[i].tokens, by_id[i].finish_reason) for i in ids])
        assert not eng._skips
    assert orders[0] == orders[1]
    assert outs[0] == outs[1]
    assert [len(t) for t, _ in outs[1]] == news


def test_preemption_matches_jax(models):
    """tests/test_pages.py:237 -- two requests whose page growth exceeds
    the pool: one is preempted mid-decode and requeued with its tokens;
    both finish with their solo tokens, and the preemption count is the
    JAX engine's."""
    # the reference test's script with a pool of 4 allocatable pages, not
    # 5: with 5 both requests fit and nothing is preempted
    kw = dict(max_slots=2, max_seq=32, paged=True, page_size=8, n_pages=5)
    reqs = [([5, 6, 7, 8, 9, 10, 11], 12), ([1, 2, 3], 14)]
    jeng, teng = engines(models, "*=w8c", **kw)
    solo = []
    for p, n in reqs:
        _, one = engines(models, "*=w8c", **kw)
        solo += tokens(one, Request, [p], n)
    got = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        ids = [eng.submit(req(tokens=p, max_new_tokens=n)) for p, n in reqs]
        by_id = {r.request_id: r for r in eng.run()}
        got.append([(by_id[i].tokens, by_id[i].finish_reason,
                     by_id[i].prompt) for i in ids])
        assert eng.pool.live_pages == 0
    assert got[0] == got[1]
    assert [(t, r) for t, r, _ in got[1]] == solo
    assert [p for _, _, p in got[1]] == [p for p, _ in reqs]
    assert teng.preemptions == jeng.preemptions >= 1
    assert teng.resilience_summary()["preemptions"] == teng.preemptions


def test_prefix_sharing_matches_jax(models, fused):
    """tests/test_pages.py:255 -- ``cache_prefix`` pins whole prefix pages
    once; requests sharing the prefix alias them (refcounts, no copy) and
    give the dense engine's tokens and the JAX engine's; the pin survives
    the requests."""
    prefix = [42, 17, 3, 99, 5, 21, 8, 13]                 # one page
    prompts = [prefix + [60, 61, 62], prefix + [70]]
    kw = dict(max_slots=2, max_seq=32, paged=True, page_size=8)
    jeng, teng = engines(models, POLICY, **kw)
    outs = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        assert eng.cache_prefix(prefix) == 1
        assert eng.cache_prefix(prefix + [1]) == 1         # already cached
        pids = eng._prefixes[tuple(prefix)]
        assert eng.pool.live_pages == 1
        assert int(eng.pool.refcount[pids[0]]) == 2        # alloc + pin
        ids = [eng.submit(req(tokens=p, max_new_tokens=6)) for p in prompts]
        eng.scheduler.step()                               # both admitted
        assert int(eng.pool.refcount[pids[0]]) == 4
        by_id = {r.request_id: r for r in eng.run()}
        outs.append([by_id[i].tokens for i in ids])
        assert eng.pool.live_pages == 1
        assert int(eng.pool.refcount[pids[0]]) == 2
    assert outs[0] == outs[1]
    dense = Engine(models[2], models[3], POLICY, max_slots=2, max_seq=32,
                   device="cpu")
    assert [t for t, _ in tokens(dense, Request, prompts, 6)] == outs[1]
    with pytest.raises(ValueError, match="shorter than one page"):
        teng.cache_prefix(prefix[:4])
