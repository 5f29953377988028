"""The MoE family served through the port's dense and paged ``Engine``
against the JAX package's, on the ``granite-moe-3b-a800m`` and
``phi3.5-moe-42b-a6.6b`` smoke configs at float32 under the slice's
policy (prepared W8A8 expert weights on #3's expert-batched instance --
its plain version here, the tensors lying on the CPU -- and the int8 KV
cache on the fused rung).

Oracle: the JAX fused int8-KV path (``REPRO_FUSED_DECODE=1``, Pallas in
interpret mode; ROADMAP section 3's oracle rule).  Tolerance: greedy
tokens equal.

Capacity couples the rows that share a dispatch: every routed row takes
an expert's capacity first come first served, the decode step's empty
slots and a prefill's pad rows included.  The smoke configs' capacity
factor of 8 drops nothing, so there each token's route is its own; the
dropping case (capacity factor 1.0, the full configs' 1.25 and below)
holds the engines to the reference where the engines route the same rows
in the same launches: prompts of one prefill bucket, admitted at once.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jsmoke
from repro.infer import Engine as JEngine, Request as JRequest
from repro.models import build_model as jbuild

from repro_torch.configs import get_smoke_config
from repro_torch.infer import Engine, Request
from repro_torch.models import build_model, params_from_jax

from test_torch_llama import POLICY, PROMPTS, _serve

ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")


def pair(name, **kw):
    """(jax model, jax params, torch model, torch params on the CPU) of the
    smoke config at float32 (``kw`` replaces fields on both sides)."""
    jcfg = dataclasses.replace(jsmoke(name), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_smoke_config(name), dtype="float32",
                               **kw)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_engine_tokens_match_jax(name, paged, fused):
    """Continuous batching: more requests than slots, ragged prompts, slot
    (and page) reuse; greedy tokens equal the JAX Engine's, on the fused
    rung with the expert weights prepared."""
    jmodel, jparams, tmodel, tparams = pair(name)
    kw = dict(max_slots=2, max_seq=32)
    if paged:
        kw.update(paged=True, page_size=8)
    news = [6, 4, 7, 5, 6]
    want = _serve(JEngine(jmodel, jparams, POLICY, **kw), JRequest, PROMPTS,
                  news)
    teng = Engine(tmodel, tparams, POLICY, device="cpu", **kw)
    assert _serve(teng, Request, PROMPTS, news) == want
    assert [len(t) for t, _ in want] == news
    assert teng.path_summary().startswith("weights=prepared-int8(plain)")
    rs = teng.resilience_summary()
    assert rs["rung"] == "fused" and not rs["demotions"], rs
    if paged:
        assert teng.pool.live_pages == 0


#: prompts of one prefill bucket (9-16 tokens), admitted in one wave
ONE_BUCKET = ([5, 9, 2, 7, 1, 8, 3, 6, 4, 10, 11, 12],
              [20, 21, 22, 23, 24, 25, 26, 27, 28, 29],
              [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7],
              [40, 41, 42, 43, 44, 45, 46, 47, 48])


def test_engine_dropping_capacity_dense_paged_and_jax(fused):
    """granite-smoke at a capacity factor of 1.0, which drops pairs at the
    decode step (4 slots x top-2 over 8 experts: capacity 2) and in
    prefill: four prompts of one bucket admitted at once, so both engines
    prefill the same rows in one launch and decode the same slots; the
    port's dense and paged engines give the same tokens, and the JAX dense
    engine's."""
    name = "granite-moe-3b-a800m"
    jmodel, jparams, tmodel, tparams = pair(name, capacity_factor=1.0)
    kw = dict(max_slots=4, max_seq=32)
    news = [8] * len(ONE_BUCKET)
    want = _serve(JEngine(jmodel, jparams, POLICY, **kw), JRequest,
                  ONE_BUCKET, news)
    dense = Engine(tmodel, tparams, POLICY, device="cpu", **kw)
    paged = Engine(tmodel, tparams, POLICY, device="cpu", paged=True,
                   page_size=16, **kw)
    assert _serve(dense, Request, ONE_BUCKET, news) == want
    assert _serve(paged, Request, ONE_BUCKET, news) == want
    assert dense.stats["prefill_calls"] == paged.stats["prefill_calls"] == 1
