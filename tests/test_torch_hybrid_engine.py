"""The hybrid family served: the port's dense ``Engine`` against the JAX
package's on the zamba2 smoke config at float32 (parameters from the JAX
init, carried across with ``params_from_jax``; the int8 linears on their
plain versions here and on Pallas in interpret mode on the JAX side, whose
rung 0 is the fused int8-KV path under ``REPRO_FUSED_DECODE=1``).

* Tokens and finish reasons: more requests than slots, prompts of two
  prefill buckets, a ``nan_logit`` fault on one slot -- equal to the JAX
  Engine's; so are the decode state's bytes (the KV strips of the G
  shared-block invocations and the SSM states), the KV bytes a step reads,
  the path summary's ``kv=`` segment and the ladder (``fused / dequant /
  fp``).
* The ladder's walk under two kernel errors and re-probes, down to the
  fp rung and back: walk, counts and tokens equal the JAX engine's;
  demotion to the fp rung dequantizes the KV part and leaves the SSM part
  as it was.
* A decode step that fails mid-step (``FaultInjected`` in the last
  group's shared block, after every SSM layer has its new state) demotes
  and is retried one rung down from the SSM states it started from: the
  tokens equal those of a run whose step fails before any layer ran.
* Paged mode raises with the reference's message.
"""
import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.infer import Engine as JEngine, Request as JRequest
from repro.infer import MonitorConfig as JMonitorConfig
from repro.models import build_model as jbuild
from repro.train import FaultPlan as JPlan

from repro_torch.configs import get_smoke_config
from repro_torch.infer import Engine, MonitorConfig, Request
from repro_torch.models import blocks, build_model, lm, params_from_jax
from repro_torch.train import FaultPlan
from repro_torch.train.faults import FaultInjected
from test_torch_llama import _serve

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (constants and helpers; imports no torch)

NAME = "zamba2-2.7b"
POLICY = "kv_cache=a8t,*=w8c+a8t@int8_pallas"
#: ragged prompts of the 16- and 32-token buckets, more than the slots
PROMPTS = ([5, 9, 2, 7], list(range(20, 37)), [3, 1, 4], [8, 6, 7, 5, 3])
NEWS = [5, 4, 6, 3]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fused(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, torch model, torch params on the CPU)."""
    jcfg = dataclasses.replace(jsmoke(NAME), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(NAME), dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def ladder(eng):
    s = eng.resilience_summary()
    return {"walk": chip_smoke.serve_walk(s), "rung": s["rung"],
            "rungs": s["rungs"], "kernel_errors": s["kernel_errors"],
            "quarantined": s["quarantined"],
            "decode_steps": s["decode_steps"]}


def test_engine_tokens_match_jax(models):
    jmodel, jparams, tmodel, tparams = models
    kw = dict(max_slots=2, max_seq=64)
    plan = "nan_logit@2:slot=1"
    jeng = JEngine(jmodel, jparams, POLICY, **kw)
    jeng.fault_hooks = JPlan.parse(plan).engine_hooks()
    want = _serve(jeng, JRequest, PROMPTS, NEWS)
    teng = Engine(tmodel, tparams, POLICY, device="cpu", **kw)
    teng.fault_hooks = FaultPlan.parse(plan).engine_hooks()
    got = _serve(teng, Request, PROMPTS, NEWS)
    assert got == want
    assert [r for _, r in got].count("numerics") == 1
    assert teng.path_summary() == "weights=prepared-int8(plain) kv=int8-fused"
    assert jeng.path_summary().startswith("weights=prepared-int8 "
                                          "kv=int8-fused")
    assert teng.kv_cache_nbytes() == jeng.kv_cache_nbytes() > 0
    assert teng.kv_decode_read_bytes() == jeng.kv_decode_read_bytes() > 0
    rs, jrs = teng.resilience_summary(), jeng.resilience_summary()
    assert rs["rungs"] == jrs["rungs"] == ["fused", "dequant", "fp"]
    assert rs["quarantined"] == jrs["quarantined"] == 1
    assert not rs["demotions"]
    cfg = tmodel.cfg
    state = teng._state
    assert set(state["ssm"]) == {"ssm", "conv"}
    assert tuple(state["ssm"]["ssm"].shape) == (cfg.n_layers, 2, 8, 16, 16)
    groups = cfg.n_layers // cfg.hybrid_attn_every
    assert tuple(state["caches"]["k"].shape) == (groups, 2, 64, 4, 32)
    assert state["caches"]["k"].dtype == torch.int8


#: two kernel errors walk the whole ladder down (fused -> dequant -> fp);
#: healthy streaks of ``WALK_REPROBE`` steps walk it back up
WALK_PLAN, WALK_REPROBE = "kernel_error@1;kernel_error@2", 3


def test_ladder_walk_matches_jax(models, monkeypatch):
    """``WALK_PLAN`` with a re-probe after ``WALK_REPROBE`` healthy steps:
    the walk (down to fp and back to fused), the counts and the tokens
    equal the JAX engine's.  Demoting onto the fp rung dequantizes the KV
    strips (carrier buffers, no scales) and leaves the SSM states as they
    were; promoting back requantizes them."""
    jmodel, jparams, tmodel, tparams = models
    kw = dict(max_slots=2, max_seq=32)
    jeng = JEngine(jmodel, jparams, POLICY,
                   monitor=JMonitorConfig(reprobe_after=WALK_REPROBE), **kw)
    teng = Engine(tmodel, tparams, POLICY, device="cpu",
                  monitor=MonitorConfig(reprobe_after=WALK_REPROBE), **kw)
    seen = []
    demote = teng._demote

    def watched(why, step):
        before = {k: v.clone() for k, v in teng._state["ssm"].items()}
        ok = demote(why, step)
        seen.append((sorted(teng._state["caches"]), all(
            torch.equal(teng._state["ssm"][k], v)
            for k, v in before.items())))
        return ok
    monkeypatch.setattr(teng, "_demote", watched)
    got = []
    for eng, req, plan_cls in ((jeng, JRequest, JPlan),
                               (teng, Request, FaultPlan)):
        eng.fault_hooks = plan_cls.parse(WALK_PLAN).engine_hooks()
        got.append(_serve(eng, req, [[1, 2, 3], [4, 5, 6, 7, 8]], [12, 12]))
    assert got[0] == got[1]
    assert ladder(teng) == ladder(jeng)
    walk = ladder(teng)["walk"]
    assert [w[1:] for w in walk] == [["fused", "dequant"], ["dequant", "fp"],
                                     ["fp", "dequant"], ["dequant", "fused"]]
    assert seen == [(["k", "k_scale", "v", "v_scale"], True),
                    (["k", "v"], True)]
    assert teng._state["caches"]["k"].dtype == torch.int8


def test_failed_step_retries_from_the_states_it_started_from(models,
                                                              monkeypatch):
    """The third decode step fails in its last shared block, after every
    SSM layer computed its new state and the first invocation wrote its KV
    row: the step is retried one rung down from the SSM states it started
    from (the failed attempt committed none), so the tokens, the walk and
    the rung counts equal a run under ``kernel_error@2``, which raises
    before any layer ran."""
    _, _, tmodel, tparams = models
    kw = dict(max_slots=2, max_seq=64, device="cpu",
              monitor=MonitorConfig(reprobe_after=4))
    ref = Engine(tmodel, tparams, POLICY, **kw)
    ref.fault_hooks = FaultPlan.parse("kernel_error@2").engine_hooks()
    want = _serve(ref, Request, PROMPTS, NEWS)
    eng = Engine(tmodel, tparams, POLICY, **kw)
    snaps = []
    call = eng._decode_call

    def snapshot(*args):
        snaps.append({k: v.clone() for k, v in eng._state["ssm"].items()})
        return call(*args)
    monkeypatch.setattr(eng, "_decode_call", snapshot)
    shared = lm.shared_block
    steps = []

    def failing(params, h, emb0, cfg, **kw):
        if h.shape[1] == 1:
            steps.append(1)
            # the third decode step's second (last) invocation
            if len(steps) == 6:
                raise FaultInjected("injected failure in the last shared "
                                    "block")
        return shared(params, h, emb0, cfg, **kw)
    monkeypatch.setattr(lm, "shared_block", failing)
    assert _serve(eng, Request, PROMPTS, NEWS) == want
    assert ladder(eng) == ladder(ref)
    assert ladder(eng)["walk"][0] == [2, "fused", "dequant"]
    assert eng.stats["rung_steps"] == ref.stats["rung_steps"]
    # the failed attempt and its retry started from the same SSM states
    assert all(torch.equal(snaps[2][k], snaps[3][k]) for k in snaps[2])
    assert blocks.shared_block is shared


def test_paged_mode_raises_as_the_reference(models):
    jmodel, jparams, tmodel, tparams = models
    with pytest.raises(ValueError) as jerr:
        JEngine(jmodel, jparams, POLICY, paged=True, max_seq=64)
    with pytest.raises(ValueError) as terr:
        Engine(tmodel, tparams, POLICY, paged=True, max_seq=64, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "carries SSM state" in str(terr.value)
