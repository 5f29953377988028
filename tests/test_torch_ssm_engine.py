"""The SSM family served: the port's ``lm_prefill`` / ``lm_decode`` and its
dense ``Engine`` against the JAX package's on the mamba2 smoke config at
float32 (parameters from the JAX init, carried across with
``params_from_jax``; the int8 linears on their plain versions here and,
on the JAX side, on Pallas in interpret mode).

* Prefill and three decode steps: the logits, the SSM states and the conv
  tails within 1e-4 of the largest (the fp and the W8A8 policy; readings on
  this tree 1.5e-7 to 6.6e-6, the SSD's sums in another order); the decode
  leaves the state it is given as it was.
* The engine: more requests than slots, prompts of two prefill buckets,
  a ``nan_logit`` fault on one slot; greedy tokens and finish reasons
  equal the JAX Engine's, and so do the decode state's bytes, the KV read
  bytes (none) and the ladder (the one rung ``none``).
* A decode step that fails mid-step (``FaultInjected`` raised in the last
  layer, after the first layer's new state exists) re-raises, as the
  reference's single-rung ladder does, leaves the live SSM state as it was
  before the step, and a second ``run`` gives the unfaulted tokens.
* Paged mode raises with the reference's message.
* Inside the reference (JAX only): its engine right-pads a 4-token prompt
  to a 16-token bucket and prefills the whole row, so the pad tokens enter
  the SSM state: the second token differs from ``lm_prefill`` and
  ``lm_decode`` on the unpadded prompt (ROADMAP section 3).  The port
  keeps that behaviour: its engine's tokens are the reference engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.infer import Engine as JEngine, Request as JRequest
from repro.models import build_model as jbuild
from repro.train import FaultPlan as JPlan

from repro_torch.configs import get_smoke_config
from repro_torch.infer import Engine, Request
from repro_torch.models import blocks, build_model, params_from_jax
from repro_torch.train import FaultPlan
from repro_torch.train.faults import FaultInjected
from test_torch_llama import POLICY, _serve

NAME = "mamba2-130m"
TOL = 1e-4
#: ragged prompts of the 16- and 32-token buckets, more than the slots
PROMPTS = ([5, 9, 2, 7], list(range(20, 37)), [3, 1, 4], [8, 6, 7, 5, 3])
NEWS = [5, 4, 6, 3]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pair():
    """(jax model, jax params, torch model, torch params on the CPU)."""
    jcfg = dataclasses.replace(jsmoke(NAME), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(NAME), dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


def _states_close(tst, jst):
    assert tst["caches"] is None and jst["caches"] is None
    for k in ("ssm", "conv"):
        t = tst["ssm"][k].float().numpy()
        j = np.asarray(jst["ssm"][k].astype(jnp.float32))
        assert t.shape == j.shape, k
        assert _rel(t, j) <= TOL, (k, _rel(t, j))


@pytest.mark.parametrize("policy", [None, POLICY])
def test_prefill_and_decode_match_jax(policy):
    jmodel, jparams, tmodel, tparams = pair()
    tpol = policy and policy.replace("int8_pallas", "int8_cuda")
    toks = np.random.RandomState(1).randint(0, 512, (2, 23)).astype(np.int32)
    jprefill = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, policy=policy, max_seq=32))
    jdecode = jax.jit(lambda p, st, t, pos: jmodel.decode(
        p, st, t, pos, policy=policy))
    jl, jst = jprefill(jparams, jnp.asarray(toks[:, :20]))
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(toks[:, :20]),
                             policy=tpol, max_seq=32)
    assert _rel(tl.numpy(), jl) <= TOL
    _states_close(tst, jst)
    for i in range(3):
        tok = toks[:, 20 + i:21 + i]
        jl, jst = jdecode(jparams, jst, jnp.asarray(tok),
                          jnp.full((2,), 20 + i, jnp.int32))
        before = {k: v.clone() for k, v in tst["ssm"].items()}
        given = tst
        tl, tst = tmodel.decode(tparams, tst, torch.from_numpy(tok),
                                torch.full((2,), 20 + i), policy=tpol)
        assert _rel(tl.numpy(), jl) <= TOL
        _states_close(tst, jst)
        for k, v in before.items():
            assert torch.equal(given["ssm"][k], v), k


def test_engine_tokens_match_jax():
    jmodel, jparams, tmodel, tparams = pair()
    kw = dict(max_slots=2, max_seq=64)
    plan = "nan_logit@2:slot=1"
    jeng = JEngine(jmodel, jparams, POLICY, **kw)
    jeng.fault_hooks = JPlan.parse(plan).engine_hooks()
    want = _serve(jeng, JRequest, PROMPTS, NEWS)
    teng = Engine(tmodel, tparams, POLICY.replace("int8_pallas", "int8_cuda"),
                  device="cpu", **kw)
    teng.fault_hooks = FaultPlan.parse(plan).engine_hooks()
    got = _serve(teng, Request, PROMPTS, NEWS)
    assert got == want
    assert [r for _, r in got].count("numerics") == 1
    assert teng.path_summary() == "weights=prepared-int8(plain) kv=none"
    assert jeng.path_summary() == "weights=prepared-int8 kv=none"
    assert teng.kv_cache_nbytes() == jeng.kv_cache_nbytes() > 0
    assert teng.kv_decode_read_bytes() == jeng.kv_decode_read_bytes() == 0
    rs, jrs = teng.resilience_summary(), jeng.resilience_summary()
    assert rs["rungs"] == jrs["rungs"] == ["none"]
    assert rs["quarantined"] == jrs["quarantined"] == 1
    assert not rs["demotions"]
    state = teng._state
    assert state["caches"] is None and set(state["ssm"]) == {"ssm", "conv"}
    assert tuple(state["ssm"]["ssm"].shape) == (2, 2, 8, 16, 16)


def test_failed_step_leaves_the_state_and_a_retry_gives_the_same_tokens(
        monkeypatch):
    _, _, tmodel, tparams = pair()
    policy = POLICY.replace("int8_pallas", "int8_cuda")
    kw = dict(max_slots=2, max_seq=64, device="cpu")
    want = _serve(Engine(tmodel, tparams, policy, **kw), Request, PROMPTS,
                  NEWS)

    eng = Engine(tmodel, tparams, policy, **kw)
    ids = [eng.submit(Request(tokens=p, max_new_tokens=n))
           for p, n in zip(PROMPTS, NEWS)]
    snaps = []
    call = eng._decode_call

    def snapshot(*args):
        snaps.append({k: v.clone() for k, v in eng._state["ssm"].items()})
        return call(*args)
    eng._decode_call = snapshot
    step = blocks.ssm_decode_step
    seen = []

    def failing(params, u, cfg, *, layer, **kw):
        seen.append(layer)
        if layer == cfg.n_layers - 1 and len(seen) == 2 * 3:
            raise FaultInjected("injected failure in the third step's "
                                "last layer")
        return step(params, u, cfg, layer=layer, **kw)
    monkeypatch.setattr(blocks, "ssm_decode_step", failing)
    with pytest.raises(FaultInjected):
        eng.run()
    assert seen == [0, 1] * 3
    # layer 0 had its new state when the step failed: the live state is
    # still the one the step started from
    for k, v in snaps[-1].items():
        assert torch.equal(eng._state["ssm"][k], v), k
    rs = eng.resilience_summary()
    assert rs["kernel_errors"] == 1 and rs["rung"] == "none"
    assert not rs["demotions"]
    out = {r.request_id: (r.tokens, r.finish_reason) for r in eng.run()}
    assert [out[i] for i in ids] == want


def test_paged_mode_raises_as_the_reference():
    jmodel, jparams, tmodel, tparams = pair()
    with pytest.raises(ValueError) as jerr:
        JEngine(jmodel, jparams, POLICY, paged=True, max_seq=64)
    with pytest.raises(ValueError) as terr:
        Engine(tmodel, tparams, POLICY.replace("int8_pallas", "int8_cuda"),
               paged=True, max_seq=64, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "carries SSM state" in str(terr.value)


def test_reference_padded_prefill_enters_the_ssm_state():
    """JAX only: the reference engine's second token for a 4-token prompt
    in a 16-token bucket differs from ``lm_prefill`` + ``lm_decode`` on
    the unpadded prompt, at the smoke size (its first token, read at the
    prompt's last position, agrees)."""
    jmodel, jparams, _, _ = pair()
    prompt = [5, 9, 2, 7]
    eng = JEngine(jmodel, jparams, None, max_slots=1, max_seq=32)
    eng.submit(JRequest(tokens=prompt, max_new_tokens=2))
    served = eng.run()[0].tokens
    vocab = jmodel.cfg.vocab_size
    lg, st = jmodel.prefill(jparams, {"tokens": jnp.asarray([prompt],
                                                            jnp.int32)})
    first = int(jnp.argmax(lg[0, :vocab]))
    lg, _ = jmodel.decode(jparams, st, jnp.asarray([[first]], jnp.int32),
                          jnp.asarray([len(prompt)], jnp.int32))
    second = int(jnp.argmax(lg[0, :vocab]))
    assert served[0] == first
    assert served[1] != second
