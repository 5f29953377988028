"""Port parity of the guarded training system, against the JAX package on
the CPU: the stability sentinel, the fault grammar, the checkpoint manager
(format, protocol, each package verifying the other's checkpoints),
``fallback_policy``, the diagnostics behind ``health=``, the ``faults=`` hook
of the train step, and the Trainer itself.

Limits, each with its reading on this tree:

* the sentinel, the fault grammar and the checkpoint bytes are pure host
  logic: equal, verdict for verdict and byte for byte;
* the health counters of one train step (gpt2-mini, the int8 recipe,
  float32 carrier, weights at the true fan-in as in
  test_torch_train_step.py) against the jitted JAX step, three steps:
  ``grad_sat`` within 5e-4 absolute (a share of counted entries; readings
  0, 5.0e-5, 7.3e-6 at levels 0 to 7.0e-3) and ``grad_qerr`` within 3e-2
  relative (readings 5.7e-3, 7.1e-3, 1.3e-3: the int8 recipe's gradients
  differ by about 1e-3 between the packages, test_torch_train_step.py);
* the recovery ladder of ``tests/test_sentinel.py`` (``nan_grad@5``,
  window 8, min_history 2, skip_limit 1, fallback_steps 4, checkpoints
  every 3 steps, 12 steps) run by both Trainers on the smoke config with
  the int8 recipe: the same verdict at every loop step, the same counts
  and fallback rows -- and both equal ``chip_smoke.LADDER_EXPECT``, which
  the card's phase 11 is held to; ce within 0.1 of the JAX run at every
  logged row (readings: 1.4e-6 at the first row, at most 3.6e-2 over the
  15 rows at ce about 5.5; the bf16 carrier, the reference init and the
  int8 codecs turn last-bit differences into whole steps, as in
  test_torch_train_step.py);
* preemption (``sigterm_run@4``) and resume: bit for bit the uninterrupted
  port run, params and int8 moments included;
* the paper's recipe within 0.35 ce of fp after 30 smoke steps
  (``tests/test_system.py:42``; readings: fp 5.41, paper 5.41), and
  ``paper_wag8`` -- the G8 fake-quant path through the qdq kernels' plain
  versions -- finite and falling (readings 5.58 -> 5.41).
"""
import dataclasses
import math
import os
import pathlib
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointCorrupt as JCorrupt
from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_smoke_config as jsmoke
from repro.core import fallback_policy as j_fallback
from repro.core import parse_policy as jparse_policy
from repro.core.qconfig import get_recipe as jget_recipe
from repro.data import Loader as JLoader, SyntheticCorpus as JCorpus
from repro.models import build_model as jbuild
from repro.optim import OptConfig as JOpt
from repro.train import FaultPlan as JPlan
from repro.train import LoopConfig as JLoopConfig
from repro.train import SentinelConfig as JSentinelConfig
from repro.train import StabilitySentinel as JSentinel
from repro.train import Trainer as JTrainer
from repro.train import init_train_state as j_init
from repro.train import make_train_step as j_make

from repro_torch.checkpoint import CheckpointCorrupt, CheckpointManager
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import QState, as_policy, fallback_policy, parse_policy
from repro_torch.core import diagnostics
from repro_torch.core.qconfig import Granularity, QuantSpec, get_recipe
from repro_torch.data import Loader, SyntheticCorpus
from repro_torch.models import (build_model, train_state_from_jax,
                                train_state_to_numpy)
from repro_torch.models.common import tree_flatten
from repro_torch.optim import OptConfig, init_adam_state
from repro_torch.train import (FaultPlan, LoopConfig, SentinelConfig,
                               StabilitySentinel, Trainer, init_train_state,
                               make_train_step)
from repro_torch.train.faults import corrupt_checkpoint

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (constants and helpers; imports no torch)

MAIN = "*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_pallas"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the sentinel: scripted metric streams, verdict for verdict
# ---------------------------------------------------------------------------

NAN, INF = float("nan"), float("inf")


def _healthy(n, start=0, loss=2.0, gnorm=1.0, sat=0.05):
    return [(start + i, {"loss": loss, "grad_norm": gnorm, "grad_sat": sat})
            for i in range(n)]


#: (config overrides, stream of (step, metrics), rollbacks to notify as
#: {after stream index: restored step}) -- the cases of
#: tests/test_sentinel.py:108-198
STREAMS = {
    "healthy": ({}, _healthy(20), {}),
    "nonfinite": ({}, [(0, {"loss": NAN}),
                       (1, {"loss": 2.0, "grad_norm": INF})], {}),
    "loss_spike_unarmed": ({"min_history": 4}, [(0, {"loss": 50.0})], {}),
    "loss_spike": ({"min_history": 4},
                   _healthy(6) + [(6, {"loss": 50.0})], {}),
    "grad_norm_and_sat": ({"sat_threshold": 0.25}, _healthy(6) + [
        (6, {"loss": 2.0, "grad_norm": 100.0}),
        (7, {"loss": 2.0, "grad_norm": 1.0, "grad_sat": 0.5})], {}),
    "sat_step_change": ({"sat_threshold": 0.25}, _healthy(6, sat=0.3) + [
        (6, {"loss": 2.0, "grad_norm": 1.0, "grad_sat": 0.35}),
        (7, {"loss": 2.0, "grad_norm": 1.0, "grad_sat": 0.9}),
        (8, {"loss": 2.0, "grad_qerr": 0.1}), (9, {"grad_qerr": 0.1}),
        (10, {"grad_qerr": 0.1}), (11, {"grad_qerr": 0.1}),
        (12, {"grad_qerr": 0.9}), (13, {"grad_qerr": NAN})], {}),
    "escalate_then_fallback": (
        {"skip_limit": 2, "fallback_steps": 8},
        _healthy(6) + [(6 + i, {"loss": NAN}) for i in range(4)]
        + _healthy(8, start=10), {}),
    "budget_exhausts": (
        {"skip_limit": 0, "fallback_steps": 1, "max_rollbacks": 1},
        [(0, {"loss": NAN}), (5, {"loss": NAN}), (9, {"loss": NAN})], {}),
    "notify_rollback": ({"skip_limit": 0, "fallback_steps": 8},
                        [(20, {"loss": NAN}), (25, {"loss": 2.0})],
                        {0: 25}),
}


def _sentinel_cfg(**kw):
    base = dict(window=16, min_history=4, spike_sigma=6.0, spike_floor=0.5,
                skip_limit=2, fallback_steps=8, max_rollbacks=2)
    base.update(kw)
    return base


@pytest.mark.parametrize("case", list(STREAMS))
def test_sentinel_verdicts_equal_jax(case):
    over, stream, notify = STREAMS[case]
    kw = _sentinel_cfg(**over)
    ts, js = StabilitySentinel(SentinelConfig(**kw)), \
        JSentinel(JSentinelConfig(**kw))
    for i, (step, metrics) in enumerate(stream):
        tv, jv = ts.observe(step, dict(metrics)), js.observe(step,
                                                             dict(metrics))
        assert tv.value == jv.value, (case, step)
        assert ts.last_reasons == js.last_reasons
        assert ts.in_fallback(step + 1) == js.in_fallback(step + 1)
        if i in notify:
            ts.notify_rollback(notify[i])
            js.notify_rollback(notify[i])
    assert ts.summary() == js.summary()
    assert ts.counts["observed"] == len(stream)


# ---------------------------------------------------------------------------
# the fault grammar and the gradient hook
# ---------------------------------------------------------------------------

GOOD = ["nan_grad@3; sat_grad@5:factor=1e7 ;corrupt_ckpt@1:mode=truncate;"
        "sigterm_save@2;dead_sched@4", "", "sigterm_run@4\nnan_grad@0",
        "kernel_error@2;nan_logit@1:slot=3;oom_pages@0:hold=4,x=1",
        "slow_step@7:ms=5;corrupt_ckpt@2:mode=manifest"]
BAD = ["nan_grad", "frobnicate@3", "nan_grad@x", "nan_grad@3:factor",
       "corrupt_ckpt@1:mode=shred"]


@pytest.mark.parametrize("spec", GOOD)
def test_fault_plan_parses_as_jax(spec):
    t, j = FaultPlan.parse(spec), JPlan.parse(spec)
    assert [(f.kind, f.at, f.args) for f in t.faults] == \
        [(f.kind, f.at, f.args) for f in j.faults]
    assert t.describe() == j.describe()
    assert bool(t) == bool(j)
    assert t.has_grad_faults() == j.has_grad_faults()
    assert t.grad_fault_steps() == j.grad_fault_steps()


@pytest.mark.parametrize("spec", BAD)
def test_fault_plan_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        JPlan.parse(spec)
    with pytest.raises(ValueError):
        FaultPlan.parse(spec)


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT", "nan_grad@2")
    assert FaultPlan.from_env().describe() == "nan_grad@2"
    assert FaultPlan.from_env("sat_grad@1").describe() == "sat_grad@1"


def test_grad_fault_fires_only_at_its_step():
    plan = FaultPlan.parse("nan_grad@3;sat_grad@5:factor=10")
    g = torch.randn(2, 3)
    grads = {"w": g, "b": {"c": g.bfloat16()}}
    ok = plan.apply_grads(torch.tensor(2, dtype=torch.int32), grads)
    assert torch.equal(ok["w"], g) and torch.equal(ok["b"]["c"], g.bfloat16())
    nan = plan.apply_grads(torch.tensor(3, dtype=torch.int32), grads)
    assert bool(nan["w"].isnan().all()) and nan["b"]["c"].dtype == \
        torch.bfloat16
    sat = plan.apply_grads(torch.tensor(5, dtype=torch.int32), grads)
    assert torch.equal(sat["w"], g * 10.0)
    assert FaultPlan.parse("sigterm_run@1").apply_grads(
        torch.tensor(1), grads) is grads


def test_note_step_marks_fired_and_delivers_sigterm():
    plan = FaultPlan.parse("nan_grad@2;sigterm_run@4")
    hits = []
    old = signal.signal(signal.SIGTERM, lambda *_: hits.append(True))
    try:
        for s in range(6):
            plan.note_step(s)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert hits == [True]
    assert plan.fired == ["nan_grad@2", "sigterm_run@4"]


def test_scheduler_hook_and_engine_faults():
    from repro_torch.train import FaultInjected
    plan = FaultPlan.parse("dead_sched@2")
    hook = plan.scheduler_hook()
    hook(0)
    hook(1)
    with pytest.raises(FaultInjected):
        hook(2)
    hook(2)                                   # one-shot
    assert plan.fired == ["dead_sched@2"]
    assert FaultPlan.parse("nan_grad@1").scheduler_hook() is None
    assert FaultPlan.parse("nan_grad@1").engine_hooks() is None
    with pytest.raises(NotImplementedError, match="ROADMAP section 1, item 2"):
        FaultPlan.parse("kernel_error@3").engine_hooks()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.int32)}}


def _zeros_like(tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda x: QState(*map(torch.zeros_like, x))
                    if isinstance(x, QState) else torch.zeros_like(x), tree)


def _equal_trees(a, b):
    from repro_torch.checkpoint.manager import _flatten
    fa, fb = _flatten(a), _flatten(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, n
        assert torch.equal(x, y), n


def test_roundtrip_rotation_and_metadata(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), metadata={"note": s})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    got, meta = mgr.restore(4, _zeros_like(_tree()))
    _equal_trees(got, _tree())
    assert meta == {"note": 4}
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(4, {"a": torch.zeros(2, 2),
                        "nested": {"b": torch.zeros(5, dtype=torch.int32)}})
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore(4, {"a": torch.zeros(3, 4, dtype=torch.float64),
                        "nested": {"b": torch.zeros(5, dtype=torch.int32)}})


def test_async_write_and_error_propagation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, _tree())
    mgr.wait()
    assert mgr.all_steps() == [1]

    def boom(step):
        raise RuntimeError("disk on fire")

    mgr.on_mid_write = boom
    mgr.save(2, _tree())                 # the doomed background write
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.save(3, _tree())             # joins and re-raises first
    mgr.on_mid_write = None
    mgr.save(4, _tree())
    mgr.wait()
    assert mgr.all_steps() == [1, 4]


@pytest.mark.parametrize("mode", ["flip", "truncate", "manifest"])
def test_damage_detected_and_rotation_falls_back(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path))
    t1 = {"a": torch.arange(4096.0).reshape(64, 64),
          "nested": {"b": torch.ones(5, dtype=torch.int32)}}
    t2 = {"a": t1["a"] + 1, "nested": {"b": t1["nested"]["b"] + 1}}
    mgr.save(1, t1)
    mgr.save(2, t2)
    corrupt_checkpoint(mgr._ckpt_dir(2), mode=mode)
    with pytest.raises(CheckpointCorrupt):
        mgr.verify(2)
    got, _, step = mgr.restore_latest(_zeros_like(t1))
    assert step == 1
    _equal_trees(got, t1)
    # the JAX manager sees the same damage in the same files
    with pytest.raises(JCorrupt):
        JManager(str(tmp_path)).verify(2)


def test_missing_commit_and_mid_save_abort(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    os.remove(os.path.join(mgr._ckpt_dir(1), "COMMIT"))
    with pytest.raises(CheckpointCorrupt, match="COMMIT"):
        mgr.verify(1)
    with pytest.raises(CheckpointCorrupt):
        mgr.restore_latest(_zeros_like(_tree()))

    def die(step):
        raise KeyboardInterrupt("preempted mid-save")
    mgr.on_mid_write = die
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, _tree())
    assert not os.path.isdir(mgr._ckpt_dir(2))
    assert len(mgr.prune_incomplete()) == 1


def test_rotation_never_deletes_checkpoint_being_read(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=1)
    mgr.save(1, _tree())
    mgr._reading.add(1)
    mgr.save(2, _tree())
    mgr.save(3, _tree())
    assert os.path.isdir(mgr._ckpt_dir(1))
    assert not os.path.isdir(mgr._ckpt_dir(2))
    mgr._reading.discard(1)
    mgr.save(4, _tree())
    assert mgr.all_steps() == [4]


def test_sigterm_mid_save_keeps_atomicity(tmp_path):
    plan = FaultPlan.parse("sigterm_save@1;corrupt_ckpt@1")
    mgr = CheckpointManager(str(tmp_path))
    plan.install(mgr)

    def raise_term(signum, frame):
        raise RuntimeError("SIGTERM")
    old = signal.signal(signal.SIGTERM, raise_term)
    try:
        with pytest.raises(RuntimeError, match="SIGTERM"):
            mgr.save(1, _tree())
    finally:
        signal.signal(signal.SIGTERM, old)
    assert mgr.all_steps() == []
    big = {"a": torch.arange(4096.0).reshape(64, 64)}
    mgr.save(2, big)                      # the first completed save ...
    with pytest.raises(CheckpointCorrupt):
        mgr.verify(2)                     # ... is the one corrupt_ckpt@1 hits
    assert plan.fired == ["sigterm_save@1", "corrupt_ckpt@1"]


def test_qstate_and_bfloat16_leaves_round_trip_bit_exact(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"m1": QState(q=torch.from_numpy(rng.randint(-128, 128, (8, 16)
                                                         ).astype(np.int8)),
                         scale=torch.from_numpy(rng.rand(8, 1)
                                                .astype(np.float32)),
                         zero=torch.zeros(8, 1)),
            "w": torch.linspace(-1.0, 1.0, 32).reshape(4, 8),
            "h": torch.randn(3, 5).bfloat16()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    manifest = mgr.verify(1)
    assert manifest["leaves"]["h"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["m1/q"]["dtype"] == "int8"
    got, _ = mgr.restore(1, _zeros_like(tree))
    assert isinstance(got["m1"], QState)
    _equal_trees(got, tree)


def _jax_state():
    cfg = jsmoke("gpt2-small")
    rec = jparse_policy(MAIN)
    opt = JOpt(lr=1e-3, warmup_steps=2, total_steps=100, state_storage="int")
    return cfg, rec, opt, j_init(jbuild(cfg), jax.random.PRNGKey(0), rec, opt)


def test_train_state_leaves_are_fp32_int8_int32():
    """What a checkpoint of the port's TrainState holds: fp32 masters, int8
    payloads, fp32 sidecars and the int32 step -- no bfloat16 leaf."""
    from repro_torch.checkpoint.manager import _flatten
    _, _, _, jst = _jax_state()
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tsmoke("gpt2-small"), device="cpu")
    dtypes = {t.dtype for _, t in _flatten(tst)}
    assert dtypes == {torch.float32, torch.int8, torch.int32}


def test_checkpoints_cross_frameworks(tmp_path):
    """A JAX-written TrainState checkpoint verifies and restores in the
    port (the leaf names match), and a port-written one verifies and
    restores in the JAX manager; each restores bit for bit."""
    _, _, _, jst = _jax_state()
    np_state = jax.tree_util.tree_map(np.asarray, jst)
    tst = train_state_from_jax(np_state, tsmoke("gpt2-small"), device="cpu")
    JManager(str(tmp_path / "j")).save(3, jst, metadata={"loader": {"step": 3}})
    port = CheckpointManager(str(tmp_path / "j"))
    assert port.verify(3)["metadata"] == {"loader": {"step": 3}}
    got, meta, step = port.restore_latest(tst)
    assert step == 3 and meta["loader"] == {"step": 3}
    _equal_trees(got, tst)

    CheckpointManager(str(tmp_path / "t")).save(5, tst, metadata={"k": 1})
    jm = JManager(str(tmp_path / "t"))
    assert jm.verify(5)["metadata"] == {"k": 1}
    jgot, _ = jm.restore(5, jst)
    for a, b in zip(jax.tree_util.tree_leaves(jgot),
                    jax.tree_util.tree_leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# fallback_policy and the diagnostics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fake_quant", "fp"])
@pytest.mark.parametrize("primary", [MAIN, "beyond"])
def test_fallback_policy_keeps_adam_state_structure(primary, mode):
    tp = parse_policy(primary) if "=" in primary else get_recipe(primary)
    jp = jparse_policy(primary) if "=" in primary else jget_recipe(primary)
    degraded = fallback_policy(tp, mode=mode)
    assert degraded.describe() == j_fallback(jp, mode=mode).describe()
    params = build_model(tsmoke("gpt2-small")).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    opt = OptConfig(state_storage="int")
    a = tree_flatten(init_adam_state(params, as_policy(tp), opt).m1)[0]
    b = tree_flatten(init_adam_state(params, degraded, opt).m1)[0]
    for x, y in zip(a, b):
        assert type(x) is type(y)
        xs = list(x) if isinstance(x, QState) else [x]
        ys = list(y) if isinstance(y, QState) else [y]
        assert [(t.shape, t.dtype) for t in xs] == \
            [(t.shape, t.dtype) for t in ys]
    for role in ("attn_qkv", "mlp_up"):
        backend, _ = degraded.effective_backend(role)
        assert backend in ("fp", "fake_quant")
    with pytest.raises(ValueError):
        fallback_policy(tp, mode="int8")


def test_moment_saturation_rate_counts_overflow():
    spec = QuantSpec(8, Granularity.PER_CHANNEL, block_size=4)
    g = torch.full((2, 4), 10.0)
    m = QState(q=torch.zeros(2, 4, dtype=torch.int8),
               scale=torch.full((2, 1), 0.001), zero=torch.zeros(2, 1))
    rate = diagnostics.moment_saturation_rate
    assert float(rate({"w": g}, {"w": m}, spec)) == 1.0
    ok = QState(q=m.q, scale=torch.ones(2, 1), zero=m.zero)
    assert float(rate({"w": g}, {"w": ok}, spec)) == 0.0
    fresh = QState(q=m.q, scale=torch.zeros(2, 1), zero=m.zero)
    assert float(rate({"w": g}, {"w": fresh}, spec)) == 0.0
    assert rate({"w": g}, {"w": g}, spec) is None
    assert rate({"w": g}, {"w": m}, None) is None


def test_diagnostics_match_jax():
    from repro.core import diagnostics as jd
    from repro.core.qconfig import QuantSpec as JSpec, Granularity as JG
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 48) * np.linspace(0.1, 3, 48)).astype(np.float32)
    spec, jspec = QuantSpec(8, Granularity.PER_TOKEN), JSpec(8, JG.PER_TOKEN)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (diagnostics.gradient_sparsity(xt, 0.05), jd.gradient_sparsity(xj,
                                                                        0.05)),
        (diagnostics.zero_bin_fraction(xt, spec),
         jd.zero_bin_fraction(xj, jspec)),
        (diagnostics.quant_snr_db(xt, spec), jd.quant_snr_db(xj, jspec)),
        (diagnostics.relative_quant_error(xt, spec),
         jd.relative_quant_error(xj, jspec)),
        (diagnostics.saturation_rate(xt, spec, torch.full((64, 1), 0.01)),
         jd.saturation_rate(xj, jspec, jnp.full((64, 1), 0.01))),
    ]
    ts, js = diagnostics.channel_outlier_stats(xt), jd.channel_outlier_stats(xj)
    pairs += [(ts[k], js[k]) for k in ts]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)


def test_m_sharpness_is_seeded_and_non_negative_at_zero_radius():
    params = {"w": torch.randn(4, 3)}
    batch = torch.randn(5, 4)

    def loss(p, b):
        return torch.sum((b @ p["w"]) ** 2)
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    a = diagnostics.m_sharpness(loss, params, batch, g1, rho=0.1)
    b = diagnostics.m_sharpness(loss, params, batch, g2, rho=0.1)
    assert torch.equal(a, b)
    assert float(diagnostics.m_sharpness(loss, params, batch, g1,
                                         rho=0.0)) == 0.0


# ---------------------------------------------------------------------------
# the train step's health= and faults= hooks
# ---------------------------------------------------------------------------

def test_health_counters_match_jax():
    jcfg = dataclasses.replace(jsmoke("gpt2-small"), dtype="float32")
    tcfg = dataclasses.replace(tsmoke("gpt2-small"), dtype="float32")
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=100, state_storage="int")
    jrec, trec = jparse_policy(MAIN), parse_policy(MAIN)
    jmodel = jbuild(jcfg)
    jst = j_init(jmodel, jax.random.PRNGKey(0), jrec, JOpt(**kw))
    jst = jst._replace(params=chip_smoke.true_fan_in(jst.params, jcfg))
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tcfg, device="cpu")
    jstep = jax.jit(j_make(jmodel, jrec, JOpt(**kw), health=True))
    tstep = make_train_step(build_model(tcfg), trec, OptConfig(**kw),
                            health=True)
    corpus = SyntheticCorpus(tcfg.vocab_size, seed=7)
    for i in range(3):
        toks = corpus.batch(i, batch_size=2, seq_len=64)
        jst, jm = jstep(jst, {"tokens": jnp.asarray(toks)}, None)
        tst, tm = tstep(tst, {"tokens": torch.from_numpy(toks)})
        assert set(jm) == set(tm)
        assert abs(float(tm["grad_sat"]) - float(jm["grad_sat"])) <= 5e-4
        assert abs(float(tm["grad_qerr"]) - float(jm["grad_qerr"])) <= \
            3e-2 * float(jm["grad_qerr"])


def test_grad_faults_in_the_train_step_are_a_no_op_elsewhere():
    cfg = tsmoke("gpt2-small")
    model = build_model(cfg)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                    state_storage="int")
    pol = parse_policy(MAIN)
    toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=2, seq_len=32))
    state = init_train_state(model, torch.Generator().manual_seed(0), pol,
                             opt, device="cpu")
    plain = make_train_step(model, pol, opt)
    planned = make_train_step(model, pol, opt,
                              faults=FaultPlan.parse("nan_grad@1"))
    a, ma = plain(state, {"tokens": toks})
    b, mb = planned(state, {"tokens": toks})         # step 0: no-op
    for x, y in zip(tree_flatten(a.params)[0], tree_flatten(b.params)[0]):
        assert torch.equal(x, y)
    assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    _, mc = planned(b, {"tokens": toks})              # step 1: NaN
    assert math.isnan(float(mc["grad_norm"]))
    assert math.isfinite(float(mc["ce"]))


# ---------------------------------------------------------------------------
# the Trainer: the recovery ladder in both packages, preemption and resume
# ---------------------------------------------------------------------------

def _ladder_jax(tmp):
    cfg, rec, opt, state = _jax_state()
    model = jbuild(cfg)
    loader = JLoader(JCorpus(cfg.vocab_size, seed=7), cfg, batch_size=4,
                     seq_len=32)
    faults = JPlan.parse(chip_smoke.LADDER_FAULT)
    step = jax.jit(j_make(model, rec, opt, faults=faults, health=True))
    fb = jax.jit(j_make(model, j_fallback(rec), opt, health=True))
    log = []
    sentinel = chip_smoke.recording(JSentinel(JSentinelConfig(
        **chip_smoke.LADDER_SENTINEL)), log)
    t = JTrainer(step, None, state, loader, ckpt=JManager(str(tmp)),
                 loop_cfg=JLoopConfig(total_steps=chip_smoke.LADDER_STEPS,
                                      ckpt_every=chip_smoke.LADDER_CKPT_EVERY,
                                      log_every=1),
                 sentinel=sentinel, fallback_step=fb, faults=faults)
    t.run(rng=jax.random.PRNGKey(0))
    return t, log, state


def _ladder_port(tmp, jstate):
    cfg = tsmoke("gpt2-small")
    model = build_model(cfg)
    pol = parse_policy(MAIN)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                    state_storage="int")
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 cfg, device="cpu")
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=4, seq_len=32)
    faults = FaultPlan.parse(chip_smoke.LADDER_FAULT)
    step = make_train_step(model, pol, opt, faults=faults, health=True)
    fb = make_train_step(model, fallback_policy(pol), opt, health=True)
    log = []
    sentinel = chip_smoke.recording(StabilitySentinel(SentinelConfig(
        **chip_smoke.LADDER_SENTINEL)), log)
    t = Trainer(step, None, state, loader, ckpt=CheckpointManager(str(tmp)),
                loop_cfg=LoopConfig(total_steps=chip_smoke.LADDER_STEPS,
                                    ckpt_every=chip_smoke.LADDER_CKPT_EVERY,
                                    log_every=1),
                sentinel=sentinel, fallback_step=fb, faults=faults)
    t.run()
    return t, log


def test_recovery_ladder_matches_jax_and_the_card_constant(tmp_path):
    jt, jlog, jstate = _ladder_jax(tmp_path / "jax")
    tt, tlog = _ladder_port(tmp_path / "port", jstate)
    jrec = chip_smoke.ladder_record(jt.resilience_summary(), jt.history,
                                    jlog)
    trec = chip_smoke.ladder_record(tt.resilience_summary(), tt.history,
                                    tlog)
    assert jrec == chip_smoke.LADDER_EXPECT
    assert trec == jrec
    js, ts = jt.resilience_summary(), tt.resilience_summary()
    assert ts == js                      # fired faults and flags included
    assert [(r["step"], r.get("fallback")) for r in tt.history] == \
        [(r["step"], r.get("fallback")) for r in jt.history]
    d = [abs(a["ce"] - b["ce"]) for a, b in zip(tt.history, jt.history)]
    assert max(d) <= 0.1, d
    assert int(tt.state.opt.step) == chip_smoke.LADDER_STEPS
    for leaf in tree_flatten(tt.state.params)[0]:
        assert bool(torch.isfinite(leaf).all())


def _preempt_parts():
    cfg = tsmoke("gpt2-small")
    model = build_model(cfg)
    pol = get_recipe("beyond")
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                    state_storage="int")
    state = init_train_state(model, torch.Generator().manual_seed(0), pol,
                             opt, device="cpu")
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=4, seq_len=32)
    return make_train_step(model, pol, opt), state, loader


def test_preemption_resume_bit_exact(tmp_path):
    step, state, loader = _preempt_parts()
    lcfg = dict(total_steps=10, ckpt_every=10 ** 9, log_every=1)
    ref = Trainer(step, None, state, loader, loop_cfg=LoopConfig(**lcfg))
    ref_hist = ref.run()

    step, state2, loader2 = _preempt_parts()
    faults = FaultPlan.parse("sigterm_run@4")
    mgr = CheckpointManager(str(tmp_path))
    t1 = Trainer(step, None, state2, loader2, ckpt=mgr,
                 loop_cfg=LoopConfig(**lcfg), faults=faults)
    old = signal.getsignal(signal.SIGTERM)
    try:
        t1.install_preemption_handler()
        t1.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert t1._preempted and faults.fired == ["sigterm_run@4"]
    assert mgr.all_steps() == [5]

    step, state3, loader3 = _preempt_parts()
    t2 = Trainer(step, None, state3, loader3, ckpt=mgr,
                 loop_cfg=LoopConfig(**lcfg))
    assert t2.maybe_resume() == 5
    t2.run()
    assert [r["ce"] for r in t2.history if r["step"] > 5] == \
        [r["ce"] for r in ref_hist if r["step"] > 5]
    a, b = train_state_to_numpy(ref.state), train_state_to_numpy(t2.state)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_trainer_evaluates_and_degrades_without_checkpoint():
    """No checkpoint to roll back to: the ladder degrades to skip and the
    fallback window; the validation rows carry valid_ce."""
    cfg = tsmoke("gpt2-small")
    model = build_model(cfg)
    pol = parse_policy(MAIN)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                    state_storage="int")
    corpus = SyntheticCorpus(cfg.vocab_size, seed=7)
    from repro_torch.train import make_eval_step
    faults = FaultPlan.parse("nan_grad@3")
    t = Trainer(make_train_step(model, pol, opt, faults=faults, health=True),
                make_eval_step(model, pol),
                init_train_state(model, torch.Generator().manual_seed(0),
                                 pol, opt, device="cpu"),
                Loader(corpus, cfg, batch_size=4, seq_len=32),
                valid_loader=Loader(corpus, cfg, batch_size=4, seq_len=32,
                                    split="valid"),
                loop_cfg=LoopConfig(total_steps=8, ckpt_every=10 ** 9,
                                    eval_every=4, eval_batches=2,
                                    log_every=1),
                sentinel=StabilitySentinel(SentinelConfig(
                    window=8, min_history=2, skip_limit=0,
                    fallback_steps=4)),
                fallback_step=make_train_step(model, fallback_policy(pol),
                                              opt, health=True),
                faults=faults)
    t.run()
    s = t.resilience_summary()
    assert s["skipped_batches"] >= 1 and s["restores"] == 0
    assert s["rollback_failures"] == 1
    assert [r["step"] for r in t.history if "valid_ce" in r] == [4, 8]
    assert all(math.isfinite(r["valid_ce"]) for r in t.history
               if "valid_ce" in r)
    for leaf in tree_flatten(t.state.params)[0]:
        assert bool(torch.isfinite(leaf).all())


# ---------------------------------------------------------------------------
# the port's form of tests/test_system.py:42
# ---------------------------------------------------------------------------

def _train(recipe, steps=30):
    cfg = tsmoke("gpt2-small")
    model = build_model(cfg)
    opt = OptConfig(lr=2e-3, warmup_steps=5, total_steps=max(steps, 10))
    state = init_train_state(model, torch.Generator().manual_seed(0), recipe,
                             opt, device="cpu")
    step = make_train_step(model, recipe, opt)
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=8, seq_len=64)
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(next(loader)
                                                           ["tokens"])})
        losses.append(float(m["ce"]))
    return losses


def test_paper_recipe_trains_comparably_to_fp_and_wag8_learns():
    fp = _train(get_recipe("fp"))
    q = _train(get_recipe("paper"))
    g8 = _train(get_recipe("paper_wag8"))
    assert q[-1] < q[0] - 0.15
    assert abs(q[-1] - fp[-1]) < 0.35, (fp[-1], q[-1])
    assert all(math.isfinite(v) for v in g8)
    assert g8[-1] < g8[0] - 0.15, (g8[0], g8[-1])
