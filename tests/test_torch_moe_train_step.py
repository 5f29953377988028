"""The MoE family's train step, Trainer and launcher on the CPU, at the
smoke configs of both MoE models (granite-moe-3b-a800m and
phi3.5-moe-42b-a6.6b; the kernels' plain versions).

* One train step (float32 carrier, 2 x 64 tokens from the synthetic
  corpus, int moments, ``remat`` on in both packages) from the same
  JAX-initialized state at the true fan-in scale, against the JAX
  package's step, to the limits of ``tests/test_torch_train_step.py``:
  int moments on fp linears against the jitted step (``EXACT_LINEARS``),
  the W8A8G8 int8 route against the step under ``jax.disable_jit()``
  (``QUANT_LINEARS``; the jitted CPU reference contracts FMAs and its
  compiled quantizer flips payloads, ROADMAP section 3).  Readings on this
  tree are in the test's docstring.
* ``remat`` on and off: ce and every gradient bit-identical, on the int8
  route and under fake quant.
* The 8-bit moments of the (L, E, d, ff) expert leaves: the reference's
  blockwise layout (the leaf flattened into rows of 128), payloads and
  sidecars of the same shapes as the JAX state's.
* The Trainer: preempted after a step and resumed from its checkpoint, bit
  for bit the uninterrupted run; the launcher: finite steps, and a run
  preempted by ``sigterm_run@1`` that a second run resumes.
"""
import dataclasses
import math
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core.qpolicy import parse_policy as jparse_policy
from repro.data import SyntheticCorpus
from repro.models import build_model as jbuild
from repro.optim import OptConfig as JOpt
from repro.train import init_train_state as j_init, make_train_step as j_make

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core.qadam import QState
from repro_torch.core.qpolicy import parse_policy
from repro_torch.data import Loader, SyntheticCorpus as TCorpus
from repro_torch.models import (build_model, train_state_from_jax,
                                train_state_to_numpy)
from repro_torch.models.common import tree_flatten
from repro_torch.optim import OptConfig
from repro_torch.train import (FaultPlan, LoopConfig, Trainer,
                               init_train_state, make_train_step)
from repro_torch.train.step import value_and_grad

ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
INT_MOMENTS = "*=m1:8c-b128+m2:8c-asym-b128-sqrt"
INT8 = "*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda"
FAKE = "*=w8c+a8t+g8t"
#: tests/test_torch_train_step.py's limits: |d ce|, the gradient norm's
#: relative difference, the params' relative L2 distance
EXACT_LINEARS = {"ce": 5e-6, "grad_norm": 1e-5, "params": 3e-5}
QUANT_LINEARS = {"ce": 1e-3, "grad_norm": 1e-2, "params": 1e-2}
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100, state_storage="int")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _true_fan_in(params, n_layers):
    blocks = {mod: {n: (w * math.sqrt(n_layers / w.shape[-2])
                        if n.startswith("w") else w)
                    for n, w in leaves.items()}
              for mod, leaves in params["blocks"].items()}
    return dict(params, blocks=blocks)


def _rel_l2(a, b) -> float:
    num = sum(float(((np.asarray(x, np.float64) - y) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((np.asarray(y, np.float64) ** 2).sum()) for y in b)
    return math.sqrt(num / max(den, 1e-300))


@pytest.mark.parametrize("policy,eager,limits", [
    (INT_MOMENTS, False, EXACT_LINEARS), (INT8, True, QUANT_LINEARS)])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_smoke_train_step_matches_jax(name, policy, eager, limits):
    """Readings on this tree (|d ce|, grad norm, params): int moments on
    fp linears against the jitted step, granite 9.5e-7, 6.6e-7, 8.5e-7 and
    phi 4.8e-7, 1.9e-7, 4.1e-7; the int8 route against the eager step,
    granite 0, 1.1e-7, 3.7e-8 and phi 2.5e-4, 1.5e-5, 5.9e-4 (an int8
    payload on a rounding boundary)."""
    text = policy.replace("int8_cuda", "int8_pallas")
    jcfg = dataclasses.replace(jsmoke(name), dtype="float32", remat=True)
    tcfg = dataclasses.replace(tsmoke(name), dtype="float32", remat=True)
    jmodel, jrec = jbuild(jcfg), jparse_policy(text)
    jst = j_init(jmodel, jax.random.PRNGKey(0), jrec, JOpt(**OPT))
    jst = jst._replace(params=_true_fan_in(jst.params, jcfg.n_layers))
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tcfg, device="cpu")
    jstep = j_make(jmodel, jrec, JOpt(**OPT))
    if not eager:
        jstep = jax.jit(jstep)
    tstep = make_train_step(build_model(tcfg), parse_policy(policy),
                            OptConfig(**OPT))
    toks = SyntheticCorpus(jcfg.vocab_size, seed=7).batch(0, batch_size=2,
                                                          seq_len=64)
    with jax.disable_jit(eager):
        jst, jm = jstep(jst, {"tokens": jnp.asarray(toks)}, None)
    tst, tm = tstep(tst, {"tokens": torch.from_numpy(toks)})
    assert {"moe_aux", "moe_z"} <= set(tm)
    read = {"ce": abs(float(jm["ce"]) - float(tm["ce"])),
            "grad_norm": abs(float(jm["grad_norm"]) - float(tm["grad_norm"]))
            / float(jm["grad_norm"]),
            "params": _rel_l2(
                jax.tree_util.tree_leaves(train_state_to_numpy(tst).params),
                jax.tree_util.tree_leaves(
                    jax.tree_util.tree_map(np.asarray, jst.params)))}
    for key, lim in limits.items():
        assert read[key] <= lim, (key, read[key], lim)


@pytest.mark.parametrize("policy", [INT8, FAKE])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_remat_on_and_off_bit_identical(name, policy):
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tsmoke(name), remat=remat)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device="cpu")
        toks = torch.from_numpy(TCorpus(cfg.vocab_size, seed=7).batch(
            0, batch_size=2, seq_len=64))
        loss, _, grads = value_and_grad(model, policy, params,
                                        {"tokens": toks})
        out.append((loss, tree_flatten(grads)[0]))
    (l1, g1), (l2, g2) = out
    assert torch.isfinite(l1) and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("name", ARCHS)
def test_expert_moments_in_the_reference_layout(name):
    """The int moments of every leaf, the (L, E, d, ff) experts included,
    have the JAX state's payload and sidecar shapes (the leaf flattened
    into rows of 128, ``core/qadam.py``), and the experts' zero moments
    are the reference's payloads, scales and zero points."""
    jcfg, tcfg = jsmoke(name), tsmoke(name)
    jrec = jparse_policy(INT8.replace("int8_cuda", "int8_pallas"))
    jst = jax.tree_util.tree_map(np.asarray, j_init(
        jbuild(jcfg), jax.random.PRNGKey(0), jrec, JOpt(**OPT)))
    tst = init_train_state(build_model(tcfg),
                           torch.Generator().manual_seed(0),
                           parse_policy(INT8), OptConfig(**OPT),
                           device="cpu")
    tnp = train_state_to_numpy(tst)
    leaves = lambda t: jax.tree_util.tree_leaves(
        t, is_leaf=lambda x: isinstance(x, tuple))
    experts = 0
    for key in ("m1", "m2"):
        for jm, tm, p in zip(leaves(getattr(jst.opt, key)),
                             leaves(getattr(tnp.opt, key)),
                             tree_flatten(tst.params)[0]):
            assert [np.shape(a) for a in jm] == [np.shape(a) for a in tm]
            if p.dim() == 4:
                assert isinstance(tm, tuple)
                assert tm[0].shape == (-(-p.numel() // 128), 128)
                for a, b in zip(tm, jm):
                    np.testing.assert_array_equal(a, b)
                experts += 1
    assert experts == 2 * 3


def _trainer_parts(name):
    cfg = tsmoke(name)
    model = build_model(cfg)
    policy = parse_policy(INT8)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                    state_storage="int")
    state = init_train_state(model, torch.Generator().manual_seed(0), policy,
                             opt, device="cpu")
    loader = Loader(TCorpus(cfg.vocab_size, seed=7), cfg, batch_size=2,
                    seq_len=32)
    return make_train_step(model, policy, opt), state, loader


def test_moe_trainer_preemption_resume_bit_exact(tmp_path):
    """granite-moe-smoke through the Trainer on the int8 route for 6
    steps, against a run preempted after step 2 (``sigterm_run@2``) and
    resumed from its checkpoint: the same ce rows and bit-identical params
    and moments, the (L, E, d, ff) expert leaves and their 8-bit moments
    round-tripped through the checkpoint."""
    name = "granite-moe-3b-a800m"
    lcfg = dict(total_steps=6, ckpt_every=10 ** 9, log_every=1)
    step, state, loader = _trainer_parts(name)
    ref = Trainer(step, None, state, loader, loop_cfg=LoopConfig(**lcfg))
    ref_hist = ref.run()
    assert all(math.isfinite(r["ce"]) for r in ref_hist)

    step, state2, loader2 = _trainer_parts(name)
    faults = FaultPlan.parse("sigterm_run@2")
    mgr = CheckpointManager(str(tmp_path))
    t1 = Trainer(step, None, state2, loader2, ckpt=mgr,
                 loop_cfg=LoopConfig(**lcfg), faults=faults)
    old = signal.getsignal(signal.SIGTERM)
    try:
        t1.install_preemption_handler()
        t1.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert t1._preempted and mgr.all_steps() == [3]

    step, state3, loader3 = _trainer_parts(name)
    t2 = Trainer(step, None, state3, loader3, ckpt=mgr,
                 loop_cfg=LoopConfig(**lcfg))
    assert t2.maybe_resume() == 3
    t2.run()
    assert [r["ce"] for r in t2.history if r["step"] > 3] == \
        [r["ce"] for r in ref_hist if r["step"] > 3]
    a, b = train_state_to_numpy(ref.state), train_state_to_numpy(t2.state)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert any(isinstance(m, QState) and m.q.shape[0] > 1 for m in
               tree_flatten(t2.state.opt.m1)[0])


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_trains_moe_and_resumes(name, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <moe> --smoke --device
    cpu`` on the int8 route: finite rows; a run preempted by
    ``sigterm_run@1`` leaves a checkpoint that a second run resumes."""
    from repro_torch.launch import train as launcher
    args = ["--arch", name, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--state-storage", "int",
            "--policy", INT8, "--ckpt", str(tmp_path)]
    old = signal.getsignal(signal.SIGTERM)
    try:
        launcher.main(args + ["--fault", "sigterm_run@1"])
    finally:
        signal.signal(signal.SIGTERM, old)
    out = capsys.readouterr().out
    assert "train-path:" in out and "mlp_up" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    try:
        launcher.main(args)
    finally:
        signal.signal(signal.SIGTERM, old)
    out = capsys.readouterr().out
    ces = [float(v) for v in re.findall(r"\sce=(\S+)", out)]
    assert ces and all(math.isfinite(c) for c in ces), out
