"""The hybrid family (zamba2) trained: ``lm_loss`` and its gradients, the
train step, the recomputation, the 8-bit moments' layout, the launcher and
the checkpoint format, on the zamba2 smoke config (4 SSM layers, the
shared block after every 2nd: two invocations) against the JAX package
(parameters carried across from the JAX init; the int8 kernels' plain
versions here, Pallas in interpret mode on the JAX side).

* ``lm_loss`` and ``jax.value_and_grad`` of the reference's, float32
  carrier, 2 x 64 tokens, weights at the true fan-in scale
  (``chip_smoke.true_fan_in``: at the reference init, std 1/sqrt(L) on
  the stacked leaves, the random model's int8 route reads 0.10 apart).
  Under fp linears |d loss| <= 1e-5 and every gradient within 2e-4 of its
  largest entry and in relative L2, the SSM family's limits (readings on
  this tree: |d loss| 1.4e-6, gradients 3.7e-6 to 3.9e-5 relative, 6.4e-5
  of the largest: the SSD's chunked sums run in another order, and the
  shared block carries them through both invocations into every leaf).  Under
  ``*=w8c+a8t+g8t@int8_pallas`` (every block linear on #3, #4 and #5)
  |d loss| <= 1e-3 (reading 5.7e-5), each gradient's relative L2 distance
  within 6e-2 and all of them together within 4e-2 (readings 3.5e-3 to
  3.4e-2, together 2.5e-2, about the same in every leaf: XLA's jitted
  quantizer flips about one int8 payload in 10^4 against the port's op by
  op rounding, ROADMAP section 3, and the per-token gradient codecs of
  two shared-block invocations on a 128-wide concat carry each flip into
  every gradient; the fake-quant routes of the two packages read 3e-4 to
  0.13 apart at seeds 0-2).  The ``shared`` leaves' gradients are each the
  sum over both invocations.
* ``remat`` on and off: ce and every gradient bit-identical (the int8
  route, fake quant, fp), and the shared block's linears launch again in
  the recomputation, so #3 runs twice a step.
* One train step with int moments (fp linears) from the same JAX state,
  against the jitted JAX step: |d ce| <= 5e-6, the grad norm within 5e-5
  relative, the params within 3e-5 in relative L2 (``SSM_EXACT`` of
  ``test_torch_ssm_train.py``; readings in ``test_train_step_matches_jax``'s
  docstring).
* The moments: which leaves take blockwise int moments and their shapes,
  against the JAX state; the 2-D ``shared`` weights take them, (L, H)
  ``A_log``, ``dt_bias`` and ``D`` keep fp ones below 4,096 elements (at
  Zamba2-2.7B's 54 x 80 they cross it and take int ones, in both
  packages).
* The launcher's ``--smoke`` run, and a train state written by either
  package's checkpoint manager restored by the other bit for bit.
"""
import dataclasses
import importlib
import math
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_smoke_config as jsmoke
from repro.core.qpolicy import parse_policy as jparse_policy
from repro.data import SyntheticCorpus
from repro.models import build_model as jbuild
from repro.models.lm import lm_loss as jlm_loss
from repro.optim import OptConfig as JOpt
from repro.train import init_train_state as j_init, make_train_step as j_make

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config as tsmoke
from repro_torch.core.qadam import QState, quantizable
from repro_torch.core.qpolicy import parse_policy
from repro_torch.data import SyntheticCorpus as TCorpus
from repro_torch.models import (build_model, params_from_jax,
                                train_state_from_jax, train_state_to_numpy)
from repro_torch.models.common import tree_flatten
from repro_torch.models.lm import lm_loss
from repro_torch.models.model_api import _spec
from repro_torch.optim import OptConfig
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.step import value_and_grad
from test_torch_moe_train_step import (FAKE, INT8, INT_MOMENTS, OPT,
                                       _rel_l2)
from test_torch_ssm_train import SSM_EXACT

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (constants and helpers; imports no torch)

#: the module of #3's wrapper (the package exports the wrapper under the
#: module's name)
i8 = importlib.import_module("repro_torch.kernels.int8_matmul")
NAME = "zamba2-2.7b"
G8 = "*=w8c+a8t+g8t@int8_pallas"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    return (dataclasses.replace(jsmoke(NAME), dtype="float32", **kw),
            dataclasses.replace(tsmoke(NAME), dtype="float32", **kw))


@pytest.mark.parametrize("policy", [None, G8])
def test_lm_loss_and_gradients_match_jax(policy):
    jcfg, tcfg = _cfgs()
    jparams = chip_smoke.true_fan_in(
        jbuild(jcfg).init_params(jax.random.PRNGKey(0)), jcfg)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size,
                                            (2, 65)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, {"tokens": jnp.asarray(toks)}, jcfg,
                           policy=policy), has_aux=True))(jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    leaves, _ = tree_flatten(tparams)
    for t in leaves:
        t.requires_grad_()
    tl, _ = lm_loss(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                    policy=policy and policy.replace("pallas", "cuda"))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= (1e-5 if policy is None else 1e-3)
    jleaves = jax.tree_util.tree_leaves(jg)
    # 12 SSM-layer leaves, embed, final_norm and the shared block's 10
    assert len(jleaves) == len(leaves) == 24
    assert {k for k in tparams["shared"]} == {"ln1", "attn", "ln2", "mlp",
                                              "proj"}
    got = [t.grad.numpy().astype(np.float64) for t in leaves]
    want = [np.asarray(j, np.float64) for j in jleaves]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        if policy is None:
            assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max()
            assert rel <= 2e-4
        else:
            assert rel <= 6e-2, (g.shape, rel)
    if policy is not None:
        assert _rel_l2(got, want) <= 4e-2


@pytest.mark.parametrize("policy", [INT8, FAKE, "*=fp"])
def test_remat_on_and_off_bit_identical(policy, monkeypatch):
    calls = []
    plain = i8.int8_matmul_plain
    monkeypatch.setattr(i8, "int8_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tsmoke(NAME), remat=remat)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device="cpu")
        toks = torch.from_numpy(TCorpus(cfg.vocab_size, seed=7).batch(
            0, batch_size=2, seq_len=128))
        calls.clear()
        loss, _, grads = value_and_grad(model, policy, params,
                                        {"tokens": toks})
        out.append((loss, tree_flatten(grads)[0], len(calls)))
    (l1, g1, n1), (l2, g2, n2) = out
    assert torch.isfinite(l1) and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    # #3's plain version (what its wrapper runs on the CPU): 5 projections
    # a layer and 8 shared-block linears an invocation, again under
    # recomputation
    linears = 5 * 4 + 8 * 2
    assert (n1, n2) == ((2 * linears, linears) if policy == INT8 else (0, 0))


def test_train_step_matches_jax():
    """Int moments, fp linears (readings on this tree: |d ce| 4.8e-7, grad
    norm 5.3e-6 relative, params 3.3e-6)."""
    jcfg, tcfg = _cfgs(remat=True)
    jmodel, jrec = jbuild(jcfg), jparse_policy(INT_MOMENTS)
    jst = j_init(jmodel, jax.random.PRNGKey(0), jrec, JOpt(**OPT))
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tcfg, device="cpu")
    tstep = make_train_step(build_model(tcfg), parse_policy(INT_MOMENTS),
                            OptConfig(**OPT))
    toks = SyntheticCorpus(jcfg.vocab_size, seed=7).batch(0, batch_size=2,
                                                          seq_len=64)
    jst, jm = jax.jit(j_make(jmodel, jrec, JOpt(**OPT)))(
        jst, {"tokens": jnp.asarray(toks)}, None)
    tst, tm = tstep(tst, {"tokens": torch.from_numpy(toks)})
    read = {"ce": abs(float(jm["ce"]) - float(tm["ce"])),
            "grad_norm": abs(float(jm["grad_norm"]) - float(tm["grad_norm"]))
            / float(jm["grad_norm"]),
            "params": _rel_l2(
                jax.tree_util.tree_leaves(train_state_to_numpy(tst).params),
                jax.tree_util.tree_leaves(
                    jax.tree_util.tree_map(np.asarray, jst.params)))}
    for key, lim in SSM_EXACT.items():
        assert read[key] <= lim, (key, read[key], lim)


def test_moments_in_the_reference_layout():
    """Which leaves take int moments and their payload and sidecar shapes,
    against the JAX state, at the smoke config (the shared block's 2-D
    weights among them); and at Zamba2-2.7B's widths the rule
    ``quantizable`` takes every 2-D shared weight, and (54, 80) A_log,
    dt_bias and D too: 4,320 elements, above the 4,096 below which a leaf
    keeps fp moments in both packages (Mamba2-130M's (24, 24) stay
    below)."""
    jcfg, tcfg = jsmoke(NAME), tsmoke(NAME)
    jrec = jparse_policy(INT8.replace("int8_cuda", "int8_pallas"))
    jst = jax.tree_util.tree_map(np.asarray, j_init(
        jbuild(jcfg), jax.random.PRNGKey(0), jrec, JOpt(**OPT)))
    tst = train_state_from_jax(jst, tcfg, device="cpu")
    fresh = train_state_to_numpy(init_train_state(
        build_model(tcfg), torch.Generator().manual_seed(0),
        parse_policy(INT8), OptConfig(**OPT), device="cpu"))
    leaves = lambda t: jax.tree_util.tree_leaves(
        t, is_leaf=lambda x: isinstance(x, tuple))
    n_int = 0
    for key in ("m1", "m2"):
        for jm, tm, p in zip(leaves(getattr(jst.opt, key)),
                             leaves(getattr(fresh.opt, key)),
                             tree_flatten(tst.params)[0]):
            assert isinstance(tm, tuple) == isinstance(jm, tuple) \
                == quantizable(p)
            assert [np.shape(a) for a in jm] == [np.shape(a) for a in tm]
            n_int += isinstance(tm, tuple)
    assert n_int > 0
    assert isinstance(tst.opt.m1["shared"]["attn"]["wq"], QState)
    assert not isinstance(tst.opt.m1["shared"]["ln1"]["scale"], QState)
    spec = _spec(get_config(NAME))
    meta = lambda s: torch.empty(s, device="meta")
    ssm = {k: v[0] for k, v in spec["blocks"]["ssm"].items()}
    assert ssm["A_log"] == (54, 80)
    assert all(quantizable(meta(s)) for s in ssm.values())
    shared = [v[0] for mod in spec["shared"].values()
              for v in (mod.values() if isinstance(mod, dict) else [mod])]
    assert {len(s) for s in shared} == {1, 2}
    assert all(quantizable(meta(s)) == (len(s) == 2) for s in shared)


def test_launcher_smoke_run(capsys):
    """``python -m repro_torch.launch.train --arch zamba2-2.7b --smoke
    --device cpu`` on the int8 route: finite rows, the SSM and attention
    roles on the int8 path, the group recomputation, ``attend=`` the
    q-chunks' one block."""
    from repro_torch.launch import train as launcher
    launcher.main(["--arch", NAME, "--smoke", "--steps", "2", "--batch", "2",
                   "--seq", "64", "--device", "cpu", "--state-storage", "int",
                   "--policy", INT8])
    out = capsys.readouterr().out
    assert "arch=zamba2-smoke" in out
    assert "remat=group+ce attend=dense" in out
    assert re.search(r"attn_qkv\+attn_out\+mlp_up\+mlp_down\+ssm_in\+ssm_out"
                     r"=int8_cuda\(fwd=int8,bwd=int8", out), out
    ces = [float(v) for v in re.findall(r"\sce=(\S+)", out)]
    assert ces and all(math.isfinite(c) for c in ces), out


def test_checkpoint_round_trip_in_the_reference_format(tmp_path):
    """A zamba2 train state (int moments, the shared block's among them)
    saved by the JAX manager and restored by the port's, and the reverse,
    bit for bit."""
    jcfg, tcfg = jsmoke(NAME), tsmoke(NAME)
    jrec = jparse_policy(INT8.replace("int8_cuda", "int8_pallas"))
    jst = j_init(jbuild(jcfg), jax.random.PRNGKey(0), jrec, JOpt(**OPT))
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tcfg, device="cpu")
    assert isinstance(tst.opt.m2["shared"]["proj"], QState)
    JManager(str(tmp_path / "j")).save(4, jst, metadata={"k": 4})
    got, meta, step = CheckpointManager(str(tmp_path / "j")).restore_latest(
        tst)
    assert step == 4 and meta["k"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(train_state_to_numpy(got)),
                    jax.tree_util.tree_leaves(train_state_to_numpy(tst))):
        np.testing.assert_array_equal(a, b)
    CheckpointManager(str(tmp_path / "t")).save(6, tst, metadata={"k": 6})
    jgot, _ = JManager(str(tmp_path / "t")).restore(6, jst)
    for a, b in zip(jax.tree_util.tree_leaves(jgot),
                    jax.tree_util.tree_leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
