"""The SSM family trained: ``lm_loss`` and its gradients, the train step,
the recomputation, the 8-bit moments' layout, the launcher and the
checkpoint format, on the mamba2 smoke config against the JAX package
(parameters carried across from the JAX init; the int8 kernels' plain
versions here, Pallas in interpret mode on the JAX side).

* ``lm_loss`` and ``jax.value_and_grad`` of the reference's, float32
  carrier, 2 x 64 tokens: |d loss| <= 1e-5; under fp linears every
  gradient within 2e-4 of its largest entry and in relative L2 (readings
  on this tree 1.2e-5 to 4.8e-5: the SSD's chunked sums and its backward
  run in another order, and the 2-layer stack carries that into every
  leaf); under ``*=w8c+a8t+g8t@int8_pallas`` (the projections on #3, #4
  and #5) each gradient's relative L2 distance within 5e-3 (readings
  1.1e-5 to 1.7e-3: a per-token or per-channel int8 payload that lands on
  the other side of a rounding boundary moves its row's gradient).
* ``remat`` on and off: ce and every gradient bit-identical (fp, the int8
  route, fake quant).
* One train step with int moments from the same JAX state, against the
  jitted JAX step: on fp linears |d ce| <= 5e-6, the grad norm within 5e-5
  relative and the params within 3e-5 in relative L2 (readings 9.5e-7,
  1.3e-5, 7.2e-7; the grad norm's limit is five times
  ``test_torch_train_step.py``'s 1e-5, for the SSD's sums); on the int8
  route ``QUANT_LINEARS`` (readings 2.4e-4, 4.9e-3, 2.1e-4).
* The moments: (L, H) ``A_log``, ``dt_bias`` and ``D`` are 2-D but below
  4,096 elements and keep fp moments, the larger leaves take blockwise int
  moments, each with the JAX state's shapes.
* The launcher's ``--smoke`` run, and a train state written by either
  package's checkpoint manager restored by the other bit for bit.
"""
import dataclasses
import math
import re

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
                                       QUANT_LINEARS, _rel_l2)

NAME = "mamba2-130m"
G8 = "*=w8c+a8t+g8t@int8_pallas"
#: the fp-linear step's limits: ``EXACT_LINEARS`` with the grad norm's
#: five times wider (the SSD's sums in another order)
SSM_EXACT = {"ce": 5e-6, "grad_norm": 5e-5, "params": 3e-5}


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
    jparams = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
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
    assert abs(tl.item() - float(jl)) <= 1e-5
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(leaves) == 14
    for t, j in zip(leaves, jleaves):
        g, w = t.grad.numpy().astype(np.float64), np.asarray(j, np.float64)
        assert g.shape == w.shape
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        if policy is None:
            assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max()
            assert rel <= 2e-4
        else:
            assert rel <= 5e-3, (g.shape, rel)


@pytest.mark.parametrize("policy", [INT8, FAKE, "*=fp"])
def test_remat_on_and_off_bit_identical(policy):
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tsmoke(NAME), remat=remat)
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device="cpu")
        toks = torch.from_numpy(TCorpus(cfg.vocab_size, seed=7).batch(
            0, batch_size=2, seq_len=128))
        loss, _, grads = value_and_grad(model, policy, params,
                                        {"tokens": toks})
        out.append((loss, tree_flatten(grads)[0]))
    (l1, g1), (l2, g2) = out
    assert torch.isfinite(l1) and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("policy,limits", [(INT_MOMENTS, SSM_EXACT),
                                           (INT8, QUANT_LINEARS)])
def test_train_step_matches_jax(policy, limits):
    jcfg, tcfg = _cfgs(remat=True)
    jmodel, jrec = jbuild(jcfg), jparse_policy(
        policy.replace("int8_cuda", "int8_pallas"))
    jst = j_init(jmodel, jax.random.PRNGKey(0), jrec, JOpt(**OPT))
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tcfg, device="cpu")
    tstep = make_train_step(build_model(tcfg), parse_policy(policy),
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
    for key, lim in limits.items():
        assert read[key] <= lim, (key, read[key], lim)


def test_moments_in_the_reference_layout():
    """Which leaves take int moments and their payload and sidecar shapes,
    against the JAX state, at the smoke config; and at Mamba2-130M's widths
    the rule ``quantizable`` picks the leaves the reference does: (24, 24)
    A_log, dt_bias and D keep fp moments, (24, 1536) gate_norm, (24, 1792)
    conv_b and (24, 4, 1792) conv_w take int ones."""
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
    shapes = {k: v[0]
              for k, v in _spec(get_config(NAME))["blocks"]["ssm"].items()}
    small = {k for k, s in shapes.items()
             if not quantizable(torch.empty(s, device="meta"))}
    assert small == {"A_log", "dt_bias", "D"}
    assert shapes["A_log"] == (24, 24) and shapes["conv_w"] == (24, 4, 1792)


def test_launcher_smoke_run(capsys):
    """``python -m repro_torch.launch.train --arch mamba2-130m --smoke
    --device cpu`` on the int8 route: finite rows, the SSM roles on the
    int8 path, ``attend=none``."""
    from repro_torch.launch import train as launcher
    launcher.main(["--arch", NAME, "--smoke", "--steps", "2", "--batch", "2",
                   "--seq", "64", "--device", "cpu", "--state-storage", "int",
                   "--policy", INT8])
    out = capsys.readouterr().out
    assert "arch=mamba2-smoke" in out and "attend=none" in out
    assert re.search(r"ssm_in\+ssm_out=int8_cuda\(fwd=int8,bwd=int8",
                     out.replace("attn_qkv+attn_out+mlp_up+mlp_down+", ""))
    ces = [float(v) for v in re.findall(r"\sce=(\S+)", out)]
    assert ces and all(math.isfinite(c) for c in ces), out


def test_checkpoint_round_trip_in_the_reference_format(tmp_path):
    """A mamba2 train state (int moments) saved by the JAX manager and
    restored by the port's, and the reverse, bit for bit."""
    jcfg, tcfg = jsmoke(NAME), tsmoke(NAME)
    jrec = jparse_policy(INT8.replace("int8_cuda", "int8_pallas"))
    jst = j_init(jbuild(jcfg), jax.random.PRNGKey(0), jrec, JOpt(**OPT))
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tcfg, device="cpu")
    assert any(isinstance(m, QState)
               for m in tree_flatten(tst.opt.m1)[0])
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
