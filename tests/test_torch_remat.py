"""The port's recomputation against itself and against the JAX package, on
the CPU at the smoke sizes (gpt2-small and yi-6b smoke configs; the
kernels' plain versions).

* ``cfg.remat`` on and off: ce and every gradient bit-identical, under
  ``_attend`` and the flash path, on the int8 route's plain versions and
  on a fake-quant recipe.  The checkpoints are non-reentrant, so the
  backward runs the same graph on recomputed values, and every op repeats
  its bits on the CPU.
* ``chunked_ce``'s checkpoint: ce and gradients bit-identical with the
  checkpoint taken out.
* ``_pick_chunk`` equals the reference's (``rules=None``) on a table.
* ``_attend`` in q-chunks against one block: the forward bit for bit (each
  output row is the same dot products in the same order); the backward's
  dq bit for bit, dk and dv within 1e-6 relative to their largest entry
  at float32 and two bf16 steps at bfloat16 (they add the chunks'
  contributions one chunk at a time in their own type, the one block sums
  them in one product, so the sums round in another order).  And the
  chunked path against the reference's ``_gqa_attend`` at a length where
  both chunk: within 1e-5 relative (XLA and PyTorch sum in other orders).
* The yi-smoke train step with ``remat=True`` on both sides against the
  JAX package's step, to the limits of ``tests/test_torch_train_step.py``
  (the readings are in the test).
* What the forward does on the host runs twice under recomputation: the
  kernel wrappers are called again by the backward (so their launch
  counters count the recomputed launches on the card), while the health
  counters and the fault plan act on the gradients once a step.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core.qpolicy import parse_policy as jparse_policy
from repro.data import SyntheticCorpus
from repro.models import build_model as jbuild
from repro.models.attention import _gqa_attend, _pick_chunk as j_pick_chunk
from repro.optim import OptConfig as JOpt
from repro.train import init_train_state as j_init, make_train_step as j_make

import repro_torch.kernels.flash_attn as fa
import repro_torch.kernels.ops as ops
import repro_torch.models.lm as lm
import repro_torch.train.step as step_mod
from repro_torch.configs import get_config, get_smoke_config as tsmoke
from repro_torch.core.qpolicy import as_policy, parse_policy
from repro_torch.models import (build_model, train_state_from_jax,
                                train_state_to_numpy)
from repro_torch.models import attention
from repro_torch.models.attention import _attend, _pick_chunk
from repro_torch.models.common import tree_flatten
from repro_torch.optim import OptConfig
from repro_torch.train import FaultPlan, make_train_step
from repro_torch.train.step import recompute_desc, value_and_grad

#: the slice's training policy, the int8 route (plain versions on the CPU)
INT8 = "*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda"
#: a fake-quant recipe (the qdq route)
FAKE = "*=w8c+a8t+g8t"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(arch, seq=64, **kw):
    cfg = dataclasses.replace(tsmoke(arch), **kw)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=2, seq_len=seq))
    return cfg, model, params, toks


def _loss_and_grads(arch, policy, seq=64, **kw):
    _, model, params, toks = _model(arch, seq, **kw)
    loss, _, grads = value_and_grad(model, policy, params, {"tokens": toks})
    return loss, tree_flatten(grads)[0]


def _bit_identical(a, b):
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("policy", [INT8, FAKE])
@pytest.mark.parametrize("impl", ["xla", "flash_pallas"])
@pytest.mark.parametrize("arch", ["gpt2-small", "yi-6b"])
def test_remat_on_and_off_bit_identical(arch, impl, policy):
    on = _loss_and_grads(arch, policy, attention_impl=impl, remat=True)
    off = _loss_and_grads(arch, policy, attention_impl=impl, remat=False)
    assert torch.isfinite(on[0])
    assert _bit_identical(on, off)


def test_remat_bit_identical_with_attend_chunks(monkeypatch):
    """The same with ``_attend`` in q-chunks nested in the layer's
    checkpoint: 2 x 256 tokens under a score budget lowered to take two
    chunks of 128 rows (the budget a caller sets in
    ``attention.SCORE_BUDGET_BYTES``)."""
    monkeypatch.setattr(attention, "SCORE_BUDGET_BYTES", 1.5e6)
    assert recompute_desc(tsmoke("yi-6b"), 2, 256) == \
        "remat=layer+ce attend=q128"
    on = _loss_and_grads("yi-6b", INT8, seq=256, remat=True)
    off = _loss_and_grads("yi-6b", INT8, seq=256, remat=False)
    assert _bit_identical(on, off)


def test_chunked_ce_gradient_unchanged_by_its_checkpoint(monkeypatch):
    """Four CE chunks (``logit_chunk`` 16 of 64 positions) with and
    without their checkpoint: ce, the gradient of h and of the untied head
    bit for bit."""
    cfg = dataclasses.replace(tsmoke("yi-6b"), logit_chunk=16,
                              dtype="float32")
    rng = np.random.RandomState(3)
    h0 = torch.from_numpy(rng.randn(2, 64, cfg.d_model).astype(np.float32))
    head0 = torch.from_numpy(
        rng.randn(cfg.d_model, cfg.vocab_padded).astype(np.float32) * 0.1)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 64)))
    mask = torch.from_numpy((rng.rand(2, 64) > 0.2).astype(np.float32))

    def run():
        h = h0.clone().requires_grad_(True)
        head = head0.clone().requires_grad_(True)
        params = {"lm_head": head, "embed": None}
        ce = lm.chunked_ce(params, h, labels, mask, cfg, as_policy(None))
        gh, ghead = torch.autograd.grad(ce, (h, head))
        return ce, [gh, ghead]

    calls = []
    real = lm.checkpointed
    monkeypatch.setattr(lm, "checkpointed",
                        lambda fn, *a, **k: calls.append(1) or real(fn, *a,
                                                                    **k))
    with_ckpt = run()
    assert len(calls) == 4
    monkeypatch.setattr(lm, "checkpointed", lambda fn, *a, **k: fn(*a, **k))
    assert _bit_identical(with_ckpt, run())


#: (sq, skv, b, h): GPT-2's phase 7 and 17a, Yi's 18a / 18c, prefill
#: buckets that are not powers of two, a decode row
PICK_TABLE = [(1024, 1024, 8, 12), (512, 1024, 16, 12), (4096, 4096, 2, 32),
              (4096, 4096, 1, 32), (8192, 8192, 1, 32), (2048, 4096, 16, 32),
              (48, 48, 1, 4), (100, 100, 2, 4), (304, 1024, 16, 12),
              (1, 1024, 16, 12), (64, 80, 2, 12), (16384, 16384, 4, 64)]


@pytest.mark.parametrize("sq,skv,b,h", PICK_TABLE)
def test_pick_chunk_matches_reference(sq, skv, b, h):
    assert _pick_chunk(sq, skv, b, h) == j_pick_chunk(sq, skv, b, h, None)
    assert _pick_chunk(sq, skv, b, h, 1e12) == j_pick_chunk(
        sq, skv, b, h, None, budget_bytes=1e12)


def _qkv(sq, skv, dtype, seed=0, b=2, h=4, kh=2, hd=16):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, n, heads, hd).astype(np.float32)
               for n, heads in ((sq, h), (skv, kh), (skv, kh)))
    return [torch.from_numpy(t).to(dtype) for t in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,budget", [(256, 600e3), (96, 768e6)])
def test_chunked_attend_matches_one_block(sq, budget, dtype, monkeypatch):
    """Two chunks of 128 rows under a lowered budget, and three chunks of
    32 rows at a length that is not a power of two, against one block (the
    budget lifted).  dk and dv of bf16 inputs are bf16, and the chunked
    backward adds the chunks' bf16 contributions: within two bf16 steps of
    the largest entry there (reading 5.3e-3 of it), 1e-6 at float32."""
    assert _pick_chunk(sq, sq, 2, 4, budget) < sq

    def run(budget_bytes):
        monkeypatch.setattr(attention, "SCORE_BUDGET_BYTES", budget_bytes)
        q, k, v = (t.requires_grad_(True) for t in _qkv(sq, sq, dtype))
        ctx = _attend(q, k, v, "causal")
        g = torch.from_numpy(np.random.RandomState(1).randn(
            *ctx.shape).astype(np.float32)).to(dtype)
        return ctx, torch.autograd.grad(ctx, (q, k, v), g)

    (ctx_c, (dq_c, dk_c, dv_c)), (ctx_1, (dq_1, dk_1, dv_1)) = \
        run(budget), run(float("inf"))
    assert torch.equal(ctx_c, ctx_1)
    assert torch.equal(dq_c, dq_1)
    rel = 1e-6 if dtype == torch.float32 else 2.0 ** -6
    for got, want in ((dk_c, dk_1), (dv_c, dv_1)):
        err = (got.float() - want.float()).abs().max()
        assert err <= rel * want.float().abs().max(), err


def test_chunked_attend_matches_reference():
    """96 query rows over 96 keys: both packages take chunks of 32."""
    q, k, v = _qkv(96, 96, torch.float32, seed=4)
    assert _pick_chunk(96, 96, 2, 4) == 32
    got = _attend(q, k, v, "causal").numpy()
    want = np.asarray(_gqa_attend(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                  {"kind": "causal"}, None))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("arch,batch,seq,impl,remat,want", [
    ("yi-6b", 2, 4096, "xla", True, "remat=layer+ce attend=q512"),
    ("yi-6b", 1, 4096, "xla", True, "remat=layer+ce attend=q1024"),
    ("yi-6b", 2, 4096, "flash_pallas", True, "remat=layer+ce attend=flash"),
    ("gpt2-small", 8, 1024, "xla", False, "remat=ce attend=dense"),
    ("gpt2-small", 2, 512, "xla", True, "remat=layer+ce attend=dense")])
def test_train_path_names_the_recomputation(arch, batch, seq, impl, remat,
                                            want):
    cfg = dataclasses.replace(get_config(arch), attention_impl=impl,
                              remat=remat)
    assert recompute_desc(cfg, batch, seq) == want


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


#: tests/test_torch_train_step.py's limits on the worst of two steps (|d
#: ce|, the gradient norm's relative difference, the params' relative L2
#: distance): EXACT_LINEARS for int moments on fp linears, QUANT_LINEARS
#: for the int8 route
EXACT_LINEARS = {"ce": 5e-6, "grad_norm": 1e-5, "params": 3e-5}
QUANT_LINEARS = {"ce": 1e-3, "grad_norm": 1e-2, "params": 1e-2}


@pytest.mark.parametrize("policy,eager,limits", [
    ("*=m1:8c-b128+m2:8c-asym-b128-sqrt", False, EXACT_LINEARS),
    (INT8, True, QUANT_LINEARS)])
def test_yi_smoke_train_step_with_remat_matches_jax(policy, eager, limits):
    """Two steps of yi-smoke (float32 carrier, 2 x 64 tokens, int moments),
    ``remat=True`` in both packages, from the same JAX-initialized state
    at the true fan-in scale.  Readings: int moments on fp linears against
    the jitted step ce 1.9e-6, grad norm 4.1e-6, params 5.2e-6; the int8
    route against the step under ``jax.disable_jit()`` 1.9e-4, 1.9e-3,
    5.5e-4.  The int8 route is held to the eager step: against the jitted
    one ce already differs by 1.2e-3 on step 1, the same with ``remat``
    off in both packages -- XLA's compiled quantizer flips payloads on the
    bf16-rounded weights (ROADMAP section 3), while the eager JAX loss on
    those weights is the port's within 5e-7."""
    text = policy.replace("int8_cuda", "int8_pallas")
    jcfg = dataclasses.replace(jsmoke("yi-6b"), dtype="float32", remat=True)
    tcfg = dataclasses.replace(tsmoke("yi-6b"), dtype="float32", remat=True)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=100, state_storage="int")
    jmodel, jrec = jbuild(jcfg), jparse_policy(text)
    jst = j_init(jmodel, jax.random.PRNGKey(0), jrec, JOpt(**kw))
    jst = jst._replace(params=_true_fan_in(jst.params, jcfg.n_layers))
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               tcfg, device="cpu")
    jstep = j_make(jmodel, jrec, JOpt(**kw))
    if not eager:
        jstep = jax.jit(jstep)
    tstep = make_train_step(build_model(tcfg), parse_policy(policy),
                            OptConfig(**kw))
    corpus = SyntheticCorpus(jcfg.vocab_size, seed=7)
    for i in range(2):
        toks = corpus.batch(i, batch_size=2, seq_len=64)
        with jax.disable_jit(eager):
            jst, jm = jstep(jst, {"tokens": jnp.asarray(toks)}, None)
        tst, tm = tstep(tst, {"tokens": torch.from_numpy(toks)})
        read = {"ce": abs(float(jm["ce"]) - float(tm["ce"])),
                "grad_norm": abs(float(jm["grad_norm"])
                                 - float(tm["grad_norm"]))
                / float(jm["grad_norm"]),
                "params": _rel_l2(
                    jax.tree_util.tree_leaves(train_state_to_numpy(tst).params),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(np.asarray, jst.params)))}
        for key, lim in limits.items():
            assert read[key] <= lim, (f"step {i + 1}", key, read[key], lim)


def test_host_work_under_recomputation(monkeypatch):
    """Two steps of yi-smoke under ``nan_grad@1`` with the health
    counters, ``remat`` on: the int8 forward wrapper is called 14 times a
    layer a step (7 linears, each again in the backward's recomputation),
    the backward's two 7 times, the flash forward twice a layer and its
    backward once; ``grad_quant_health`` and the fault plan's gradient hook
    run once a step, and the fault fires on step 1 alone."""
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, call)
    for name in ("int8_matmul", "int8_matmul_nt", "int8_matmul_tn"):
        spy(ops, name)
    for name in ("flash_attention_fwd_lse", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        spy(fa, name)
    spy(step_mod, "grad_quant_health")
    plan = FaultPlan.parse("nan_grad@1")
    spy(plan, "apply_grads")
    cfg, model, params, toks = _model("yi-6b", attention_impl="flash_pallas")
    assert cfg.remat
    policy = parse_policy(INT8)
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                    state_storage="int")
    from repro_torch.train import init_train_state
    state = init_train_state(model, torch.Generator().manual_seed(0), policy,
                             opt, device="cpu")
    fn = make_train_step(model, policy, opt, faults=plan, health=True)
    n = cfg.n_layers
    for i in range(2):
        calls.clear()
        state, met = fn(state, {"tokens": toks})
        assert calls == {"int8_matmul": 14 * n, "int8_matmul_nt": 7 * n,
                         "int8_matmul_tn": 7 * n,
                         "flash_attention_fwd_lse": 2 * n,
                         "flash_attention_bwd_dkdv": n,
                         "flash_attention_bwd_dq": n,
                         "grad_quant_health": 1, "apply_grads": 1}, i
        assert math.isfinite(float(met["ce"]))
        assert math.isfinite(float(met["grad_norm"])) == (i == 0)
