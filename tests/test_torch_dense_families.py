"""Port parity of the rest of the dense family against the JAX package:
gemma (the embedding scaled by sqrt(d_model), RMSNorm with (1 + w), GeGLU,
one KV head, tied head) and qwen3 (RMSNorm of every head's q and k before
RoPE), on the ``gemma-2b`` and ``qwen3-32b`` smoke configs.  Inputs come
from numpy with a seed; JAX parameters carry across with
``params_from_jax``.

Oracle: the JAX fused int8-KV path (``REPRO_FUSED_DECODE=1``, Pallas in
interpret mode; ROADMAP section 3's oracle rule).

Tolerances, each stated where it is used:
* ``rmsnorm(plus_one=True)`` at float32 within 4 fp32 ulps of the value
  (rsqrt rounds differently in XLA and PyTorch); at bfloat16 within one
  bf16 step.
* The qk-normed attention (fp linears, one layer's weights) at float32
  within 1e-5 relative to its largest output (products summed in another
  order); at bfloat16 within one bf16 step of its largest output.
* The embedding scale: bit for bit at both carriers, the factor rounded
  to the carrier first (45.25 at bf16 for d = 2048, 9.8125 for d = 96).
* Prepared payloads and scales: bit for bit.
* Model logits at float32 within 1e-4, cache payloads within one int8
  step and scales within 4 fp32 ulps; at bfloat16 logits within
  ``BF16_LOGIT_BOUND`` and the layer-0 caches within one int8 step (the
  llama test's bounds and reasons, ``tests/test_torch_llama.py``).
* Engine tokens: equal, dense and paged.
* ``lm_loss`` at float32: ce within 1e-5, the gradients within 1e-4
  relative L2.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, get_smoke_config as jsmoke
from repro.infer import Engine as JEngine, Request as JRequest
from repro.infer.prepare import prepare_params as jprepare
from repro.models import build_model as jbuild
from repro.models.attention import attn_apply as jattn_apply
from repro.models.common import rmsnorm as jrmsnorm
from repro.models.lm import embed_tokens as jembed_tokens, lm_loss as jlm_loss

from repro_torch.configs import (ArchConfig, get_config,
                                 get_smoke_config as tsmoke)
from repro_torch.core.qpolicy import as_policy
from repro_torch.infer import Engine, Request
from repro_torch.infer.prepare import prepare_params
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.attention import attn_context, attn_out
from repro_torch.models.common import rmsnorm, rope_tables
from repro_torch.models.lm import embed_tokens, lm_loss

from test_torch_llama import (BF16_LOGIT_BOUND, DTYPES, POLICY, PROMPTS,
                              _flat, _np, _serve, _within_one_bf16_step)
from test_torch_train_step import true_fan_in

ARCHS = ("gemma-2b", "qwen3-32b")


@functools.lru_cache(maxsize=None)
def _jax_side(name, dtype):
    """(jax cfg, jax model, jax params) of the smoke config, drawn once
    per (config, carrier): JAX arrays are immutable, so tests share them."""
    jcfg = dataclasses.replace(jsmoke(name), dtype=dtype)
    jmodel = jbuild(jcfg)
    return jcfg, jmodel, jmodel.init_params(jax.random.PRNGKey(0))


def pair(name, dtype="float32"):
    """(jax cfg, jax model, jax params, torch cfg, torch model, torch
    params on the CPU, a fresh copy) for the smoke config of ``name``."""
    jcfg, jmodel, jparams = _jax_side(name, dtype)
    tcfg = dataclasses.replace(tsmoke(name), dtype=dtype)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")


@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_the_references(name):
    """The port's full and smoke configs equal the JAX package's field for
    field, and both build."""
    for tget, jget in ((get_config, jget_config), (tsmoke, jsmoke)):
        t, j = tget(name), jget(name)
        for f in dataclasses.fields(ArchConfig):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        build_model(t)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_plus_one_matches_jax(dtype):
    """Gemma's norm: the weight stored as w - 1, near zero as at init."""
    rs = np.random.RandomState(6)
    x = (rs.randn(4, 16, 2048) * 3).astype(np.float32)
    w = (0.1 * rs.randn(2048)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = _np(jrmsnorm(jnp.asarray(x).astype(jdt),
                        jnp.asarray(w).astype(jdt), plus_one=True))
    got = rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                  plus_one=True).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)
    else:
        assert _within_one_bf16_step(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qk_normed_attention_matches_jax(dtype):
    """Training-path self-attention with qk-norm and RoPE on qwen3-smoke's
    layer 0 (fp linears), q_norm and k_norm drawn away from their init of
    ones so that a norm left out or misplaced shows."""
    jcfg, _, jparams, tcfg, _, tparams = pair("qwen3-32b", dtype)
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(7)
    hd = tcfg.head_dim
    norms = {k: (1 + 0.5 * rs.randn(hd)).astype(np.float32)
             for k in ("q_norm", "k_norm")}
    jp = {k: v[0] for k, v in jparams["blocks"]["attn"].items()}
    jp.update({k: jnp.asarray(v) for k, v in norms.items()})
    jp = jax.tree_util.tree_map(lambda t: t.astype(jdt), jp)
    tp = {k: v[0] for k, v in tparams["blocks"]["attn"].items()}
    tp.update({k: torch.from_numpy(v) for k, v in norms.items()})
    tp = {k: v.to(tdt) for k, v in tp.items()}
    assert {"q_norm", "k_norm"} <= set(tp)
    x = rs.randn(2, 12, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    want, _ = jattn_apply(jp, jnp.asarray(x).astype(jdt), jcfg,
                          positions=jnp.asarray(pos),
                          mask={"kind": "causal"})
    want = _np(want)
    policy = as_policy(None)
    ctx = attn_context(tp, torch.from_numpy(x).to(tdt), tcfg, policy=policy,
                       rope=rope_tables(torch.from_numpy(pos.copy()), hd,
                                        tcfg.rope_theta))
    got = attn_out(tp, ctx, policy=policy).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("d_model", [96, 2048])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_scale_matches_jax(d_model, dtype):
    """``embed_tokens`` alone at a d_model whose square root the carrier
    does not hold exactly: bit for bit, and at bf16 the factor is the
    bf16 value (45.25 for 2048), not the fp32 one."""
    cfg = dataclasses.replace(tsmoke("gemma-2b"), d_model=d_model,
                              dtype=dtype)
    jcfg = dataclasses.replace(jsmoke("gemma-2b"), d_model=d_model,
                               dtype=dtype)
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(d_model)
    table = (rs.randn(cfg.vocab_padded, d_model) * 0.02).astype(np.float32)
    toks = rs.randint(0, cfg.vocab_size, (2, 9))
    want = _np(jembed_tokens({"embed": jnp.asarray(table).astype(jdt)},
                             jnp.asarray(toks), jcfg, dtype=jdt))
    tt = torch.from_numpy(table).to(tdt)
    got = embed_tokens({"embed": tt}, torch.from_numpy(toks), cfg,
                       torch.arange(9), tdt, as_policy(None))
    np.testing.assert_array_equal(got.float().numpy(), want)
    factor = torch.full((), math.sqrt(d_model), dtype=tdt)
    assert torch.equal(got, tt[torch.from_numpy(toks)] * factor)
    if dtype == "bfloat16":
        assert float(factor) != math.sqrt(d_model)
        if d_model == 2048:
            assert float(factor) == 45.25


@pytest.mark.parametrize("name", ARCHS)
def test_prepare_params_match_jax(name):
    """The seven block linears a layer prepared, payloads and scales bit
    for bit; the norm scales (gemma's zeros init, qwen3's q_norm and
    k_norm) pass through unchanged."""
    jcfg, _, jparams, tcfg, _, tparams = pair(name, "bfloat16")
    jp = jprepare(jcfg, jparams, POLICY)
    tp = prepare_params(tcfg, tparams, POLICY)
    n = 0
    for mod in ("attn", "mlp"):
        for k, jq in jp["blocks"][mod].items():
            tq = tp["blocks"][mod][k]
            if k in ("q_norm", "k_norm"):
                assert tq is tparams["blocks"]["attn"][k]
                np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
                continue
            for jt, tt in zip(jq, tq):
                np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            n += 1
    assert n == 7
    assert ("q_norm" in tp["blocks"]["attn"]) == tcfg.qk_norm
    init = 0.0 if tcfg.norm == "rmsnorm_p1" else 1.0
    for k in ("ln1", "ln2"):
        assert bool((tp["blocks"][k]["scale"] == init).all())
    assert ("lm_head" in tp) != tcfg.tie_embeddings


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_decode_match_jax_fused(name, dtype, fused):
    """W8A8 prepared weights + int8 KV: a 2 x 12 prompt into a 24-row
    cache, then 2 decode steps at per-slot positions 12 and 10 on.  The
    caches hold the normed, rotated k rows."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair(name, dtype)
    jp = jprepare(jcfg, jparams, POLICY)
    tp = prepare_params(tcfg, tparams, POLICY)
    rs = np.random.RandomState(1)
    prompt = rs.randint(0, jcfg.vocab_size, (2, 12))
    jl, jst = jmodel.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                             policy=POLICY, max_seq=24)
    tl, tst = tmodel.prefill(tp, torch.from_numpy(prompt), policy=POLICY,
                             max_seq=24)
    pairs = [(jl, tl)]
    for i in range(2):
        toks = rs.randint(0, jcfg.vocab_size, (2, 1))
        pos = np.asarray([12 + i, 10 + i], np.int32)
        jd, jst = jmodel.decode(jp, jst, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(pos), policy=POLICY)
        td, tst = tmodel.decode(tp, tst, torch.from_numpy(toks),
                                torch.from_numpy(pos), policy=POLICY)
        pairs.append((jd, td))
    real = slice(0, jcfg.vocab_size)
    bound = 1e-4 if dtype == "float32" else BF16_LOGIT_BOUND
    for jl, tl in pairs:
        t = tl.float().numpy()[:, real]
        assert np.isfinite(t).all()
        d = np.abs(t - _np(jl)[:, real]).max()
        assert d <= bound, (dtype, d)
    for key in ("k", "v", "k_scale", "v_scale"):
        j = np.asarray(jst["caches"][key])
        t = tst["caches"][key].numpy()
        if key in ("k", "v"):
            d = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert (d if dtype == "float32" else d[0]).max() <= 1, key
        elif dtype == "float32":
            np.testing.assert_allclose(t, j, rtol=4 * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_jax(name, paged, fused):
    """Continuous batching at float32 under the slice's policy, three
    requests on two slots (slot and page reuse); greedy tokens equal the
    JAX Engine's, dense and paged, on the fused rung."""
    _, jmodel, jparams, tcfg, tmodel, tparams = pair(name)
    kw = dict(max_slots=2, max_seq=32)
    if paged:
        kw.update(paged=True, page_size=8)
    prompts, news = PROMPTS[:3], [4, 3, 5]
    want = _serve(JEngine(jmodel, jparams, POLICY, **kw), JRequest, prompts,
                  news)
    teng = Engine(tmodel, tparams, POLICY, device="cpu", **kw)
    assert _serve(teng, Request, prompts, news) == want
    assert [len(t) for t, _ in want] == news
    rs = teng.resilience_summary()
    assert rs["rung"] == "fused" and not rs["demotions"], rs
    if paged:
        assert teng.pool.live_pages == 0


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_and_grads_match_jax(name):
    """``lm_loss`` and its gradients at float32 with fp linears, every
    leaf's gradient (the norm scales, q_norm and k_norm included), on block
    weights at the true fan-in scale (std 1/sqrt(d_in), both packages'
    the same numpy tree).  At the reference init's scale (ROADMAP section
    3: std 1/sqrt(L)) gemma-smoke's softmax saturates, and its wq, wk and
    ln1 gradients, which pass through the softmax's derivative, lose
    digits to cancellation in both packages: each is 0.7-1.4e-4 from the
    float64 gradient, and apart by 1.5e-4.  At the true fan-in scale the
    two packages agree to about 1.4e-6."""
    jcfg, _, jparams, tcfg, _, _ = pair(name)
    jparams = true_fan_in(jparams, jcfg.n_layers)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 17))
    (jce, _), jg = jax.value_and_grad(
        lambda p: jlm_loss(p, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jcfg), has_aux=True)(jparams)
    leaves = _flat(tparams)
    for t in leaves.values():
        t.requires_grad_()
    ce, _ = lm_loss(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    ce.backward()
    assert abs(ce.item() - float(jce)) <= 1e-5
    jflat = {k: np.asarray(v) for k, v in _flat(jg).items()}
    assert set(jflat) == set(leaves)
    for k, t in leaves.items():
        g, w = t.grad.numpy(), jflat[k]
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (k, rel)
