"""Port parity of the MoE family's modules against the JAX package, on the
``granite-moe-3b-a800m`` and ``phi3.5-moe-42b-a6.6b`` smoke configs (the
reference's ``local`` mode): the router, the capacity dispatch, the
experts through ``policy.linear`` -- the fp batched matmul, and the
prepared W8A8 weights on #3's expert-batched instance (here its plain
version, the tensors lying on the CPU) against the JAX ``vmap`` over
``int8_pallas`` (Pallas in interpret mode) -- the combine, the chunked
dispatch, and the loss's load-balance and z terms.  Inputs come from
numpy with a seed; JAX parameters carry across with ``params_from_jax``.

Tolerances, each stated where it is used:
* Integer routing (top-k experts, slots, keep, token indices), the
  capacity, prepared payloads and scales: equal.
* The router's gates, aux and z at float32 within 4 fp32 ulps relative
  (softmax and logsumexp round differently in XLA and PyTorch; the fp32
  router matmul sums in another order).
* ``moe_apply`` at float32 within 1e-5 relative to its largest output,
  aux and z within 4 ulps; at bfloat16 within one bf16 step of its
  largest output (``F.silu`` rounds once, XLA's logistic op by op).
* The combine: the JAX CPU scatter-add sums a token's k pairs one by one
  in index order in the carrier, and the port's k ordered adds match it
  bit for bit on the same rows (``test_combine_order_matches_jax``).
* The expert-batched plain #3: bit for bit against the per-expert loop of
  the 2-D plain versions.
* ``lm_loss`` at float32: ce, moe_aux, moe_z and the total within 1e-5.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.core.qpolicy import LinearCtx as JCtx, as_policy as jas_policy
from repro.infer.prepare import prepare_params as jprepare
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models.lm import lm_loss as jlm_loss

from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.core.qconfig import Granularity, QuantSpec
from repro_torch.core.qpolicy import LinearCtx, as_policy
from repro_torch.infer.prepare import prepare_params
from repro_torch.kernels.ops import (int8_prepared_linear,
                                     int8_prepared_linear_experts)
from repro_torch.models import build_model, moe, params_from_jax
from repro_torch.models.lm import lm_loss
from repro_torch.models.model_api import _check_supported

# the module (the package's ``int8_matmul`` is the wrapper function)
im = importlib.import_module("repro_torch.kernels.int8_matmul")
ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
POLICY = "kv_cache=a8t,*=w8c+a8t@int8_pallas"
POLICIES = {"fp": None, "w8a8": POLICY}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ULP = 2.0 ** -23


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def pair(name, dtype="float32", **kw):
    """(jax cfg, jax params, torch cfg, torch params on the CPU) of the
    smoke config of ``name`` (``kw`` replaces fields on both sides)."""
    jcfg = dataclasses.replace(jsmoke(name), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_smoke_config(name), dtype=dtype, **kw)
    jparams = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def layer0(tree):
    """Layer 0's ``moe`` leaves of a (possibly prepared) parameter tree,
    QState fields sliced together, in either package."""
    sub = tree["blocks"]["moe"]
    return {k: type(v)(*(t[0] for t in v)) if isinstance(v, tuple) else v[0]
            for k, v in sub.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_the_references(name):
    """The port's full and smoke configs equal the JAX package's field for
    field, and both build."""
    for tget, jget in ((get_config, jget_config),
                       (get_smoke_config, jsmoke)):
        t, j = tget(name), jget(name)
        for f in dataclasses.fields(ArchConfig):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert build_model(t).cfg.n_experts == j.n_experts > 0
    assert get_smoke_config(name).capacity_factor == 8.0


def test_spec_shapes_and_init_kinds():
    """The moe leaves and their shapes, stacked by layer; every one is the
    reference's fan_in init, which reads its fan-in from shape[0] (the
    layer count for a stacked leaf), so ``w_down``'s scale=1/L is unread
    in both packages."""
    jcfg, jparams, tcfg, _ = pair("granite-moe-3b-a800m")
    tp = build_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                       device="cpu")
    L, d, ff, e = tcfg.n_layers, tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    want = {"w_router": (L, d, e), "w_gate": (L, e, d, ff),
            "w_up": (L, e, d, ff), "w_down": (L, e, ff, d)}
    assert {k: tuple(v.shape) for k, v in tp["blocks"]["moe"].items()} \
        == want
    assert {k: v.shape for k, v in jparams["blocks"]["moe"].items()} == want
    assert "mlp" not in tp["blocks"]
    for k, v in tp["blocks"]["moe"].items():
        std = float(v.std())
        assert abs(std - L ** -0.5) < 0.15 * L ** -0.5, (k, std)
        jstd = float(jnp.std(jparams["blocks"]["moe"][k]))
        assert abs(jstd - L ** -0.5) < 0.15 * L ** -0.5, (k, jstd)


def _router_inputs(cfg, t, seed, ties=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(t, cfg.d_model).astype(np.float32)
    w = (rs.randn(cfg.d_model, cfg.n_experts) / 8).astype(np.float32)
    if ties:
        # equal columns give equal logits, bit for bit, in both packages
        w[:, 3] = w[:, 1]
        w[:, 2] = w[:, 0]
    return x, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_route_matches_jax(name, ties):
    """``_route``: top_e equal, gates, aux and z within 4 ulps; with equal
    router columns (tied logits) the lower expert comes first, as
    ``jax.lax.top_k`` puts it."""
    jcfg, _, tcfg, _ = pair(name)
    x, w = _router_inputs(tcfg, 64, 3, ties)
    jg, je, ja, jz = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg,
                                 jas_policy(None), JCtx("router", 0, 2))
    tg, te, ta, tz = moe._route(torch.from_numpy(x), torch.from_numpy(w),
                                tcfg, as_policy(None),
                                LinearCtx("router", 0, 2))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=4 * ULP,
                               atol=4 * ULP)
    for t, j in ((ta, ja), (tz, jz)):
        np.testing.assert_allclose(t.item(), float(j), rtol=4 * ULP)
    if ties:
        top = te.numpy()
        for lo, hi in ((1, 3), (0, 2)):
            both = [list(r) for r in top if lo in r and hi in r]
            assert both, (lo, hi)
            assert all(r.index(lo) == r.index(hi) - 1 for r in both)


@pytest.mark.parametrize("capacity", [1, 3, 40])
def test_dispatch_indices_match_jax(capacity):
    """``_dispatch_indices``: slots, keep and token indices equal, drops
    included (capacity 1 drops most pairs)."""
    rs = np.random.RandomState(capacity)
    e, k, t = 8, 2, 48
    top = np.stack([rs.choice(e, k, replace=False) for _ in range(t)])
    want = jmoe._dispatch_indices(jnp.asarray(top), e, capacity, k)
    got = moe._dispatch_indices(torch.from_numpy(top), e, capacity, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if capacity == 1:
        assert not got[1].all() and got[1].sum() <= e
        assert (got[0][~got[1]] == e * capacity).all()


def test_capacity_matches_jax():
    """``_capacity`` over a grid of token counts and both models' full and
    smoke configs (and a dropping capacity factor)."""
    for name in ARCHS:
        for get in (jget_config, jsmoke):
            for cf in (None, 1.0, 1.25):
                jcfg = get(name)
                if cf:
                    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
                tcfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                                     for f in dataclasses.fields(ArchConfig)})
                for t in (1, 2, 7, 16, 31, 64, 100, 2048, 16384, 32768):
                    assert moe._capacity(t, tcfg) == jmoe._capacity(t, jcfg)
    granite = get_config("granite-moe-3b-a800m")
    assert moe._capacity(16, granite) == 8
    assert moe._capacity(16384, granite) == 4097
    assert moe._capacity(16, get_config("phi3.5-moe-42b-a6.6b")) == 3


def _moe_inputs(cfg, b, s, seed):
    return (np.random.RandomState(seed).randn(b, s, cfg.d_model)
            .astype(np.float32))


def _moe_pair(name, dtype, policy, b=2, s=12, seed=5, **kw):
    """The JAX and the port's ``moe_apply`` of layer 0 on the same input
    (under ``policy``, prepared weights when it quantizes) -> ((y, aux, z)
    JAX, (y, aux, z) port)."""
    jcfg, jparams, tcfg, tparams = pair(name, dtype, **kw)
    jdt, tdt = DTYPES[dtype]
    if policy is not None:
        jparams = jprepare(jcfg, jparams, policy)
        tparams = prepare_params(tcfg, tparams, policy)
    cast = (lambda t: t if isinstance(t, tuple) or not
            jnp.issubdtype(t.dtype, jnp.floating) else t.astype(jdt))
    jp = {k: cast(v) for k, v in layer0(jparams).items()}
    tp = {k: v if isinstance(v, tuple) else v.to(tdt)
          for k, v in layer0(tparams).items()}
    x = _moe_inputs(tcfg, b, s, seed)
    want = jmoe.moe_apply(jp, jnp.asarray(x).astype(jdt), jcfg,
                          policy=policy, layer=0, n_layers=jcfg.n_layers)
    got = moe.moe_apply(tp, torch.from_numpy(x).to(tdt), tcfg,
                        policy=policy, layer=0, n_layers=tcfg.n_layers)
    return want, got


def _check_moe(want, got, dtype):
    jy, ja, jz = (_np(t) for t in want)
    ty, ta, tz = (t.float().numpy() for t in got)
    assert np.isfinite(ty).all()
    scale = np.abs(jy).max()
    if dtype == "float32":
        assert np.abs(ty - jy).max() <= 1e-5 * scale
    else:
        assert np.abs(ty - jy).max() <= 2.0 ** -7 * scale
    np.testing.assert_allclose(ta, ja, rtol=4 * ULP)
    np.testing.assert_allclose(tz, jz, rtol=4 * ULP)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_jax(name, dtype, policy):
    """``moe_apply`` on layer 0 of the smoke config: under the fp policy
    the experts are a batched matmul; under the W8A8 policy on prepared
    weights the port runs #3's expert-batched instance (its plain version
    here) and JAX its ``vmap`` of ``int8_pallas`` (interpret mode)."""
    want, got = _moe_pair(name, dtype, POLICIES[policy])
    _check_moe(want, got, dtype)


@pytest.mark.parametrize("name", ARCHS)
def test_prepared_expert_weights_match_jax(name):
    """``prepare_params`` of the expert leaves: (L, E, d, ff) payloads and
    (L, E, 1, ff) per-expert scales bit for bit; the router stays raw."""
    jcfg, jparams, tcfg, tparams = pair(name, "bfloat16")
    jp = jprepare(jcfg, jparams, POLICY)["blocks"]["moe"]
    tp = prepare_params(tcfg, tparams, POLICY)["blocks"]["moe"]
    L, e = tcfg.n_layers, tcfg.n_experts
    for k in ("w_gate", "w_up", "w_down"):
        assert tp[k].q.dtype == torch.int8
        assert tuple(tp[k].scale.shape) == (L, e, 1, tp[k].q.shape[-1])
        for jt, tt in zip(jp[k], tp[k]):
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tp["w_router"] is tparams["blocks"]["moe"]["w_router"]
    assert not isinstance(jp["w_router"], tuple)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_dropping_matches_jax(name, policy):
    """A capacity factor of 1.0 on both sides drops pairs (each expert
    takes about T*k/E rows): the same pairs drop, and the outputs agree as
    in the dropless case."""
    cfg = get_smoke_config(name)
    t = 2 * 12
    cap = moe._capacity(t, dataclasses.replace(cfg, capacity_factor=1.0))
    assert cap < t * cfg.top_k
    want, got = _moe_pair(name, "float32", POLICIES[policy],
                          capacity_factor=1.0)
    _check_moe(want, got, "float32")
    # some token kept fewer than k pairs: its output is a partial sum
    jcfg, jparams, tcfg, tparams = pair(name, capacity_factor=1.0)
    x = torch.from_numpy(_moe_inputs(tcfg, 2, 12, 5)).reshape(t, -1)
    p0 = layer0(tparams)
    _, top_e, _, _ = moe._route(x, p0["w_router"], tcfg, as_policy(None),
                                LinearCtx("router", 0, 2))
    _, keep, _ = moe._dispatch_indices(top_e, tcfg.n_experts, cap,
                                       tcfg.top_k)
    assert not bool(keep.all())


@pytest.mark.parametrize("policy", list(POLICIES))
def test_moe_chunked_matches_jax(monkeypatch, policy):
    """``MAX_DISPATCH_TOKENS`` patched small in both modules (no JAX file
    edited): 2 x 24 tokens dispatch in chunks of 16 (the bound 32 halved
    until it divides 48), each with its own capacity; y, and aux and z as
    the chunks' means, agree."""
    monkeypatch.setattr(jmoe, "MAX_DISPATCH_TOKENS", 32)
    monkeypatch.setattr(moe, "MAX_DISPATCH_TOKENS", 32)
    name = "granite-moe-3b-a800m"
    want, got = _moe_pair(name, "float32", POLICIES[policy], b=2, s=24,
                          capacity_factor=1.0)
    _check_moe(want, got, "float32")
    # the chunks route apart: one dispatch over all 48 tokens differs
    monkeypatch.setattr(moe, "MAX_DISPATCH_TOKENS", 1 << 20)
    _, whole = _moe_pair(name, "float32", POLICIES[policy], b=2, s=24,
                         capacity_factor=1.0)
    assert not torch.equal(whole[0], got[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_combine_order_matches_jax(dtype):
    """The reference's combine, ``zeros.at[token_idx].add(rows)`` with each
    token's k rows contiguous, against the port's k ordered adds on the
    same carrier rows: bit for bit (the JAX CPU scatter adds in index
    order, in the carrier; a float32 sum rounded once would differ at
    bfloat16)."""
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(0)
    t, k, d = 64, 8, 32
    rows = (rs.randn(t * k, d) * 3).astype(np.float32)
    idx = jnp.repeat(jnp.arange(t), k)
    want = _np(jnp.zeros((t, d), jdt).at[idx].add(
        jnp.asarray(rows).astype(jdt)))
    r = torch.from_numpy(rows).to(tdt).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=tdt)
    for j in range(k):
        y = y + r[:, j]
    np.testing.assert_array_equal(y.float().numpy(), want)
    if dtype == "bfloat16":
        once = r.float().sum(1).to(tdt).float().numpy()
        assert not np.array_equal(once, want)


def _expert_case(e, m, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (e, m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (e, k, n), generator=g, dtype=torch.int8)
    rs = torch.rand((e, m, 1), generator=g) * 0.05
    cs = torch.rand((e, 1, n), generator=g) * 0.01
    rs[:, ::7] = 0.0
    return x, w, rs, cs


@pytest.mark.parametrize("shape", [(8, 3, 64, 32), (5, 17, 96, 40),
                                   (40, 8, 1536, 512)])
def test_expert_batched_plain_is_the_per_expert_loop(shape):
    """#3's expert-batched plain versions bit for bit against the 2-D plain
    versions expert by expert: the int8 entry (per-channel and per-expert
    per-tensor weight scales) and the fused decode entry; and the prepared
    linear of every expert at once against ``int8_prepared_linear`` of
    each (per-token and per-tensor activations)."""
    e, m, k, n = shape
    x, w, rs, cs = _expert_case(e, m, k, n, sum(shape))
    for out in (torch.bfloat16, torch.float32):
        for col in (cs, cs[:, :, :1]):
            got = im.int8_matmul_experts(x, w, rs, col, out_dtype=out)
            want = torch.stack([im.int8_matmul(x[i], w[i], rs[i],
                                               col[i].expand(1, n),
                                               out_dtype=out)
                                for i in range(e)])
            assert got.shape == (e, m, n) and torch.equal(got, want)
    xf = torch.randn((e, m, k), generator=torch.Generator().manual_seed(1))
    xf[0, m // 2] = 0.0
    for a_spec in (QuantSpec(8, Granularity.PER_TOKEN),
                   QuantSpec(8, Granularity.PER_TENSOR)):
        if a_spec.granularity is Granularity.PER_TOKEN:
            got = im.int8_quant_matmul_experts(xf, w, cs, a_spec)
            want = torch.stack([im.int8_quant_matmul(xf[i], w[i], cs[i],
                                                     a_spec)
                                for i in range(e)])
            assert torch.equal(got, want)
        got = int8_prepared_linear_experts(xf, w, cs, a_spec)
        want = torch.stack([int8_prepared_linear(xf[i], w[i], cs[i], a_spec)
                            for i in range(e)])
        assert torch.equal(got, want)


def test_expert_wrappers_refuse_bad_shapes():
    x, w, rs, cs = _expert_case(4, 3, 32, 16, 0)
    with pytest.raises(ValueError):
        im.int8_matmul_experts(x[0], w[0], rs[0], cs[0])
    with pytest.raises(ValueError):
        im.int8_matmul_experts(x, w[:3], rs, cs)
    with pytest.raises(ValueError):
        im.int8_matmul_experts(x, w, rs[:, :2], cs)
    with pytest.raises(ValueError):
        im.int8_quant_matmul_experts(x.float(), w, cs,
                                     QuantSpec(8, Granularity.PER_TENSOR))


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_moe_terms_match_jax(name):
    """``lm_loss``'s forward at float32 with fp linears: ce, moe_aux,
    moe_z and the total ce + 0.01 aux / L + 1e-3 z / L within 1e-5."""
    jcfg, jparams, tcfg, tparams = pair(name)
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 17))
    jl, jm = jlm_loss(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                      jcfg)
    tl, tm = lm_loss(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert set(tm) == {"ce", "moe_aux", "moe_z", "loss"} == set(jm)
    for key in tm:
        assert abs(tm[key].item() - float(jm[key])) <= 1e-5 * max(
            1.0, abs(float(jm[key]))), key
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert tm["moe_aux"].item() > 0 and tm["moe_z"].item() > 0


def test_check_supported_takes_moe_and_refuses_the_rest():
    """MoE builds (both models), and so do the SSM family (mamba2), the
    hybrid (zamba2) and the encoder-decoder (seamless-m4t); the VLM still
    raises with ROADMAP item 6's message, and so do experts outside the moe
    family (a granite base relabelled hybrid, which has experts and no
    shared-block cadence, or relabelled encdec, which has experts and no
    encoder) or a moe config without experts."""
    for name in ARCHS:
        _check_supported(get_config(name))
    base = get_smoke_config("granite-moe-3b-a800m")
    for family in ("ssm", "hybrid", "encdec", "vlm"):
        if family in ("ssm", "hybrid", "encdec"):
            arch = {"ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
                    "encdec": "seamless-m4t-medium"}[family]
            _check_supported(get_config(arch))
            _check_supported(get_smoke_config(arch))
        with pytest.raises(NotImplementedError, match="section 1, item 6"):
            _check_supported(dataclasses.replace(base, family=family))
    with pytest.raises(NotImplementedError, match="section 1, item 6"):
        _check_supported(dataclasses.replace(base, n_experts=0, top_k=0))
    with pytest.raises(NotImplementedError, match="section 1, item 6"):
        _check_supported(dataclasses.replace(get_smoke_config("yi-6b"),
                                             n_experts=4, top_k=2))


def test_training_takes_moe(capsys):
    """The train step factory builds for experts, and the launcher runs one
    granite-moe-smoke step on the CPU with a finite ce."""
    import math
    import re
    from repro_torch.launch import train as launcher
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_train_step
    cfg = get_smoke_config("granite-moe-3b-a800m")
    assert callable(make_train_step(build_model(cfg), POLICY, OptConfig()))
    launcher.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                   "--steps", "1", "--batch", "2", "--seq", "32",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    ce = re.search(r"step\s+1\s+ce=(\S+)", out)
    assert ce and math.isfinite(float(ce.group(1))), out


def test_moe_modes_with_a_mesh_raise():
    """The expert-parallel modes need a mesh: rules with a tensor axis
    raise, naming ROADMAP item 8."""
    class Rules:
        tp_size = 4
    cfg = get_smoke_config("granite-moe-3b-a800m")
    with pytest.raises(NotImplementedError, match="section 1, item 8"):
        moe.moe_apply({}, torch.zeros(1, 2, cfg.d_model), cfg, rules=Rules())
