"""Port parity of the llama family (RoPE, RMSNorm, the gated SiLU MLP,
grouped KV heads, the untied head) against the JAX package, on the
``llama3-8b`` and ``yi-6b`` smoke configs (2 and 4 query heads a KV
head).  Inputs come from numpy with a seed; JAX parameters carry across
with ``params_from_jax``.

Oracle: the JAX fused int8-KV path (``REPRO_FUSED_DECODE=1``, Pallas in
interpret mode; ROADMAP section 3's oracle rule).

Tolerances, each stated where it is used:
* ``rope`` and ``rmsnorm`` at float32: within 4 fp32 ulps of the value
  (cos, sin and rsqrt round differently in XLA and PyTorch); at bfloat16
  within one bf16 step.  The gated MLP at float32 within 1e-5 relative to
  its largest output (its products summed in another order); at bfloat16
  within one bf16 step of its largest output (reading 0.39 of a step:
  F.silu rounds once, XLA's logistic op by op, and the bf16 products sum
  in another order).
* Prepared payloads and scales: bit for bit.
* Model logits at float32 within 1e-4 (readings about 2e-6), cache
  payloads within one int8 step and scales within 4 fp32 ulps (the
  rotated k rounds differently by an ulp here and there, which moves a
  row's scale by an ulp).  At bfloat16 within ``BF16_LOGIT_BOUND``
  (readings 0.07-0.36 on logits of magnitude about 3: the jitted JAX
  quantizer flips a payload in about 10^4, and the int8 codecs carry each
  flip to the logits) and the layer-0 caches within one int8 step.
* Engine tokens: equal.
* ``lm_loss`` at float32: ce within 1e-5, the gradients within 1e-4
  relative L2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.infer import Engine as JEngine, Request as JRequest
from repro.infer.prepare import prepare_params as jprepare
from repro.models import build_model as jbuild
from repro.models.common import rmsnorm as jrmsnorm, rope as jrope
from repro.models.lm import lm_loss as jlm_loss
from repro.models.mlp import mlp_apply as jmlp_apply

from repro_torch.configs import ArchConfig, get_smoke_config as tsmoke
from repro_torch.core.qpolicy import as_policy
from repro_torch.infer import Engine, Request
from repro_torch.infer.prepare import prepare_params
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.common import rmsnorm, rope
from repro_torch.models.lm import lm_loss
from repro_torch.models.mlp import mlp_apply

ARCHS = ("llama3-8b", "yi-6b")
POLICY = "kv_cache=a8t,*=w8c+a8t@int8_pallas"
BF16_LOGIT_BOUND = 0.5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")


def pair(name, dtype="float32", seed=0):
    """(jax cfg, jax model, jax params, torch cfg, torch model, torch
    params on the CPU) for the smoke config of ``name``."""
    jcfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    tcfg = dataclasses.replace(tsmoke(name), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_bf16_step(got, want):
    return np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-6)


@pytest.mark.parametrize("theta", [1e4, 5e5, 5e6])
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_matches_jax(theta, hd, dtype):
    """Positions up to 4096 (Yi's serving rows), three thetas (the smoke
    configs' default, Llama 3's and Yi's)."""
    rs = np.random.RandomState(hd)
    x = rs.randn(2, 48, 4, hd).astype(np.float32)
    pos = rs.randint(0, 4097, (2, 48))
    pos[0, :3] = (0, 4095, 4096)
    jdt, tdt = DTYPES[dtype]
    want = _np(jrope(jnp.asarray(x).astype(jdt), jnp.asarray(pos), theta))
    got = rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
               theta).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * 2.0 ** -23 * np.abs(x).max())
    else:
        assert _within_one_bf16_step(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_jax(dtype):
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 16, 4096) * 3).astype(np.float32)
    w = (1 + 0.1 * rs.randn(4096)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = _np(jrmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)))
    got = rmsnorm(torch.from_numpy(x).to(tdt),
                  torch.from_numpy(w).to(tdt)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)
    else:
        assert _within_one_bf16_step(got, want)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gated_mlp_matches_jax(name, dtype):
    """The gated branch, ``act(x w_gate) * (x w_up)`` then ``w_down``,
    with fp linears, on layer 0's weights of the smoke model."""
    jcfg, _, jparams, tcfg, _, tparams = pair(name, dtype)
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(4).randn(2, 8, jcfg.d_model).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda t: t[0].astype(jdt),
                                jparams["blocks"]["mlp"])
    tp = {k: v[0].to(tdt) for k, v in tparams["blocks"]["mlp"].items()}
    assert sorted(tp) == ["w_down", "w_gate", "w_up"]
    want = _np(jmlp_apply(jp, jnp.asarray(x).astype(jdt), jcfg))
    got = mlp_apply(tp, torch.from_numpy(x).to(tdt), tcfg,
                    policy=as_policy(None)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("name", ARCHS)
def test_prepare_params_match_jax(name):
    """Every block linear of the gated family prepared (7 of 7 a layer),
    payloads and scales bit for bit; the embedding and head stay fp."""
    jcfg, _, jparams, tcfg, _, tparams = pair(name, "bfloat16")
    jp = jprepare(jcfg, jparams, POLICY)
    tp = prepare_params(tcfg, tparams, POLICY)
    n = 0
    for mod in ("attn", "mlp"):
        for k, jq in jp["blocks"][mod].items():
            tq = tp["blocks"][mod][k]
            for jt, tt in zip(jq, tq):
                np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            n += 1
    assert n == 7
    assert prepare_params(tcfg, tp, POLICY)["blocks"]["mlp"]["w_up"] is \
        tp["blocks"]["mlp"]["w_up"]                  # prepared stays as is
    for k in ("embed", "lm_head"):
        assert tp[k].dtype == torch.float32
    assert "pos_embed" not in tp and set(tp["final_norm"]) == {"scale"}


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_decode_match_jax_fused(name, dtype, fused):
    """W8A8 prepared weights + int8 KV: a 2 x 12 prompt into a 24-row
    cache, then 8 decode steps at per-slot positions, 12 and 14 apart by
    slot (the second slot's prompt sits 2 rows further on)."""
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
    for i in range(8):
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


PROMPTS = ([1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15], [4, 5],
           [20, 21, 22, 23, 24, 25], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5])


def _serve(eng, req_cls, prompts, news):
    ids = [eng.submit(req_cls(tokens=list(p), max_new_tokens=n))
           for p, n in zip(prompts, news)]
    by_id = {r.request_id: r for r in eng.run()}
    return [(by_id[i].tokens, by_id[i].finish_reason) for i in ids]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_jax(name, paged, fused):
    """Continuous batching at float32 under the slice's policy: more
    requests than slots, ragged prompts, slot (and page) reuse; greedy
    tokens equal the JAX Engine's, and the paged engine's the dense one's."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair(name)
    kw = dict(max_slots=2, max_seq=32)
    if paged:
        kw.update(paged=True, page_size=8)
    news = [6, 4, 7, 5, 6]
    want = _serve(JEngine(jmodel, jparams, POLICY, **kw), JRequest, PROMPTS,
                  news)
    teng = Engine(tmodel, tparams, POLICY, device="cpu", **kw)
    assert _serve(teng, Request, PROMPTS, news) == want
    assert [len(t) for t, _ in want] == news
    if paged:
        assert teng.path_summary() == ("weights=prepared-int8(plain) "
                                       "kv=int8-paged-fused(p8)")
        assert teng.pool.live_pages == 0


@pytest.mark.parametrize("name", ARCHS)
def test_engine_prefix_preemption_and_packing_match_jax(name, fused):
    """(a) Requests after ``cache_prefix`` (the prefix pages aliased, the
    tail paged in), (b) two requests whose page growth preempts one of them
    (re-prefilled from its prompt and tokens so far), (c) a packed prefill
    on fp caches (``*=w8c``: short prompts share rows, positions restart
    per prompt): each gives the JAX engine's tokens."""
    _, jmodel, jparams, _, tmodel, tparams = pair(name)
    kw = dict(max_slots=2, max_seq=32, paged=True, page_size=8)
    prefix = [42, 17, 3, 99, 5, 21, 8, 13]
    runs = []
    for eng_cls, req, model, params, dev in (
            (JEngine, JRequest, jmodel, jparams, {}),
            (Engine, Request, tmodel, tparams, {"device": "cpu"})):
        def engine(policy=POLICY, **extra):
            return eng_cls(model, params, policy, **kw, **extra, **dev)
        out = {}
        eng = engine()
        assert eng.cache_prefix(prefix) == 1
        out["prefix"] = _serve(eng, req, [prefix + [60, 61, 62],
                                          prefix + [70]], [6, 6])
        eng = engine(n_pages=5)
        out["preempt"] = _serve(eng, req, [[5, 6, 7, 8, 9, 10, 11],
                                           [1, 2, 3]], [12, 14])
        out["preemptions"] = eng.preemptions
        out["packed"] = _serve(engine("*=w8c"), req, PROMPTS,
                               [5] * len(PROMPTS))
        runs.append(out)
    assert runs[1] == runs[0]
    assert runs[1]["preemptions"] >= 1


def _flat(tree, path=""):
    """{"a.b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{path}{k}."))
        else:
            out[path + k] = v
    return out


def test_lm_loss_and_grads_match_jax():
    """The training forward is the serving one: ``lm_loss`` and its
    gradients on llama3-smoke at float32 with fp linears."""
    jcfg, _, jparams, tcfg, _, tparams = pair("llama3-8b")
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


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
                                  "granite-moe-3b-a800m",
                                  "seamless-m4t-medium", "paligemma-3b"])
def test_check_supported_still_raises(name):
    """The VLM (paligemma) stays out, naming ROADMAP section 1, item 6.
    The MoE family (granite, phi-3.5-moe) builds since its serving path was
    ported, the hybrid (zamba2, whose port config is the JAX one field for
    field) since its serving path was ported, the encoder-decoder
    (seamless, field for field too) since its serving and training paths
    were ported, and so do the rest of the dense family (qwen3's qk-norm,
    gemma's embedding scale and plus-one RMSNorm) and the SSM family
    (mamba2)."""
    def port_cfg(jcfg):
        return ArchConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(ArchConfig)})
    cfg = port_cfg(get_smoke_config(name))
    if cfg.family == "moe":
        assert build_model(cfg).cfg.n_experts > 0
    elif cfg.family == "hybrid":
        assert cfg == tsmoke(name)
        assert build_model(cfg).cfg.hybrid_attn_every > 0
    elif cfg.family == "encdec":
        assert cfg == tsmoke(name)
        assert build_model(cfg).cfg.enc_layers > 0
    else:
        with pytest.raises(NotImplementedError, match="section 1, item 6"):
            build_model(cfg)
    for built in ("qwen3-32b", "gemma-2b", "mamba2-130m"):
        assert build_model(port_cfg(get_smoke_config(built))).cfg.name


def test_engine_bounds_rope_configs_by_their_context():
    """Under RoPE ``max_seq`` is bounded by the config's context (no
    position table); GPT-2's bound names its learned table."""
    _, _, _, tcfg, _, tparams = pair("yi-6b")
    short = dataclasses.replace(tcfg, max_seq=16)
    with pytest.raises(ValueError, match="the config's context"):
        Engine(build_model(short), tparams, POLICY, max_seq=32, device="cpu")
    gpt = tsmoke("gpt2-small")
    with pytest.raises(ValueError, match="learned-position table"):
        Engine(build_model(gpt), build_model(gpt).init_params(
            torch.Generator().manual_seed(0), device="cpu"), POLICY,
            max_seq=gpt.max_seq + 1, device="cpu")
