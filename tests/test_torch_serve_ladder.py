"""Port parity of the serving degradation ladder: the dequantize-on-read KV
path (dense and paged, packed prefills included), the fused -> dequant ->
fp rungs, the four serving fault kinds and the monitor, against the JAX
package on the ``gpt2-small`` smoke config (and ``llama3-8b``'s, for
grouped KV heads) at the float32 carrier unless a test says otherwise.
Parameters and inputs come from seeds (JAX's PRNG, numpy).

The cases of ``tests/test_serve_resilience.py``'s quarantine, ladder,
grammar and monitor sections are mirrored one for one, each against the
JAX engine on the same script.

Oracles (ROADMAP section 3, "two int8-KV prefill paths"): the port's
dequantize-on-read path is held to the JAX one (``REPRO_FUSED_DECODE=0``);
an engine whose rung 0 is the fused path is held to the JAX engine with
``REPRO_FUSED_DECODE=1`` (Pallas in interpret mode), whose rungs are then
the port's, ``fused / dequant / fp``.

Tolerances, each stated where it is used:
* the KV codecs (``kv_quant`` per token and per tensor, the engine's
  ``_dequant_caches`` and ``_requant_caches``): bit for bit;
* model logits on the dequantize-on-read path at float32 within 1e-3 (as
  ``tests/test_torch_model.py``), cache payloads within one int8 step; at
  bfloat16 within that file's ``BF16_LOGIT_BOUND`` and the layer-0
  payloads within one int8 step;
* engine tokens, ladder transitions, kernel errors, quarantines and
  preemptions: equal.
"""
import dataclasses
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.infer import (Engine as JEngine, EngineMonitor as JMonitor,
                         MonitorConfig as JMonitorConfig,
                         Request as JRequest)
from repro.models import build_model as jbuild
from repro.infer.prepare import prepare_params as jprepare
from repro.models.attention import _kv_quant as jkv_quant
from repro.core.qpolicy import as_policy as jas_policy
from repro.train import FaultInjected as JFaultInjected
from repro.train import FaultPlan as JFaultPlan

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core.qpolicy import as_policy
from repro_torch.infer import Engine, EngineMonitor, MonitorConfig, Request
from repro_torch.infer.prepare import prepare_params
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.attention import kv_quant
from repro_torch.train import FaultInjected, FaultPlan
from repro_torch.train.faults import EngineFaultHooks

from test_torch_model import BF16_LOGIT_BOUND

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (constants and helpers; imports no torch)

#: rung 0 fused (the kernels take a8t), and the two specs no kernel takes
FUSED = "kv_cache=a8t,*=w8c+a8t@int8_pallas"
A8N = "kv_cache=a8n,*=w8c"
A4T = "kv_cache=a4t,*=w8c"
PROMPTS = ([1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15], [4, 5],
           [20, 21, 22, 23, 24, 25], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5])


def pair(name="gpt2-small", dtype="float32", seed=0):
    """(jax cfg, jax model, jax params, torch cfg, torch model, torch
    params on the CPU) for the smoke config of ``name``."""
    jcfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    tcfg = dataclasses.replace(tsmoke(name), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def gpt2():
    return pair()


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")


@pytest.fixture
def dequant_env(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "0")


def engines(models, policy=None, **kw):
    _, jmodel, jparams, _, tmodel, tparams = models
    return (JEngine(jmodel, jparams, policy, **kw),
            Engine(tmodel, tparams, policy, device="cpu", **kw))


def responses(eng, req_cls, prompts, max_new=6):
    ids = [eng.submit(req_cls(tokens=list(p), max_new_tokens=max_new))
           for p in prompts]
    by_id = {r.request_id: r for r in eng.run()}
    return [(by_id[i].finish_reason, by_id[i].tokens) for i in ids]


def kv_segment(eng):
    """``path_summary``'s ``kv=`` segment and what follows; the JAX dense
    fused segment's ``(b<tile>)`` is dropped (the port's decode kernel has
    no tile setting to report)."""
    seg = eng.path_summary().split(" kv=")[1]
    return re.sub(r"int8-fused\(b\d+\)", "int8-fused", seg)


def ladder(eng):
    s = eng.resilience_summary()
    return {"walk": chip_smoke.serve_walk(s), "rung": s["rung"],
            "rung_index": s["rung_index"], "rungs": s["rungs"],
            "kernel_errors": s["kernel_errors"],
            "quarantined": s["quarantined"],
            "preemptions": s["preemptions"],
            "decode_steps": s["decode_steps"]}


# ---------------------------------------------------------------------------
# the KV codecs, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["a8t", "a4t", "a8n"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_matches_jax(spec, dtype):
    """``kv_quant`` of new K/V rows (B, s, K, hd), per token and per
    tensor (one scale per slot's write block): payloads and scales bit for
    bit, a row of zeros and a slot of one magnitude included."""
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((3, 5, 2, 8)) * 4).astype(np.float32)
    x[1] = 0.0
    x[2, :, :, :] = 0.75
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    jspec = jas_policy(f"kv_cache={spec},*=fp").kv_spec()
    tspec = as_policy(f"kv_cache={spec},*=fp").kv_spec()
    jq, js = jkv_quant(jx, jspec)
    tq, ts = kv_quant(tx, tspec)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (3, 5, 2, 1)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_requant_caches_match_jax(paged, dtype):
    """The ladder's cache conversions on the same int8 strips or pools:
    ``_dequant_caches`` (payload x guarded scale, cast to the carrier;
    scale-0 rows exactly 0) and ``_requant_caches`` (back to int8 with
    per-(position, head) scales; all-zero rows keep scale 0), bit for bit
    against the JAX engine's, and a round trip."""
    models = pair(dtype=dtype)
    kw = dict(max_slots=2, max_seq=16)
    if paged:
        kw.update(paged=True, page_size=8)
    jeng, teng = engines(models, FUSED, **kw)
    rng = np.random.RandomState(5)
    shape = tuple(teng._state["caches"]["k"].shape)
    side = shape[:-1] + (1,)
    caches = {}
    for name in ("k", "v"):
        q = rng.randint(-128, 128, shape).astype(np.int8)
        s = (rng.rand(*side) * 0.05).astype(np.float32)
        s.reshape(-1)[::5] = 0.0                   # never-written rows
        q[np.broadcast_to(s == 0, shape)] = 0
        caches[name], caches[name + "_scale"] = q, s
    # the JAX conversions run eagerly: XLA's CPU backend fuses round(x / s)
    # into a form that flips a payload in about 10^3 (ROADMAP section 3)
    with jax.disable_jit():
        jd = jeng._dequant_caches({k: jnp.asarray(v)
                                   for k, v in caches.items()})
        jr = jeng._requant_caches(jd)
    td = teng._dequant_caches({k: torch.from_numpy(v)
                               for k, v in caches.items()})
    for name in ("k", "v"):
        assert td[name].dtype == teng._dtype
        np.testing.assert_array_equal(
            td[name].to(torch.float32).numpy(),
            np.asarray(jd[name].astype(jnp.float32)))
    tr = teng._requant_caches(td)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tr[name].numpy(), np.asarray(jr[name]))
    assert (tr["k_scale"].numpy()[caches["k_scale"] == 0] == 0).all()


# ---------------------------------------------------------------------------
# dequantize-on-read: the model, then the engine
# ---------------------------------------------------------------------------

def _caches_close(tst, jst, layer0_only):
    """Payloads within one int8 step, in every layer or (bfloat16, where
    the GELU rounds differently from layer 1 on) in layer 0."""
    for name in ("k", "v"):
        j = np.asarray(jst["caches"][name]).astype(np.int32)
        t = tst["caches"][name].numpy().astype(np.int32)
        if layer0_only:
            t, j = t[0], j[0]
        assert np.abs(t - j).max() <= 1, name


@pytest.mark.parametrize("arch, dtype", [("gpt2-small", "float32"),
                                         ("gpt2-small", "bfloat16"),
                                         ("llama3-8b", "float32")])
@pytest.mark.parametrize("spec", ["a8t", "a4t", "a8n"])
def test_dequant_path_matches_jax(arch, spec, dtype, dequant_env):
    """The model on ``kv_path="dequant"`` against the JAX dequantize-on-read
    branch: a 2 x 12 prompt into a 16-row cache, one decode step at
    per-slot positions on the dense strips, then a packed prefill (two
    prompts in one row, segment masks) and a paged decode step gathering
    through a page table; GPT-2 at both carriers, llama3-8b's grouped heads
    at float32.  float32: logits within 1e-3, payloads within one int8
    step; bfloat16: logits within ``BF16_LOGIT_BOUND``, the layer-0
    payloads within one int8 step (the JAX layers run inside ``lax.scan``,
    where XLA fuses the codec's ``round(x / s)`` and flips a payload in
    about 10^3; the fused path's kernels quantize outside it, which is why
    ``tests/test_torch_model.py`` holds layer 0 bit for bit)."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair(arch, dtype)
    policy = f"kv_cache={spec},*=w8c+a8t@int8_pallas"
    jparams = jprepare(jcfg, jparams, policy)
    tparams = prepare_params(tcfg, tparams, policy)
    bound = 1e-3 if dtype == "float32" else BF16_LOGIT_BOUND
    real = slice(0, jcfg.vocab_size)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, jcfg.vocab_size, (2, 12))

    def close(jl, tl):
        d = np.abs(tl.to(torch.float32).numpy()[:, real]
                   - np.asarray(jl.astype(jnp.float32))[:, real]).max()
        assert d <= bound, (arch, spec, dtype, d)

    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt,
                                                             jnp.int32)},
                             policy=policy, max_seq=16)
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(prompt),
                             policy=policy, max_seq=16, kv_path="dequant")
    close(jl, tl)
    _caches_close(tst, jst, dtype == "bfloat16")
    toks, pos = [[5], [7]], np.asarray([12, 9], np.int32)
    jd, jst = jmodel.decode(jparams, jst, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(pos), policy=policy)
    td, tst = tmodel.decode(tparams, tst, torch.tensor(toks),
                            torch.from_numpy(pos), policy=policy,
                            kv_path="dequant")
    close(jd, td)
    _caches_close(tst, jst, dtype == "bfloat16")
    if spec == "a8n":
        return          # a per-write-block scale never packs (the engines')

    # packed: prompts of 5 and 7 tokens in one 16-row row, then a paged
    # decode step of both through pages of 4 rows
    toks = np.zeros((1, 16), np.int32)
    segs = np.full((1, 16), -1, np.int32)
    toks[0, :5], toks[0, 8:15] = prompt[0, :5], prompt[1, :7]
    segs[0, :8], segs[0, 8:16] = 0, 1
    last = np.asarray([[0, 4], [0, 14]], np.int32)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                             policy=policy, max_seq=16,
                             last_pos=jnp.asarray(last),
                             segments=jnp.asarray(segs))
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(toks).long(),
                             policy=policy, max_seq=16,
                             last_pos=torch.from_numpy(last),
                             segments=torch.from_numpy(segs),
                             kv_path="dequant")
    close(jl, tl)
    _caches_close(tst, jst, dtype == "bfloat16")
    # page the packed row into pools of 4-row pages: prompt 0's rows 0-7
    # in pages 1-2, prompt 1's rows 8-15 in pages 3-4; page 0 is trash
    table = np.asarray([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)

    def pools(c, lib):
        out = {}
        for name, buf in c.items():
            a = np.asarray(buf) if lib is jnp else buf.numpy()
            pool = np.zeros((a.shape[0], 5, 4) + a.shape[3:], a.dtype)
            pool[:, 1:5] = a[:, 0].reshape((a.shape[0], 4, 4) + a.shape[3:])
            out[name] = (jnp.asarray(pool) if lib is jnp
                         else torch.from_numpy(pool))
        return out
    # prompt 1's rows restart at logical row 0 in its own pages
    pos = np.asarray([5, 7], np.int32)
    jpools = pools(jst["caches"], jnp)
    tpools = pools(tst["caches"], torch)
    jd, jout = jmodel.decode(jparams, {**jst, "caches": jpools},
                             jnp.asarray([[3], [4]], jnp.int32),
                             jnp.asarray(pos), policy=policy,
                             page_table=jnp.asarray(table))
    td, tout = tmodel.decode(tparams, {"caches": tpools},
                             torch.tensor([[3], [4]]), torch.from_numpy(pos),
                             policy=policy, page_table=torch.from_numpy(table),
                             kv_path="dequant")
    close(jd, td)
    _caches_close(tout, jout, dtype == "bfloat16")


def test_kv_path_is_explicit_and_checked(gpt2):
    """The path is an argument, never the environment: ``"fused"`` on a
    spec no kernel takes, or an unknown name, raises; the default follows
    the kernels' capability."""
    _, _, _, tcfg, tmodel, tparams = gpt2
    prompt = torch.tensor([[1, 2, 3, 4]])
    with pytest.raises(ValueError, match="kv_path"):
        tmodel.prefill(tparams, prompt, policy=A8N, max_seq=8,
                       kv_path="fused")
    with pytest.raises(ValueError, match="kv_path"):
        tmodel.prefill(tparams, prompt, policy=FUSED, max_seq=8,
                       kv_path="gather")
    a, _ = tmodel.prefill(tparams, prompt, policy=A8N, max_seq=8)
    b, _ = tmodel.prefill(tparams, prompt, policy=A8N, max_seq=8,
                          kv_path="dequant")
    assert torch.equal(a, b)
    src = (REPO / "src" / "repro_torch").rglob("*.py")
    assert not any("REPRO_FUSED_DECODE" in f.read_text() for f in src)


@pytest.mark.parametrize("policy", [A8N, A4T])
@pytest.mark.parametrize("paged", [False, True])
def test_dequant_engine_tokens_match_jax(gpt2, dequant_env, policy, paged):
    """Engines whose rung 0 is dequantize-on-read (``a8n``, ``a4t``): the
    rungs, ``path_summary``'s ``kv=`` segment and the greedy tokens of
    ragged prompts (more than there are slots) equal the JAX engine's; a
    paged ``a4t`` engine packs short prompts into shared rows, a paged
    ``a8n`` one never does."""
    kw = dict(max_slots=3, max_seq=32)
    if paged:
        kw.update(paged=True, page_size=8)
    jeng, teng = engines(gpt2, policy, **kw)
    assert teng._rungs == jeng._rungs == ["dequant", "fp"]
    assert kv_segment(teng) == kv_segment(jeng) == (
        "int8-paged-gather(p8)" if paged else "int8-dequant")
    if paged:
        assert teng._pack_ok == jeng._pack_ok == (policy == A4T)
    got = [responses(eng, req, PROMPTS) for eng, req in
           ((jeng, JRequest), (teng, Request))]
    assert got[0] == got[1]
    assert all(r == "length" for r, _ in got[1])
    assert teng.kv_decode_read_bytes() == jeng.kv_decode_read_bytes()
    if paged:
        assert teng.pool.live_pages == 0


def _prefill_scales(eng, req_cls, prompts):
    """Admit ``prompts`` in one pass -> {request id: (2, L) the K and V
    scales each layer stored for the prompt's rows} (one value per layer
    under a per-tensor spec: the scale of the slot's write block)."""
    for p in prompts:
        eng.submit(req_cls(tokens=list(p), max_new_tokens=8))
    eng.scheduler._drain_inbox()
    eng._admit()
    assert len(eng._running) == len(prompts)
    caches = eng._state["caches"]
    out = {}
    for slot, st in eng._running.items():
        at = eng.pool.slot_pages(slot)[0] if eng.paged else slot
        out[st.req.request_id] = np.stack(
            [np.asarray(caches[n][:, at, 0, 0, 0])
             for n in ("k_scale", "v_scale")])
    return out


def test_a8n_paged_differs_from_dense_where_blocks_differ(gpt2,
                                                          dequant_env):
    """A per-tensor KV spec stores one scale per slot's prefill write
    block, pad rows included.  That block is the prompt's bucket in a dense
    engine and its launch's row in a paged one, so in the JAX engine (and,
    the same, in the port) the dense and paged prefill scales are equal bit
    for bit exactly where the two blocks have one length and differ
    wherever they do not, and the greedy tokens of a request whose block
    differs may differ (here one does) while those whose block matches are
    equal.  ``chip_smoke`` phase 17a's paged-against-dense check rests on
    this."""
    rng = np.random.RandomState(0)
    lens = (5, 20, 40, 10, 30, 50, 12)
    prompts = [rng.randint(1, 256, n).tolist() for n in lens]
    kw = dict(max_slots=len(lens), max_seq=64)
    scales, tokens, blocks = {}, {}, {}
    for paged in (False, True):
        pkw = dict(paged=True, page_size=16) if paged else {}
        for pkg, (eng, req) in enumerate(zip(engines(gpt2, A8N, **kw, **pkw),
                                             (JRequest, Request))):
            scales[pkg, paged] = _prefill_scales(eng, req, prompts)
            by_id = {r.request_id: r.tokens for r in eng.run()}
            tokens[pkg, paged] = [by_id[i] for i in range(len(lens))]
            blocks[pkg, paged] = [eng._row_len(max(lens)) if paged
                                  else eng._bucket_len(n) for n in lens]
    assert blocks[0, False] == blocks[1, False] == [16, 32, 64, 16, 32, 64,
                                                    16]
    assert blocks[0, True] == blocks[1, True] == [64] * len(lens)
    same = [i for i in range(len(lens))
            if blocks[0, False][i] == blocks[0, True][i]]
    assert same == [2, 5]
    for pkg in (0, 1):
        assert tokens[pkg, False] == tokens[0, False]
        assert tokens[pkg, True] == tokens[0, True]
        for i in range(len(lens)):
            equal = np.array_equal(scales[pkg, False][i],
                                   scales[pkg, True][i])
            assert equal == (i in same), (pkg, i)
    assert all(tokens[0, True][i] == tokens[0, False][i] for i in same)
    assert any(tokens[0, True][i] != tokens[0, False][i]
               for i in range(len(lens)) if i not in same)


def test_dequant_engine_grouped_heads_match_jax(dequant_env):
    """Grouped KV heads (llama3-8b smoke: 2 query heads a KV head, RoPE)
    on the dequantize-on-read engine, dense and paged with packing: greedy
    tokens equal the JAX engines'."""
    models = pair("llama3-8b")
    for kw in (dict(), dict(paged=True, page_size=8)):
        jeng, teng = engines(models, A4T, max_slots=3, max_seq=32, **kw)
        got = [responses(eng, req, PROMPTS, 5) for eng, req in
               ((jeng, JRequest), (teng, Request))]
        assert got[0] == got[1], kw


# ---------------------------------------------------------------------------
# quarantine and the ladder (test_serve_resilience.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [None, A8N])
def test_quarantine_isolates_row(gpt2, policy):
    """``nan_logit@2:slot=0`` evicts only that request ("numerics", its
    tokens before the fault kept); its batchmate's tokens equal a clean
    solo run, the rung stays 0, and both engines agree."""
    kw = dict(max_slots=2, max_seq=32)
    clean = engines(gpt2, policy, **kw)[1]
    clean.submit(Request(tokens=[4, 5, 6], max_new_tokens=8))
    [oracle] = clean.run()
    got = []
    for eng, req, plan_cls in zip(engines(gpt2, policy, **kw),
                                  (JRequest, Request),
                                  (JFaultPlan, FaultPlan)):
        eng.fault_hooks = plan_cls.parse("nan_logit@2:slot=0").engine_hooks()
        got.append(responses(eng, req, [[1, 2, 3], [4, 5, 6]], 8))
        s = eng.resilience_summary()
        assert s["quarantined"] == 1 and s["rung_index"] == 0
        assert not eng._running and len(eng._free) == 2
    assert got[0] == got[1]
    victim, other = got[1]
    assert victim[0] == "numerics" and 0 < len(victim[1]) < 8
    assert other == ("length", oracle.tokens)


@pytest.mark.parametrize("policy, walk", [
    (FUSED, [[1, "fused", "dequant"], [2, "dequant", "fused"]]),
    (A8N, [[1, "dequant", "fp"], [2, "fp", "dequant"]])])
@pytest.mark.parametrize("paged", [False, True])
def test_ladder_demote_and_reengage(gpt2, fused_env, policy, walk, paged):
    """``kernel_error@1`` demotes one rung (fused -> dequant, or dequant ->
    fp where rung 0 is dequantize-on-read); two healthy steps re-probe back
    up; the request finishes; walk, counts and tokens equal the JAX
    engine's (``REPRO_FUSED_DECODE=1``)."""
    kw = dict(max_slots=1, max_seq=32,
              monitor=MonitorConfig(reprobe_after=2))
    if paged:
        kw.update(paged=True, page_size=8)
    jkw = dict(kw, monitor=JMonitorConfig(reprobe_after=2))
    _, jmodel, jparams, _, tmodel, tparams = gpt2
    jeng = JEngine(jmodel, jparams, policy, **jkw)
    teng = Engine(tmodel, tparams, policy, device="cpu", **kw)
    assert teng._rungs == jeng._rungs
    got = []
    for eng, req, plan_cls in ((jeng, JRequest, JFaultPlan),
                               (teng, Request, FaultPlan)):
        plan = plan_cls.parse("kernel_error@1")
        eng.fault_hooks = plan.engine_hooks()
        got.append(responses(eng, req, [[1, 2, 3]], 8))
        assert plan.fired == ["kernel_error@1"]
    assert got[0] == got[1] and got[1][0][0] == "length"
    assert len(got[1][0][1]) == 8
    assert ladder(teng) == ladder(jeng)
    s = teng.resilience_summary()
    assert s["kernel_errors"] == 1 and chip_smoke.serve_walk(s) == walk
    assert s["rung_index"] == 0 and "degraded" not in teng.path_summary()
    assert "FaultInjected" in s["demotions"][0]["why"]


@pytest.mark.parametrize("paged", [False, True])
def test_ladder_walk_matches_jax(gpt2, fused_env, paged):
    """``chip_smoke.SERVE_LADDER_PLAN`` (two kernel errors, two NaN rows
    in one window, a slow step) with the re-probe after
    ``SERVE_LADDER_REPROBE`` steps: the walk equals the JAX engine's and
    ``chip_smoke.SERVE_LADDER_EXPECT``; two kernel errors, two requests
    end "numerics", the rest "length", tokens equal the JAX engine's, and
    the paged engine's tokens equal the dense engine's."""
    kw = dict(max_slots=4, max_seq=64)
    if paged:
        kw.update(paged=True, page_size=8)
    _, jmodel, jparams, _, tmodel, tparams = gpt2
    r = chip_smoke.SERVE_LADDER_REPROBE
    jeng = JEngine(jmodel, jparams, FUSED, monitor=JMonitorConfig(
        reprobe_after=r), **kw)
    teng = Engine(tmodel, tparams, FUSED, device="cpu",
                  monitor=MonitorConfig(reprobe_after=r), **kw)
    prompts = [list(range(1 + i, 6 + 2 * i)) for i in range(4)]
    got = []
    for eng, req, plan_cls in ((jeng, JRequest, JFaultPlan),
                               (teng, Request, FaultPlan)):
        plan = plan_cls.parse(chip_smoke.SERVE_LADDER_PLAN)
        eng.fault_hooks = plan.engine_hooks()
        got.append(responses(eng, req, prompts, 44))
        assert sorted(plan.fired) == sorted(
            chip_smoke.SERVE_LADDER_PLAN.split(";"))
    assert got[0] == got[1]
    assert ladder(teng) == ladder(jeng)
    assert ladder(teng)["walk"] == chip_smoke.SERVE_LADDER_EXPECT
    s = teng.resilience_summary()
    assert s["kernel_errors"] == 2 and s["quarantined"] == 2
    assert [r for r, _ in got[1]] == ["numerics"] * 2 + ["length"] * 2
    if paged:
        dense = Engine(tmodel, tparams, FUSED, device="cpu", max_slots=4,
                       max_seq=64, monitor=MonitorConfig(reprobe_after=r))
        dense.fault_hooks = FaultPlan.parse(
            chip_smoke.SERVE_LADDER_PLAN).engine_hooks()
        assert responses(dense, Request, prompts, 44) == got[1]
        assert teng.pool.live_pages == 0


@pytest.mark.parametrize("policy", [FUSED, A4T])
@pytest.mark.parametrize("paged", [False, True])
def test_fp_rung_roundtrip_serves_correctly(gpt2, fused_env, policy, paged):
    """Forced onto the fp rung (the caches dequantized) the engine serves a
    request admitted there (rung 0's prefill, its caches dequantized before
    the copy), reports ``degraded=fp``, and promoted back (the caches
    requantized) serves again; every response, the ``kv=`` segment, the KV
    mode and the read bytes on each rung equal the JAX engine's on the same
    script."""
    kw = dict(max_slots=2, max_seq=32)
    if paged:
        kw.update(paged=True, page_size=8)
    jeng, teng = engines(gpt2, policy, **kw)
    got = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        out = [responses(eng, req, [[1, 2, 3]], 4)]
        while eng._rungs[eng._rung] != "fp":
            assert eng._demote("test-forced", step=0)
            # the path report and the read bytes follow the rung that runs
            out.append((kv_segment(eng), eng._kv_mode()))
        assert not eng._demote("test-forced", step=0)
        assert "degraded=fp" in eng.path_summary()
        eng.submit(req(tokens=[4, 4, 4, 4, 4], max_new_tokens=4))
        eng.scheduler.step()                  # admitted on the fp rung
        out.append(eng.kv_decode_read_bytes())
        out += [responses(eng, req, [[1, 2, 3], [9, 8, 7, 6]], 4)]
        while eng._try_promote(step=0):
            out.append((kv_segment(eng), eng._kv_mode()))
        assert eng._rung == 0 and "degraded" not in eng.path_summary()
        out.append(responses(eng, req, [[1, 2, 3], [5, 5]], 4))
        got.append(out)
        assert "k_scale" in eng._state["caches"]
    assert got[0] == got[1]
    assert all(r == "length" for run in got[1] if isinstance(run, list)
               for r, _ in run)


@pytest.mark.parametrize("policy", [None, FUSED])
def test_bottom_rung_reraises(gpt2, fused_env, policy):
    """A failure on the last rung has nowhere to go: an fp-only engine
    re-raises ``kernel_error@1``; an int8 engine absorbs one error per
    rung and re-raises the third, as the JAX engine."""
    plan = ("kernel_error@1" if policy is None
            else "kernel_error@1;kernel_error@2;kernel_error@3")
    for eng, req, plan_cls, exc in zip(
            engines(gpt2, policy, max_slots=1, max_seq=16),
            (JRequest, Request), (JFaultPlan, FaultPlan),
            (JFaultInjected, FaultInjected)):
        eng.fault_hooks = plan_cls.parse(plan).engine_hooks()
        eng.submit(req(tokens=[1, 2, 3], max_new_tokens=6))
        with pytest.raises(exc):
            eng.run()
        s = eng.resilience_summary()
        assert s["rung"] == "fp"
        assert s["kernel_errors"] == (1 if policy is None else 3)


def _flaky_decode(monkeypatch, exc, fail_at):
    """Make the fused decode's plain version raise ``exc`` on its
    ``fail_at``-th call (0-based, counted over layers and steps)."""
    import repro_torch.models.attention as attention
    real = attention.decode_attention
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == fail_at + 1:
            raise exc
        return real(*args, **kwargs)
    monkeypatch.setattr(attention, "decode_attention", flaky)


def test_mid_stack_failure_retries_in_place(gpt2, monkeypatch):
    """An injected failure inside the fused decode (its plain version
    raising ``FaultInjected`` at layer L // 2 of step 3, after the lower
    layers wrote their rows in place) is retried one rung down; the retry
    overwrites those rows, so the tokens equal a run under
    ``kernel_error@3``, which raises before any layer ran."""
    _, _, _, tcfg, tmodel, tparams = gpt2
    kw = dict(max_slots=2, max_seq=32, device="cpu",
              monitor=MonitorConfig(reprobe_after=4))
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    ref = Engine(tmodel, tparams, FUSED, **kw)
    ref.fault_hooks = FaultPlan.parse("kernel_error@3").engine_hooks()
    want = responses(ref, Request, prompts, 12)

    _flaky_decode(monkeypatch, FaultInjected("decode_attention (injected)"),
                  3 * tcfg.n_layers + tcfg.n_layers // 2)
    eng = Engine(tmodel, tparams, FUSED, **kw)
    assert responses(eng, Request, prompts, 12) == want
    assert ladder(eng)["walk"] == ladder(ref)["walk"] == [
        [3, "fused", "dequant"], [6, "dequant", "fused"]]
    assert "decode_attention (injected)" in \
        eng.resilience_summary()["demotions"][0]["why"]
    assert eng.stats["rung_steps"] == ref.stats["rung_steps"] == {
        "fused": 7, "dequant": 4, "fp": 0}


def test_step_error_propagates(gpt2, monkeypatch):
    """Any exception from a decode step other than ``FaultInjected`` (a
    kernel that does not launch, a shape error) propagates at once: no
    kernel error is recorded, the ladder does not move and no plain rung
    serves the step.  This is where the port departs from the JAX engine,
    which absorbs every exception (ROADMAP section 3)."""
    _, _, _, tcfg, tmodel, tparams = gpt2
    _flaky_decode(monkeypatch, RuntimeError("decode_attention: launch "
                                            "failed"), tcfg.n_layers // 2)
    eng = Engine(tmodel, tparams, FUSED, max_slots=2, max_seq=32,
                 device="cpu")
    eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.run()
    s = eng.resilience_summary()
    assert (s["kernel_errors"], s["demotions"], s["rung_index"]) == (0, [], 0)
    assert eng.stats["rung_steps"] == {"fused": 0, "dequant": 0, "fp": 0}


@pytest.mark.parametrize("policy", [None, FUSED])
def test_oom_fault_preempts_and_recovers(gpt2, fused_env, policy):
    """``oom_pages@1:hold=2`` drains the pool: a preemption, never a
    CapacityError; the held pages come back, every request completes, and
    tokens and the preemption count equal the JAX engine's."""
    kw = dict(max_slots=2, max_seq=64, paged=True, page_size=4, n_pages=6)
    got = []
    for eng, req, plan_cls in zip(engines(gpt2, policy, **kw),
                                  (JRequest, Request),
                                  (JFaultPlan, FaultPlan)):
        plan = plan_cls.parse("oom_pages@1:hold=2")
        eng.fault_hooks = plan.engine_hooks()
        free0 = eng.pool.free_pages
        got.append((responses(eng, req, [[1, 2, 3, 4], [5, 6, 7, 8]], 10),
                    eng.preemptions))
        assert eng.pool.free_pages == free0
        assert plan.fired == ["oom_pages@1:hold=2"]
    assert got[0] == got[1]
    assert got[1][1] >= 1
    assert all(r == "length" and len(t) == 10 for r, t in got[1][0])


def test_slow_step_delays_the_loop(gpt2):
    """``slow_step@1:ms=300`` sleeps 300 ms on the host before decode step
    1's dispatch: the run takes that long at least, the fault fires once,
    nothing demotes, and, as in the reference, the sleep lies outside the
    step's timed dispatch (``slow_steps`` counts the dispatch's own
    outliers)."""
    import time
    _, _, _, _, tmodel, tparams = gpt2
    eng = Engine(tmodel, tparams, max_slots=1, max_seq=16, device="cpu",
                 monitor=MonitorConfig(slow_step_ms=60e3))
    plan = FaultPlan.parse("slow_step@1:ms=300")
    eng.fault_hooks = plan.engine_hooks()
    t0 = time.perf_counter()
    assert responses(eng, Request, [[1, 2, 3]], 4)[0][0] == "length"
    assert time.perf_counter() - t0 >= 0.3
    s = eng.resilience_summary()
    assert s["slow_steps"] == 0 and s["rung_index"] == 0
    assert s["step_ms"]["n"] == 3 and plan.fired == ["slow_step@1:ms=300"]


# ---------------------------------------------------------------------------
# the fault grammar and the monitor's arithmetic
# ---------------------------------------------------------------------------

def test_engine_fault_grammar():
    spec = ("nan_logit@2:slot=1;oom_pages@3:hold=4;slow_step@1:ms=5;"
            "kernel_error@6")
    plan, jplan = FaultPlan.parse(spec), JFaultPlan.parse(spec)
    assert [f.kind for f in plan.faults] == \
        ["nan_logit", "oom_pages", "slow_step", "kernel_error"]
    assert plan.describe() == jplan.describe()
    assert isinstance(plan.engine_hooks(), EngineFaultHooks)
    assert isinstance(FaultPlan.parse(
        "nan_logit@2;oom_pages@3;slow_step@1;kernel_error@6").engine_hooks(),
        EngineFaultHooks)
    # plans without serving kinds keep the engine hook-free
    assert FaultPlan.parse("nan_grad@3").engine_hooks() is None
    assert FaultPlan.parse(None).engine_hooks() is None
    with pytest.raises(ValueError):
        FaultPlan.parse("nan_logits@2")            # unknown kind


def test_mangle_finite_is_one_shot_and_copies():
    plan = FaultPlan.parse("nan_logit@2:slot=1")
    hooks = plan.engine_hooks()
    finite = np.ones(4, bool)
    assert hooks.mangle_finite(1, finite) is finite    # not its step
    out = hooks.mangle_finite(2, finite)
    assert not out[1] and finite[1]                # input not mutated
    assert plan.fired == ["nan_logit@2:slot=1"]
    again = hooks.mangle_finite(2, np.ones(4, bool))
    assert again.all()                             # one-shot
    with pytest.raises(FaultInjected):
        FaultPlan.parse("kernel_error@0").engine_hooks().kernel(0)


@pytest.mark.parametrize("cfg", [
    dict(numeric_window=4, numeric_limit=2, reprobe_after=3),
    dict(numeric_window=8, numeric_limit=3, reprobe_after=5,
         slow_step_ms=20.0)])
def test_monitor_matches_jax(cfg):
    """The same sequence of records through both monitors: every judgment
    and the two ``summary()``s equal (the reference's window test's
    sequence, then a longer one with slow steps and kernel errors)."""
    jm, tm = JMonitor(JMonitorConfig(**cfg)), EngineMonitor(
        MonitorConfig(**cfg))
    ops = [("q", 1), ("d?", 1), ("q", 3), ("d?", 3),
           ("demote", 3, "fused", "dequant", "test"), ("d?", 4),
           ("q", 10), ("d?", 10), ("s", 10.0), ("s", 30.0), ("s", 10.0),
           ("r?",), ("k", 12), ("r?",), ("s", 25.0), ("s", 5.0),
           ("s", 7.0), ("s", 9.0), ("s", 11.0), ("r?",),
           ("promote", 18, "dequant", "fused"), ("r?",), ("q", 19),
           ("q", 20), ("q", 21), ("d?", 21)]
    for op in ops:
        got = []
        for m in (jm, tm):
            if op[0] == "q":
                got.append(m.record_quarantine(op[1]))
            elif op[0] == "k":
                got.append(m.record_kernel_error(op[1]))
            elif op[0] == "s":
                got.append(m.record_step(op[1]))
            elif op[0] == "demote":
                got.append(m.record_demotion(*op[1:]))
            elif op[0] == "promote":
                got.append(m.record_promotion(*op[1:]))
            elif op[0] == "d?":
                got.append(m.should_demote(op[1]))
            else:
                got.append(m.should_reprobe())
        assert got[0] == got[1], op
        assert tm.mean_step_s() == jm.mean_step_s()
    assert tm.summary() == jm.summary()
    assert tm.summary()["demotions"][0]["why"] == "test"
