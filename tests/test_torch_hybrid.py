"""The hybrid family (zamba2) against the JAX package: its config, its
parameter layout and init, the shared block, prefill and decode, and the
plain versions of #11 and #12/#13 at the shared block's head dim of 160.
Inputs come from numpy with a seed; JAX parameters carry across with
``params_from_jax``; the int8 linears run their plain versions here and
Pallas in interpret mode on the JAX side.

Oracle: the JAX fused int8-KV path (``REPRO_FUSED_DECODE=1``; ROADMAP
section 3's oracle rule), at the float32 carrier: at bfloat16 the two
packages part after the first GELU (XLA rounds the tanh form op by op,
``F.gelu`` once; ROADMAP section 3).

Tolerances, each stated where it is used:
* configs field for field, ``param_count`` and the parameter layout:
  equal; prepared payloads and scales of the shared block: bit for bit.
* The shared block alone on the same inputs: at fp, within 1e-5 of its
  largest output (sums in another order); under the W8A8 policy with an
  int8 cache the payloads bit for bit, the scales within 8 fp32 ulps
  (RoPE's cos and sin round differently, which moves an absmax by an ulp).
* ``lm_prefill`` and three ``lm_decode`` steps (zamba2-smoke: 4 layers, 2
  groups, hd 32): logits within 1e-4 of the largest, the SSM and conv
  states within 1e-4 of the largest (the SSD sums in another order,
  readings up to 1.1e-5), the KV payloads of every cache g bit for bit
  under the W8A8 policy and their scales within 8 fp32 ulps (the
  states' last bits reach the absmax; readings up to 3.7 ulps), and at
  fp the cache within 1e-4 of its largest.
* #11 and #12/#13 at hd 160: the context within 1e-5 of the Pallas
  kernels' (interpret mode), the written rows' payloads bit for bit, the
  paged step bit for bit the dense one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.infer.prepare import prepare_params as jprepare
from repro.kernels.decode_attn import decode_attention as j_decode
from repro.kernels.flash_attn import flash_attention_fwd_q8 as j_flash
from repro.models import build_model as jbuild
from repro.models import lm as jlm
from repro.models.common import ParamSpec

from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.core.qadam import QState
from repro_torch.core.qpolicy import as_policy
from repro_torch.infer.prepare import prepare_params
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_paged_plain,
                                             decode_attention_plain)
from repro_torch.kernels.flash_attn import flash_attention_fwd_q8
from repro_torch.models import blocks, build_model, lm, params_from_jax
from repro_torch.models.attention import cache_count
from repro_torch.models.model_api import _check_supported, _spec
from repro_torch.models.common import rope_tables
from repro_torch.train import check_trainable
from test_torch_kernels import _decode_inputs

NAME = "zamba2-2.7b"
POLICY = "kv_cache=a8t,*=w8c+a8t@int8_pallas"
TOL = 1e-4
ULP = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")


def port_cfg(jcfg):
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ArchConfig)})


@functools.lru_cache(maxsize=None)
def pair(dtype="float32"):
    """(jax cfg, jax model, jax params, torch cfg, torch model, torch
    params on the CPU) of zamba2-smoke, drawn once (nothing changes
    them)."""
    jcfg = dataclasses.replace(jsmoke(NAME), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(NAME), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def _ulps(got, want):
    """Largest |got - want| in fp32 ulps of want."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.maximum(np.abs(want), 1e-30) * ULP
    return float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax(smoke):
    """The port's zamba2 configs are the JAX ones field for field, with
    the same parameter count (the shared block's term included)."""
    get_j, get_t = (jsmoke, get_smoke_config) if smoke else (jget_config,
                                                            get_config)
    jcfg, tcfg = get_j(NAME), get_t(NAME)
    assert tcfg == port_cfg(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert cache_count(tcfg) == tcfg.n_layers // tcfg.hybrid_attn_every
    if not smoke:
        assert cache_count(tcfg) == 9
        assert 2.50e9 < tcfg.param_count() < 2.52e9


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_is_the_reference_layout(smoke):
    """Every leaf of the port's spec -- the stacked SSM blocks and the
    depth-less shared block over 2 * d_model -- has the reference's
    shape and init kind (``lm_spec``)."""
    tcfg = get_smoke_config(NAME) if smoke else get_config(NAME)
    jflat = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_leaves_with_path(
                 jlm.lm_spec(jsmoke(NAME) if smoke else jget_config(NAME)),
                 is_leaf=lambda x: isinstance(x, ParamSpec))}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{path}['{k}']")
        else:
            yield path, node
    tflat = dict(walk(_spec(tcfg), ""))
    assert set(tflat) == set(jflat)
    for k, (shape, init, *_) in tflat.items():
        assert tuple(shape) == jflat[k].shape and init == jflat[k].init, k
    d2 = 2 * tcfg.d_model
    assert tflat["['shared']['proj']"][0] == (d2, tcfg.d_model)
    assert tflat["['shared']['attn']['wq']"][0] == (
        d2, tcfg.n_heads * tcfg.head_dim)


def test_init_params_take_the_true_fan_in_on_the_shared_block():
    """The reference's ``fan_in`` rule (shape[0], the scale ignored): the
    shared block's unstacked leaves draw with std 1/sqrt(d_in), its
    ``proj`` too (its 1/L scale is not read); a stacked SSM projection
    with 1/sqrt(L)."""
    cfg = dataclasses.replace(get_smoke_config(NAME), d_model=128,
                              d_ff=256, n_heads=4, head_dim=64)
    p = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                     device="cpu")
    sp = p["shared"]
    for w in (sp["attn"]["wq"], sp["attn"]["wo"], sp["mlp"]["w_up"],
              sp["mlp"]["w_down"], sp["proj"]):
        want = 1.0 / np.sqrt(w.shape[0])
        assert abs(w.std().item() / want - 1) < 0.05, tuple(w.shape)
    w = p["blocks"]["ssm"]["in_x"]
    assert abs(w.std().item() * np.sqrt(cfg.n_layers) - 1) < 0.05
    assert torch.equal(sp["ln1"]["scale"], torch.ones(2 * cfg.d_model))


def test_params_from_jax_and_prepare_match_jax():
    """The shared block crosses with ``params_from_jax``; ``prepare_params``
    quantizes its attn and mlp through the module tables and its proj
    under ``shared_proj``, depth-less, bit for bit the reference's; its
    norms stay raw."""
    jcfg, _, jparams, tcfg, _, tparams = pair()
    assert set(tparams["shared"]) == {"ln1", "attn", "ln2", "mlp", "proj"}
    np.testing.assert_array_equal(tparams["shared"]["proj"].numpy(),
                                  np.asarray(jparams["shared"]["proj"]))
    jp = jprepare(jcfg, jparams, POLICY)
    tp = prepare_params(tcfg, tparams, as_policy(POLICY))
    leaves = [("proj",)] + [("attn", k) for k in ("wq", "wk", "wv", "wo")] \
        + [("mlp", k) for k in ("w_gate", "w_up", "w_down")]
    for path in leaves:
        t, j = tp["shared"], jp["shared"]
        for k in path:
            t, j = t[k], j[k]
        assert isinstance(t, QState), path
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not isinstance(tp["shared"]["ln1"]["scale"], QState)
    assert isinstance(tp["blocks"]["ssm"]["in_x"], QState)


@pytest.mark.parametrize("policy", [None, POLICY])
def test_shared_block_matches_jax(policy, fused):
    """``blocks.shared_block`` against the reference's ``_shared_attn`` on
    the same h and emb0, a prefill of 12 rows into a 16-row cache."""
    jcfg, _, jparams, tcfg, _, tparams = pair()
    rng = np.random.RandomState(3)
    h = rng.randn(2, 12, tcfg.d_model).astype(np.float32)
    e0 = rng.randn(2, 12, tcfg.d_model).astype(np.float32)
    jp = jprepare(jcfg, jparams, policy) if policy else jparams
    tpol = as_policy(policy)
    tp = prepare_params(tcfg, tparams, tpol) if policy else tparams
    kv_spec = tpol.kv_spec()
    jcache = jax.tree_util.tree_map(
        lambda x: x[0], jlm.init_caches(jcfg, 2, 16, jnp.float32,
                                        kv_spec=jax_kv_spec(policy))[0])
    positions = np.broadcast_to(np.arange(12), (2, 12))
    jout, jc = jax.jit(lambda p, x, e, c: jlm._shared_attn(
        p, x, e, jcfg, policy=jax_policy(policy), rules=None,
        positions=jnp.asarray(positions), mask={"kind": "causal"}, cache=c,
        cache_offset=0))(jp, jnp.asarray(h), jnp.asarray(e0), jcache)
    tcache = {k: v[0] for k, v in lm.init_decode_caches(
        tcfg, 2, 16, torch.float32, kv_spec=kv_spec)[0].items()}
    tout = blocks.shared_block(tp["shared"], torch.from_numpy(h),
                               torch.from_numpy(e0), tcfg, policy=tpol,
                               cache=tcache, cache_offset=0,
                               rope=rope_tables(torch.from_numpy(
                                   positions.copy()), tcfg.head_dim,
                                   tcfg.rope_theta))
    assert _rel(tout.numpy(), _np(jout)) <= (1e-5 if policy is None else TOL)
    _caches_close(tcache, jc, policy)


def jax_policy(policy):
    from repro.core.qpolicy import as_policy as jas_policy
    return jas_policy(policy)


def jax_kv_spec(policy):
    return jax_policy(policy).kv_spec()


def _caches_close(tc, jc, policy):
    """Every cache buffer: int8 payloads bit for bit and scales within 8
    fp32 ulps under the W8A8 policy; fp buffers within ``TOL`` of the
    largest."""
    assert set(tc) == set(jc)
    for k, t in tc.items():
        t, j = t.numpy(), _np(jc[k])
        assert t.shape == j.shape, k
        if policy is None:
            assert _rel(t, j) <= TOL, (k, _rel(t, j))
        elif k.endswith("_scale"):
            assert _ulps(t, j) <= 8, (k, _ulps(t, j))
        else:
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("policy", [None, POLICY])
def test_prefill_and_decode_match_jax(policy, fused):
    """The whole stack (two groups of two SSM layers, each followed by the
    shared block): prefill of 20 tokens into 32-row buffers, then three
    decode steps; the decode leaves the SSM states it is given as they
    were and writes the KV rows in place."""
    _, jmodel, jparams, _, tmodel, tparams = pair()
    tpol = policy and policy.replace("int8_pallas", "int8_cuda")
    toks = np.random.RandomState(1).randint(0, 512, (2, 23)).astype(np.int32)
    jprefill = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, policy=policy, max_seq=32))
    jdecode = jax.jit(lambda p, st, t, pos: jmodel.decode(
        p, st, t, pos, policy=policy))
    jl, jst = jprefill(jparams, jnp.asarray(toks[:, :20]))
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(toks[:, :20]),
                             policy=tpol, max_seq=32)

    def close(tl, tst, jl, jst):
        assert _rel(tl.numpy(), _np(jl)) <= TOL
        assert tst["caches"]["k"].shape[0] == 2          # G invocations
        _caches_close(tst["caches"], jst["caches"], policy)
        for k in ("ssm", "conv"):
            assert tst["ssm"][k].shape == jst["ssm"][k].shape, k
            assert _rel(tst["ssm"][k].numpy(), _np(jst["ssm"][k])) <= TOL, k
    close(tl, tst, jl, jst)
    for i in range(3):
        tok = toks[:, 20 + i:21 + i]
        jl, jst = jdecode(jparams, jst, jnp.asarray(tok),
                          jnp.full((2,), 20 + i, jnp.int32))
        before = {k: v.clone() for k, v in tst["ssm"].items()}
        given = tst
        tl, tst = tmodel.decode(tparams, tst, torch.from_numpy(tok),
                                torch.full((2,), 20 + i), policy=tpol)
        close(tl, tst, jl, jst)
        for k, v in before.items():
            assert torch.equal(given["ssm"][k], v), k
        assert tst["caches"] is given["caches"]


def test_packed_prefill_raises():
    _, _, _, _, tmodel, tparams = pair()
    toks = torch.zeros((1, 16), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="attention-family only"):
        tmodel.prefill(tparams, toks, segments=torch.zeros_like(toks))


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_training_refuses_encdec_and_vlm_before_any_state(family,
                                                          monkeypatch):
    """The hybrid trains (``check_trainable`` takes it), and so does the
    encoder-decoder (seamless-m4t); encdec without an encoder and the VLM
    -- here zamba2's smoke config relabelled -- are still refused by
    ``check_trainable`` and by the launcher with ROADMAP item 6's message,
    the launcher before it draws any parameter."""
    from repro_torch.launch import train as launcher
    check_trainable(get_config(NAME))
    check_trainable(get_smoke_config(NAME))
    if family == "encdec":
        check_trainable(get_config("seamless-m4t-medium"))
        check_trainable(get_smoke_config("seamless-m4t-medium"))
    bad = dataclasses.replace(get_smoke_config(NAME), family=family)
    with pytest.raises(NotImplementedError, match="section 1, item 6"):
        check_trainable(bad)
    calls = []
    monkeypatch.setattr(launcher, "get_smoke_config", lambda name: bad)
    monkeypatch.setattr(launcher, "build_model",
                        lambda *a, **k: calls.append(a))
    with pytest.raises(NotImplementedError, match="section 1, item 6"):
        launcher.main(["--arch", NAME, "--smoke", "--steps", "1",
                       "--device", "cpu"])
    assert calls == []


def test_check_supported_takes_whole_groups_only():
    """A hybrid config needs a shared block every ``hybrid_attn_every`` > 0
    layers and a whole number of groups (the reference reshapes the
    stack into them); experts stay under ``family='moe'``."""
    cfg = get_smoke_config(NAME)
    _check_supported(cfg)
    _check_supported(dataclasses.replace(cfg, n_layers=2))
    for bad in (dict(hybrid_attn_every=0), dict(n_layers=3),
                dict(n_experts=4, top_k=2)):
        with pytest.raises(NotImplementedError, match="section 1, item 6"):
            _check_supported(dataclasses.replace(cfg, **bad))


# ---------------------------------------------------------------------------
# #11 and #12/#13 at head dim 160: the plain versions against Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kh", [(2, 2), (4, 1)])
def test_flash_q8_plain_at_hd160_matches_pallas(h, kh):
    """#11's plain version (what the wrapper runs on CPU tensors) at hd 160
    against the Pallas kernel in interpret mode, causal over a 24-row
    buffer with its tail unwritten."""
    b, sq, smax, hd = 2, 10, 24, 160
    q, kq, ks, vq, vs, *_ = _decode_inputs(b, smax, kh, 1, hd, [sq + 4] * b,
                                           seed=160 + h)
    q = np.random.RandomState(h).randn(b, sq, h, hd).astype(np.float32)
    j = j_flash(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs)), causal=True,
                q_offset=4, block_q=8, block_k=8, interpret=True)
    t = flash_attention_fwd_q8(*(torch.from_numpy(a) for a in
                                 (q, kq, ks, vq, vs)), causal=True,
                               q_offset=4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("lengths", [[1, 5, 11], [0, 12, 7]])   # 12 == S
def test_decode_plain_at_hd160_matches_pallas(lengths):
    """#12's plain version at hd 160 (G = 1, Zamba2's; and G = 2) against
    the Pallas kernel: the context within 1e-5, the written payloads bit
    for bit; #13's plain version over shuffled pages of 4 rows equals
    #12's on the same logical cache, context and written rows."""
    for g in (1, 2):
        q, kq, ks, vq, vs, nk, nv, pos = _decode_inputs(3, 12, 2, g, 160,
                                                        lengths, seed=g)
        jout = j_decode(*(jnp.asarray(a) for a in
                          (q, kq, ks, vq, vs, nk, nv, pos)),
                        block_k=4, interpret=True)
        tc = [torch.from_numpy(a.copy()) for a in (kq, ks, vq, vs)]
        args = [torch.from_numpy(a) for a in (q, nk, nv, pos)]
        ctx = decode_attention(args[0], *tc, *args[1:])
        np.testing.assert_allclose(ctx.numpy(), np.asarray(jout[0]),
                                   atol=1e-5)
        for i in (0, 2):
            np.testing.assert_array_equal(tc[i].numpy(),
                                          np.asarray(jout[1 + i]))
        # the same logical cache as pools of 4-row pages in shuffled order
        perm = np.random.RandomState(g).permutation(9) + 1
        table = torch.from_numpy(perm.reshape(3, 3).astype(np.int32))
        pools = []
        for a in (kq, ks, vq, vs):
            pool = np.zeros((10, 4) + a.shape[2:], a.dtype)
            pool[perm] = a.reshape(9, 4, *a.shape[2:])
            pools.append(torch.from_numpy(pool))
        dense = [torch.from_numpy(a.copy()) for a in (kq, ks, vq, vs)]
        want = decode_attention_plain(args[0], *dense, *args[1:])
        got = decode_attention_paged_plain(args[0], *pools, *args[1:], table)
        assert torch.equal(got, want)
        for pool, d in zip(pools, dense):
            view = pool[table.long()].reshape(3, 12, *pool.shape[2:])
            assert torch.equal(view, d)


def _chunk_thread_map(hd):
    """The chunk kernel's map of ``csrc/decode_attn.cu`` (``lane_group``,
    RP, NG): thread -> (cache row of each sub-tile, 16-byte segment or
    None for an idle lane)."""
    threads, chunk = 128, 128
    ns = hd // 16
    lg = 1
    while lg < ns:
        lg *= 2
    rp = threads // lg
    return ns, lg, rp, chunk // rp


@pytest.mark.parametrize("hd", [32, 64, 128, 160, 256])
def test_decode_chunk_thread_map_tiles_the_chunk(hd):
    """At every head dim the kernel takes, the sub-tiles cover each of a
    chunk's 128 rows once, each row's segments once, and each row's lanes
    form an aligned power-of-two group inside one warp (the shuffle
    butterfly's span); at hd 160, 10 live lanes of 16 a row."""
    from repro_torch.kernels.decode_attn import DECODE_CHUNK, _HEAD_DIMS
    assert hd in _HEAD_DIMS and DECODE_CHUNK == 128
    ns, lg, rp, ng = _chunk_thread_map(hd)
    assert lg & (lg - 1) == 0 and ns <= lg <= 32 and rp * ng == 128
    seen = {}
    for j in range(ng):
        for tid in range(128):
            row, seg = j * rp + tid // lg, tid % lg
            assert (tid // lg) * lg // 32 == tid // 32 or lg > 32
            if seg < ns:
                seen[(row, seg)] = seen.get((row, seg), 0) + 1
    assert seen == {(r, s): 1 for r in range(128) for s in range(ns)}
    if hd == 160:
        assert (ns, lg, rp, ng) == (10, 16, 8, 16)


@pytest.mark.parametrize("n", [80, 128])
def test_in_dt_and_in_bc_weights_need_no_padded_copy(n):
    """Zamba2's in_dt (2560, 80) and in_bc (2560, 128): every layer's view
    of the stacked prepared payload is already the K-major operand the
    card's routes read (``kmajor_weight`` returns it as it is: N a
    multiple of 16, each view 16-byte aligned), unlike Mamba2-130M's
    N = 24."""
    from repro_torch.kernels.int8_matmul import kmajor_weight
    stacked = torch.zeros((3, 2560, n), dtype=torch.int8)
    for layer in stacked.unbind(0):
        assert kmajor_weight(layer) is layer
    assert kmajor_weight(torch.zeros((768, 24), dtype=torch.int8)).shape \
        == (768, 32)
