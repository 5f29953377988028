"""The MoE family's training modules against the JAX package and against
themselves, on the CPU (the kernels' plain versions; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do).  Inputs come from
numpy with a seed.

* The expert-batched #4 and #5 (``int8_matmul_nt_experts``,
  ``int8_matmul_tn_experts``): their plain versions, and the wrappers on
  CPU tensors, equal the per-expert loop of the 2-D plain versions bit for
  bit, at ragged C and at C = 1.
* ``_QLinearInt8Experts`` against ``jax.vjp`` of the reference's ``vmap``
  of ``int8_quantized_linear``: payloads and scales equal; y, dx and dW
  bit for bit at float32 and at bfloat16 (the same integer products, the
  same epilogue roundings, the same absmax reduces); the out-of-contract
  recipe (no G spec) against the reference's replay bit for bit too; and
  each expert's slice equal to the 2-D ``_QLinearInt8`` on it.
* The dispatch gather's backward at bfloat16 against the JAX transpose of
  ``take(x2, token_idx)``, bit for bit on the same rows (the CPU
  scatter-add adds a token's k rows in index order in the carrier).
* The aux and z terms' gradient into ``w_router`` within 1e-5 relative
  to its largest entry (softmax and logsumexp round differently in XLA
  and PyTorch).
* A checkpointed MoE block whose recomputation routes otherwise than its
  forward raises.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qlinear import int8_quantized_linear as j_int8_linear
from repro.core.qpolicy import LinearCtx as JCtx, parse_policy as jparse
from repro.core.quantizer import quantize_int as j_quantize_int
from repro.models import moe as jmoe

import repro_torch.core.qlinear as qlinear
import repro_torch.core.qpolicy as qpolicy
from repro_torch.configs import get_smoke_config
from repro_torch.core.qpolicy import LinearCtx, as_policy, parse_policy
from repro_torch.models import moe
from repro_torch.models.common import checkpointed

im = importlib.import_module("repro_torch.kernels.int8_matmul")
W8A8G8 = "*=w8c+a8t+g8t@int8_pallas"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bwd_case(e, c, k, n, dtype, seed):
    rng = np.random.RandomState(seed)
    g = torch.from_numpy((rng.randn(e, c, n) * 0.02).astype(np.float32))
    g[:, :, 0] = 0.0
    g = g.to(dtype)
    w = torch.from_numpy(rng.randint(-128, 128, (e, k, n)).astype(np.int8))
    x = torch.from_numpy(rng.randint(-128, 128, (e, c, k)).astype(np.int8))
    fw = torch.from_numpy(rng.uniform(1e-3, 0.1, (e, 1, n)).astype(
        np.float32))
    fx = torch.from_numpy(rng.uniform(1e-3, 0.1, (e, c, 1)).astype(
        np.float32))
    qn = (g.float().abs() * fw).amax(dim=2, keepdim=True).clamp_min(1e-12)
    qn = qn / torch.full_like(qn, 127.0)
    qt = (g.float().abs() * fx).amax(dim=1, keepdim=True).clamp_min(1e-12)
    qt = qt / torch.full_like(qt, 127.0)
    qn[:, ::3] = 0.0                # zero scales: the guard maps them to 1
    return g, w, x, fw, fx, qn, qt


@pytest.mark.parametrize("e,c,k,n", [(3, 17, 48, 40), (4, 1, 24, 16),
                                     (2, 33, 90, 257), (5, 2, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_bwd_plain_is_the_per_expert_loop(e, c, k, n, dtype):
    g, w, x, fw, fx, qn, qt = _bwd_case(e, c, k, n, dtype, e + c + k + n)
    for out in (torch.float32, torch.bfloat16):
        nt = im.int8_matmul_nt_experts(g, w, fw, qn, out_dtype=out)
        assert nt.shape == (e, c, k)
        assert torch.equal(nt, im.int8_matmul_nt_experts_plain(
            g, w, fw, qn, out_dtype=out))
        assert torch.equal(nt, torch.stack([im.int8_matmul_nt_plain(
            g[i], w[i], fw[i], qn[i], out_dtype=out) for i in range(e)]))
        tn = im.int8_matmul_tn_experts(x, g, fx, qt, out_dtype=out)
        assert tn.shape == (e, k, n)
        assert torch.equal(tn, im.int8_matmul_tn_experts_plain(
            x, g, fx, qt, out_dtype=out))
        assert torch.equal(tn, torch.stack([im.int8_matmul_tn_plain(
            x[i], g[i], fx[i], qt[i], out_dtype=out) for i in range(e)]))
    # CPU tensors take the plain versions and count no launch
    assert im.int8_matmul_nt_experts.launches == 0
    assert im.int8_matmul_tn_experts.launches == 0


def test_expert_bwd_wrappers_refuse_bad_shapes():
    g, w, x, fw, fx, qn, qt = _bwd_case(3, 5, 16, 8, torch.float32, 0)
    with pytest.raises(ValueError, match="int8_matmul_nt_experts"):
        im.int8_matmul_nt_experts(g[0], w[0], fw[0], qn[0])
    with pytest.raises(ValueError, match="int8_matmul_nt_experts"):
        im.int8_matmul_nt_experts(g, w[:, :, :4], fw, qn)
    with pytest.raises(ValueError, match="int8_matmul_tn_experts"):
        im.int8_matmul_tn_experts(x, g, fx[:, :2], qt)
    with pytest.raises(ValueError, match="int8_matmul_tn_experts"):
        im.int8_matmul_tn_experts(x[:, :4], g, fx, qt)


def _linear_case(e, c, k, n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(e, c, k).astype(np.float32)
    x[0, 1] = 0.0                          # an empty capacity row
    w = (rs.randn(e, k, n) / 7).astype(np.float32)
    g = rs.randn(e, c, n).astype(np.float32)
    return x, w, g


def _jax_linear(policy, x, w, g, jdt):
    rec = jparse(policy).default
    f = jax.vmap(lambda a, b: j_int8_linear(a, b, rec))
    y, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    return (y, *vjp(jnp.asarray(g, jdt)))


def _port_linear(policy, x, w, g, tdt):
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(True)
    y = qlinear.int8_quantized_linear_experts(
        xt, wt, parse_policy(policy).default)
    return (y, *torch.autograd.grad(y, (xt, wt), torch.from_numpy(g).to(tdt)))


@pytest.mark.parametrize("policy", [W8A8G8, "*=w8c+a8n+g8t@int8_pallas",
                                    "*=w8n+a8t@int8_pallas"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qlinear_experts_matches_jax_vmap(policy, dtype):
    """y, dx and dW bit for bit against ``jax.vjp`` of the vmapped
    reference: per-token and per-expert per-tensor activations, and the
    out-of-contract recipe without a G spec (the reference's replay)."""
    jdt, tdt = DTYPES[dtype]
    x, w, g = _linear_case(4, 13, 48, 40, 0)
    want = _jax_linear(policy, x, w, g, jdt)
    got = _port_linear(policy, x, w, g, tdt)
    for name, t, j in zip(("y", "dx", "dw"), got, want):
        assert t.dtype == tdt, name
        np.testing.assert_array_equal(t.detach().float().numpy(), _np(j),
                                      err_msg=name)


@pytest.mark.parametrize("policy", [W8A8G8, "*=w8n+a8n+g8t@int8_pallas"])
def test_qlinear_experts_payloads_match_jax(policy):
    """The forward's payloads and scales, expert by expert, equal the
    reference's ``quantize_int`` on each expert's slice."""
    rec = parse_policy(policy).default
    jrec = jparse(policy).default
    x, w, _ = _linear_case(3, 9, 32, 24, 1)
    for t, spec, jspec in ((x, rec.acts, jrec.acts),
                           (w, rec.weights, jrec.weights)):
        q, s = qlinear.quantize_experts(torch.from_numpy(t), spec)
        jq, js, _ = jax.vmap(lambda a: j_quantize_int(a, jspec))(
            jnp.asarray(t))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("policy", [W8A8G8, "*=w8c+a8t@int8_pallas"])
def test_qlinear_experts_is_the_2d_linear_per_expert(policy):
    """Each expert's y, dx and dW equal the 2-D ``_QLinearInt8`` on its
    slices, bit for bit (in contract and out of it)."""
    x, w, g = _linear_case(5, 7, 24, 16, 2)
    rec = parse_policy(policy).default
    got = _port_linear(policy, x, w, g, torch.bfloat16)
    for e in range(5):
        xe = torch.from_numpy(x[e]).to(torch.bfloat16).requires_grad_(True)
        we = torch.from_numpy(w[e]).to(torch.bfloat16).requires_grad_(True)
        ye = qlinear.int8_quantized_linear(xe, we, rec)
        dxe, dwe = torch.autograd.grad(
            ye, (xe, we), torch.from_numpy(g[e]).to(torch.bfloat16))
        for t, want in zip(got, (ye, dxe, dwe)):
            assert torch.equal(t[e], want)


def test_policy_runs_raw_experts_in_one_call(monkeypatch):
    """Under ``int8_cuda`` a raw (E, d, ff) weight whose recipe fits the
    contract takes ``int8_quantized_linear_experts`` once; fake quant and a
    recipe outside the contract keep the per-expert loop of the 2-D
    path."""
    calls = {"experts": 0, "int8": 0, "fake": 0}

    def spy(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    be = qpolicy.KERNEL_BACKENDS
    monkeypatch.setitem(be, "int8_cuda", be["int8_cuda"]._replace(
        fn=spy("int8", be["int8_cuda"].fn),
        experts_fn=spy("experts", be["int8_cuda"].experts_fn)))
    monkeypatch.setitem(be, "fake_quant", be["fake_quant"]._replace(
        fn=spy("fake", be["fake_quant"].fn)))
    x = torch.randn(4, 6, 16)
    w = torch.randn(4, 16, 8)
    ctx = LinearCtx("mlp_up", 0, 2)
    for policy, want in (("*=w8c+a8t+g8t@int8_cuda", (1, 0, 0)),
                         ("*=w8c+a8t@int8_cuda", (1, 0, 0)),
                         ("*=w8c+a8t+g8t", (0, 0, 0, 4)),
                         ("*=w4c+a8t@int8_cuda", (0, 0, 0, 4))):
        for key in calls:
            calls[key] = 0
        y = as_policy(policy).linear(ctx, x, w)
        assert y.shape == (4, 6, 8)
        assert (calls["experts"], calls["int8"]) == want[:2], policy
        if len(want) == 4:
            assert calls["fake"] == want[3], policy


@pytest.mark.parametrize("t,k", [(16, 2), (9, 8)])
def test_dispatch_backward_matches_jax_transpose(t, k):
    """The transpose of ``take(x2, repeat(arange(T), k))`` at bfloat16: the
    port's k ordered adds onto zeros equal the JAX scatter-add bit for bit
    on the same cotangent rows; one float32 sum rounded once would not."""
    rs = np.random.RandomState(t * k)
    x2 = (rs.randn(t, 32) * 3).astype(np.float32)
    ct = (rs.randn(t * k, 32) * 3).astype(np.float32)
    ct[:k, :4] = -0.0                       # signed zeros: 0 + -0 is +0
    idx = jnp.repeat(jnp.arange(t), k)
    _, vjp = jax.vjp(lambda a: jnp.take(a, idx, axis=0),
                     jnp.asarray(x2, jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(ct, jnp.bfloat16))[0].astype(
        jnp.float32))
    xt = torch.from_numpy(x2).to(torch.bfloat16).requires_grad_(True)
    rows = moe._TokenRows.apply(xt, k)
    assert torch.equal(rows, xt.repeat_interleave(k, dim=0))
    got, = torch.autograd.grad(rows, xt,
                               torch.from_numpy(ct).to(torch.bfloat16))
    got = got.float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    once = torch.from_numpy(ct).to(torch.bfloat16).float().reshape(
        t, k, -1).sum(1).to(torch.bfloat16).float().numpy()
    assert k == 2 or not np.array_equal(once, want)


def test_slot_rows_backward_writes_each_kept_row_once():
    """``_SlotRows``: the cotangent of each kept slot's row lands on its
    source row unchanged, never summed; the dummy slot's row (6 here, the
    dropped pairs') is the caller's to discard."""
    src = torch.randn(7, 5, requires_grad=True)
    idx = torch.tensor([3, 0, 6, 6, 5, 6])
    out = moe._SlotRows.apply(src, idx)
    assert torch.equal(out, src[idx])
    ct = torch.randn(6, 5)
    got, = torch.autograd.grad(out, src, ct)
    want = torch.zeros(7, 5)
    for r, i in zip(ct, idx.tolist()):
        want[i] = r
    assert torch.equal(got[:6], want[:6])
    assert any(torch.equal(got[6], ct[j]) for j in (2, 3, 5))


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_router_loss_gradients_match_jax(name):
    """The gradient of aux + z into ``w_router`` (with the gates' through a
    weighted sum), against ``jax.grad`` of the reference's ``_route``:
    within 1e-5 relative to its largest entry; the routes equal."""
    cfg = get_smoke_config(name)
    from repro.configs import get_smoke_config as jsmoke
    jcfg = jsmoke(name)
    rs = np.random.RandomState(4)
    x = rs.randn(40, cfg.d_model).astype(np.float32)
    w = (rs.randn(cfg.d_model, cfg.n_experts) / 8).astype(np.float32)
    wg = rs.randn(40, cfg.top_k).astype(np.float32)

    def jf(wr):
        gates, top_e, aux, z = jmoe._route(jnp.asarray(x), wr, jcfg,
                                           jparse("*=fp"), JCtx("router", 0,
                                                                2))
        return jnp.sum(gates * wg) + aux + z, top_e
    (_, jtop), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    gates, top_e, aux, z = moe._route(torch.from_numpy(x), wt, cfg,
                                      as_policy("*=fp"),
                                      LinearCtx("router", 0, 2))
    tg, = torch.autograd.grad((gates * torch.from_numpy(wg)).sum() + aux + z,
                              wt)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop))
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    # aux and z alone carry gradient into the router
    ta, = torch.autograd.grad(moe._route(
        torch.from_numpy(x), wt, cfg, as_policy("*=fp"),
        LinearCtx("router", 0, 2))[2], wt)
    assert float(ta.abs().max()) > 0


def test_recomputation_with_another_route_raises(monkeypatch):
    """A checkpointed MoE block records its routes in the forward; a
    recomputation that routes otherwise raises in the backward, and one
    that routes alike runs."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              dtype="float32")
    rs = np.random.RandomState(0)
    params = {"w_router": torch.from_numpy(
                  rs.randn(cfg.d_model, cfg.n_experts).astype(np.float32)),
              **{k: torch.from_numpy((rs.randn(*shape) / 8).astype(
                  np.float32)).requires_grad_(True)
                 for k, shape in (("w_gate", (8, 64, 32)),
                                  ("w_up", (8, 64, 32)),
                                  ("w_down", (8, 32, 64)))}}
    x = torch.from_numpy(rs.randn(1, 8, cfg.d_model).astype(
        np.float32)).requires_grad_(True)

    def block(xx):
        return moe.moe_apply(params, xx, cfg, layer=0, n_layers=1)[0]

    def loss():
        return checkpointed(block, x,
                            context_fn=moe.route_check_contexts).sum()
    torch.autograd.grad(loss(), x)
    route = moe._route
    calls = []

    def flipped(*args, **kw):
        out = route(*args, **kw)
        calls.append(1)
        if len(calls) == 2:                     # the recomputation's call
            return (out[0], out[1].flip(-1), *out[2:])
        return out
    monkeypatch.setattr(moe, "_route", flipped)
    with pytest.raises(RuntimeError, match="recomputation routed"):
        torch.autograd.grad(loss(), x)
