"""The port's Mamba2 layer (``repro_torch/models/ssm.py``) against the JAX
package's (``repro/models/ssm.py``) on the same numpy inputs from a seed,
and the int8 kernels' plain versions at the layer's projection shapes.

* ``ssd_chunked`` against JAX's and against the sequential
  ``ssd_reference`` of both packages, at float32 and bfloat16, with and
  without an initial state, on a sequence of two 128-row chunks and on one
  of 48 rows run as one chunk (what ``ssm_apply`` does when 128 does not
  divide it).  Tolerances, relative to the largest |y| (and |state|):
  float32 1e-5 against JAX and 1e-4 against the sequential scan (the chunked
  sums run in another order); bfloat16 4e-2 against JAX (the intra-chunk
  tensors are rounded to bf16 op by op here, while XLA's CPU backend may
  keep a fused chain in fp32) and 6e-2 against the float32 scan.
* ``_causal_conv`` with a left context: out and new tail within 1e-6 at
  float32, bit for bit at bf16 up to one bf16 step.
* ``ssm_apply`` over a sequence against ``ssm_decode_step`` run token by
  token from the same state (the outputs and final states within 2e-5 of
  the largest), and against JAX's ``ssm_apply`` (2e-5) under the fp and the
  W8A8 policies.
* The five projections' (K, N) at Mamba2-130M's widths, among them the
  first output width that is no multiple of 16 (``in_dt``, N = 24): the
  prepared int8 linear against JAX's ``int8_prepared_linear`` (interpret
  mode, eagerly), bit for bit; the card's staged forward (the padded
  K-major copy of ``kmajor_weight``, the weight transpose, the GEMM), the
  cluster route's split model, and the backward's staged nt and tn (g
  padded to pad16(24) = 32 columns; a (768, 24) dW) against the plain
  versions and JAX's ``int8_bwd_dx`` / ``int8_bwd_dw``, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core.qconfig import Granularity as JGranularity
from repro.core.qconfig import QuantSpec as JQuantSpec
from repro.kernels.ops import int8_bwd_dw as j_dw, int8_bwd_dx as j_dx
from repro.kernels.ops import int8_prepared_linear as j_prepared_linear
from repro.models import ssm as jssm

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.qconfig import Granularity, QuantSpec
from repro_torch.core.qpolicy import as_policy
from repro_torch.core.quantizer import quantize_int
from repro_torch.kernels import ops
from repro_torch.models import ssm
from test_torch_int8_bwd import im, q_scales, staged_nt, staged_tn
from test_torch_int8_decode import cluster_model
from test_torch_int8_fwd import staged_fwd

SPEC = QuantSpec(8, Granularity.PER_TOKEN)
W8A8 = "*=w8c+a8t@int8_pallas"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def ssd_inputs(b, s, h, p, g, n, seed):
    """x, dt (softplus of a normal), a (negative), B, C and an initial
    state, float32 numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h) - 1.0)).astype(np.float32)
    a = -np.exp(rng.randn(h) * 0.5).astype(np.float32)
    bm = rng.randn(b, s, g, n).astype(np.float32)
    cm = rng.randn(b, s, g, n).astype(np.float32)
    st = rng.randn(b, h, n, p).astype(np.float32)
    return x, dt, a, bm, cm, st


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("s,chunk", [(256, 128), (48, 48)])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax_and_the_scan(s, chunk, init, dtype):
    x, dt, a, bm, cm, st = ssd_inputs(2, s, 4, 8, 1, 16, seed=s + init)
    init_np = st if init else None
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jy, jfin = jssm.ssd_chunked(
        jx, jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm), jnp.asarray(cm),
        init_state=None if init_np is None else jnp.asarray(init_np),
        chunk=chunk)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    targs = (torch.from_numpy(dt), torch.from_numpy(a), torch.from_numpy(bm),
             torch.from_numpy(cm),
             None if init_np is None else torch.from_numpy(init_np))
    ty, tfin = ssm.ssd_chunked(tx, *targs, chunk=chunk)
    ry, rfin = ssm.ssd_reference(tx.float(), *targs)
    jry, jrfin = jssm.ssd_reference(
        jx.astype(jnp.float32), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
        jnp.asarray(cm),
        init_state=None if init_np is None else jnp.asarray(init_np))
    assert ty.dtype == tx.dtype and tfin.dtype == torch.float32
    yj = np.asarray(jy.astype(jnp.float32))
    tol_j, tol_r = (1e-5, 1e-4) if dtype == "float32" else (4e-2, 6e-2)
    assert _rel(ty.float().numpy(), yj) <= tol_j
    assert _rel(tfin.numpy(), np.asarray(jfin)) <= tol_j
    assert _rel(ty.float().numpy(), ry.numpy()) <= tol_r
    assert _rel(tfin.numpy(), rfin.numpy()) <= tol_r
    # the two sequential oracles agree
    assert _rel(ry.numpy(), np.asarray(jry)) <= 1e-5
    assert _rel(rfin.numpy(), np.asarray(jrfin)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_with_a_tail_matches_jax(dtype):
    rng = np.random.RandomState(3)
    xbc = rng.randn(2, 5, 40).astype(np.float32)
    w = rng.randn(4, 40).astype(np.float32) * 0.5
    bias = rng.randn(40).astype(np.float32) * 0.1
    tail = rng.randn(2, 3, 40).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jtail = jssm._causal_conv(jnp.asarray(xbc).astype(jdt),
                                    jnp.asarray(w), jnp.asarray(bias),
                                    jnp.asarray(tail).astype(jdt))
    tx = torch.from_numpy(xbc).to(tdt)
    tt = torch.from_numpy(tail).to(tdt)
    out, new_tail = ssm._causal_conv(tx, torch.from_numpy(w),
                                     torch.from_numpy(bias), tt)
    assert out.dtype == tdt and new_tail.dtype == tdt
    # the new tail is the last 3 rows of tail + xbc, copied exactly
    np.testing.assert_array_equal(new_tail.float().numpy(),
                                  np.asarray(jtail.astype(jnp.float32)))
    assert torch.equal(new_tail, tx[:, 2:])
    step = 1e-6 if dtype == "float32" else 2.0 ** -7
    want = np.asarray(jout.astype(jnp.float32))
    assert np.abs(out.float().numpy() - want).max() <= step * max(
        1.0, np.abs(want).max())
    # no tail: zeros on the left
    z, _ = ssm._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(bias))
    z2, _ = ssm._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(bias),
                             torch.zeros_like(tt))
    assert torch.equal(z, z2)


def layer0_pair(dtype="float32"):
    """(jax cfg, jax layer-0 ssm params, torch cfg, torch params) of the
    mamba2 smoke config."""
    jcfg = dataclasses.replace(jsmoke("mamba2-130m"), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config("mamba2-130m"), dtype=dtype)
    rng = np.random.RandomState(11)
    spec = ssm.ssm_spec(tcfg)
    params = {}
    for name, (shape, init, *_) in spec.items():
        if init == "fan_in":
            params[name] = rng.randn(*shape) / np.sqrt(shape[0])
        elif name == "A_log":
            params[name] = rng.randn(*shape) * 0.3
        else:
            params[name] = 1.0 + rng.randn(*shape) * 0.1
        params[name] = params[name].astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    return jcfg, jp, tcfg, tp


def _state(tcfg, b, seed):
    dm = ssm.ssm_dims(tcfg)
    rng = np.random.RandomState(seed)
    return {"ssm": rng.randn(b, dm.n_heads, dm.n_state,
                             dm.head_dim).astype(np.float32),
            "conv": rng.randn(b, dm.conv_width - 1,
                              dm.conv_dim).astype(np.float32)}


@pytest.mark.parametrize("policy", [None, W8A8])
def test_ssm_apply_matches_decode_steps_and_jax(policy):
    jcfg, jp, tcfg, tp = layer0_pair()
    tpol = as_policy(policy and policy.replace("pallas", "cuda"))
    rng = np.random.RandomState(5)
    u = rng.randn(2, 9, tcfg.d_model).astype(np.float32)
    st0 = _state(tcfg, 2, 6)
    tst = {k: torch.from_numpy(v) for k, v in st0.items()}
    saved = {k: v.clone() for k, v in tst.items()}
    out, fin = ssm.ssm_apply(tp, torch.from_numpy(u), tcfg, policy=tpol,
                             state=tst, return_state=True, layer=0,
                             n_layers=2)
    jout, jfin = jax.jit(lambda p, x, st: jssm.ssm_apply(
        p, x, jcfg, policy=policy, state=st, return_state=True, layer=0,
        n_layers=2))(jp, jnp.asarray(u),
                     {k: jnp.asarray(v) for k, v in st0.items()})
    assert _rel(out.numpy(), np.asarray(jout)) <= 2e-5
    for k in ("ssm", "conv"):
        assert _rel(fin[k].numpy(), np.asarray(jfin[k])) <= 2e-5, k
    # token by token from the same state
    st, outs = tst, []
    for t in range(u.shape[1]):
        o, st = ssm.ssm_decode_step(tp, torch.from_numpy(u[:, t:t + 1]), tcfg,
                                    policy=tpol, state=st, layer=0,
                                    n_layers=2)
        outs.append(o)
    assert _rel(torch.cat(outs, dim=1).numpy(), out.numpy()) <= 2e-5
    assert _rel(st["ssm"].numpy(), fin["ssm"].numpy()) <= 2e-5
    assert _rel(st["conv"].numpy(), fin["conv"].numpy()) <= 2e-5
    # neither entry writes the state it is given
    for k in tst:
        assert torch.equal(tst[k], saved[k])


def test_ssm_spec_is_the_reference_layout():
    """The port's spec: the reference's leaves, shapes and init kinds (and
    out_proj's 1 / n_layers scale) at Mamba2-130M's widths."""
    jcfg = jsmoke("mamba2-130m")
    for tcfg, jc in ((get_smoke_config("mamba2-130m"), jcfg),
                     (get_config("mamba2-130m"),
                      dataclasses.replace(jcfg, n_layers=24, d_model=768,
                                          vocab_size=50280, ssm_state=128,
                                          ssm_head_dim=64))):
        spec, jspec = ssm.ssm_spec(tcfg), jssm.ssm_spec(jc)
        assert list(spec) == list(jspec)
        for k, (shape, init, *scale) in spec.items():
            assert shape == jspec[k].shape and init == jspec[k].init, k
            if scale:
                assert scale[0] == jspec[k].scale
    dm = ssm.ssm_dims(get_config("mamba2-130m"))
    assert dm == (1536, 24, 64, 128, 1, 4, 1792)


#: the five projections of Mamba2-130M: in_z and in_x, in_bc, in_dt,
#: out_proj
SSM_KN = [(768, 1536), (768, 256), (768, 24), (1536, 768)]


def _weight(k, n, seed):
    rng = np.random.RandomState(seed)
    wq = rng.randint(-128, 128, (k, n)).astype(np.int8)
    ws = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    return wq, ws


@pytest.mark.parametrize("k,n", SSM_KN)
@pytest.mark.parametrize("m,dtype", [(16, "bfloat16"), (40, "float32")])
def test_projection_shapes_prepared_linear_matches_jax(k, n, m, dtype):
    """``ops.int8_prepared_linear`` (the plain versions on the CPU) against
    JAX's at the projections' (K, N), at a decode step's rows (M = 16, the
    bf16 carrier) and a prefill's."""
    wq, ws = _weight(k, n, k + n)
    x = (np.random.RandomState(m).randn(m, k) * 2).astype(np.float32)
    x[1] = 0.0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    with jax.disable_jit():
        j = j_prepared_linear(jx, jnp.asarray(wq), jnp.asarray(ws),
                              JQuantSpec(8, JGranularity.PER_TOKEN),
                              interpret=True)
    got = ops.int8_prepared_linear(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(wq),
        torch.from_numpy(ws), SPEC)
    assert tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("k,n", SSM_KN)
def test_projection_shapes_forward_stages_equal_plain(k, n):
    """The card's forward at the projections' (K, N): the staged wgmma
    route (x through ``kmajor_weight``, w transposed to (N, pad16(K))) and
    the cluster route's split model at every cluster size, bit for bit
    the plain version; at N = 24 the K-major copy pads 24 to 32 with
    zeros."""
    wq, ws = _weight(k, n, 2 * k + n)
    w = torch.from_numpy(wq)
    cs = torch.from_numpy(ws)
    x = torch.from_numpy((np.random.RandomState(n).randn(40, k) * 2)
                         .astype(np.float32))
    xq, rs, _ = quantize_int(x, SPEC)
    for dt in (torch.float32, torch.bfloat16):
        want = im.int8_matmul_plain(xq, w, rs, cs, out_dtype=dt)
        assert torch.equal(staged_fwd(xq, w, rs, cs, dt), want)
        x16 = x[:16].to(dt)
        want16 = im.int8_quant_matmul_plain(x16, w, cs, SPEC, dt)
        for splits in (1, 2, 8):
            got = cluster_model(x16, w, None, cs, SPEC, splits, dt)
            assert torch.equal(got, want16), (dt, splits)
    kw = im.kmajor_weight(w)
    assert kw.shape == (k, -(-n // 16) * 16)
    assert torch.equal(kw[:, :n], w) and not kw[:, n:].any()


@pytest.mark.parametrize("k,n,dtype",
                         [(k, n, torch.bfloat16) for k, n in SSM_KN]
                         + [(768, 24, torch.float32)])
def test_projection_shapes_backward_stages_match_jax(k, n, dtype):
    """The backward's staged nt (dx; g quantized into (M, pad16(N))) and
    tn (dW (K, N), a (768, 24) one for in_dt) at 130 tokens, bit for bit
    the plain versions and JAX's ``int8_bwd_dx`` / ``int8_bwd_dw``."""
    m = 130
    rng = np.random.RandomState(k + 3 * n)
    g = (rng.randn(m, n) * 0.02).astype(np.float32)
    w = rng.randint(-128, 128, (k, n)).astype(np.int8)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    fw = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    fx = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    tg = torch.from_numpy(g).to(dtype)
    fw_t, fx_t = torch.from_numpy(fw), torch.from_numpy(fx)
    qn, qt = q_scales(tg, fw_t, 1), q_scales(tg, fx_t, 0)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    dx = staged_nt(tg, tw, fw_t, qn, dtype, n)
    assert torch.equal(dx, im.int8_matmul_nt_plain(tg, tw, fw_t, qn, dtype))
    dw = staged_tn(tx, tg, fx_t, qt, torch.float32, m)
    assert tuple(dw.shape) == (k, n)
    assert torch.equal(dw, im.int8_matmul_tn_plain(tx, tg, fx_t, qt,
                                                   torch.float32))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jg = jnp.asarray(g).astype(jdt)
    jdx = j_dx(jg, jnp.asarray(w), jnp.asarray(fw), interpret=True)
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(jdx.astype(jnp.float32)))
    jdw = j_dw(jnp.asarray(x), jnp.asarray(fx), jg, out_dtype=jnp.float32,
               interpret=True)
    np.testing.assert_array_equal(dw.numpy(), np.asarray(jdw))
