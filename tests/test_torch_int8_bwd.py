"""The staged int8 backward (``repro_torch.kernels.int8_matmul``) on the CPU.

On the card ``int8_matmul_nt`` and ``int8_matmul_tn`` run in stages: a
quantize pass that writes K-major int8 payloads once (nt: the rows of the
gradient; tn: its columns, transposed, and the activation payload,
transposed), then one int8 GEMM of two K-major operands with a rank-1
epilogue, split over the contraction where the output tiles cannot fill the
card.  Each stage has a plain version, and these tests hold the plain
stages' composition to the wrappers' plain versions and to the JAX
package's ``int8_bwd_dx`` / ``int8_bwd_dw`` (Pallas in interpret mode) --
bit for bit: every stage computes integers exactly and rounds the one
product ``float(sum) * scale`` as the plain versions do.  The kernels
themselves are held to the same plain stages on the card
(tests/test_torch_cuda.py).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import int8_bwd_dw as j_dw, int8_bwd_dx as j_dx

from repro_torch.core.quantizer import _EPS, _div

# the module (the package re-exports a function of the same name)
im = importlib.import_module("repro_torch.kernels.int8_matmul")

#: gpt2-mini's three linears at 2 x 64 tokens (test_torch_train.BWD_SHAPES)
#: and shapes off every tile and alignment: M of 1, 33 and 130 tokens, N =
#: 257 (neither payload row a multiple of 16 bytes), K = 90, contractions
#: that are no multiple of 32
SHAPES = [(128, 128, 128), (128, 512, 128), (128, 128, 512), (33, 257, 90),
          (1, 257, 90), (130, 257, 90), (300, 48, 40)]
DTYPES = [torch.float32, torch.bfloat16]


def bwd_inputs(m, n, k, seed):
    """g (m, n) with exact rounding ties (row 0 and column 6 reach a scale
    of exactly 1 under the fold scales set here), an all-zero row and
    column; int8 payloads w (k, n) and x (m, k); fold scales of both sides;
    and the per-token and per-channel q scales the wrappers in
    ``kernels/ops.py`` reduce, with every 7th set to 0 (the guard maps it to
    1)."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(m, n) * 0.02).astype(np.float32)
    ties = [0.5, 1.5, 2.5, -2.5, -0.5, -1.5, 4.5]
    g[0, :8] = [127.0, 0.5, 1.5, 2.5, -2.5, 0.0, 127.0, -3.5][:n]
    g[1:8, 6 % n] = ties[:max(0, min(m, 8) - 1)]
    g[3 % m] = 0.0
    g[:, 5 % n] = 0.0
    w = rng.randint(-128, 128, (k, n)).astype(np.int8)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    fw = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    fx = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    fw[0, :8], fx[:8] = 1.0, 1.0
    return g, w, x, fw, fx


def q_scales(g, fold, dim):
    """absmax / 127 of g * fold over ``dim``, as ``kernels/ops.py``."""
    absmax = torch.amax(g.to(torch.float32).abs() * fold, dim=dim,
                        keepdim=True)
    return _div(absmax.clamp_min(_EPS), 127.0)


def torch_inputs(m, n, k, dtype, zero_scales=True):
    g, w, x, fw, fx = bwd_inputs(m, n, k, seed=m * 7 + n + k)
    tg = torch.from_numpy(g).to(dtype)
    fw, fx = torch.from_numpy(fw), torch.from_numpy(fx)
    qn, qt = q_scales(tg, fw, 1), q_scales(tg, fx, 0)
    if zero_scales:
        qn[7::7] = 0.0
        qt[:, 7::7] = 0.0
    return tg, torch.from_numpy(w), torch.from_numpy(x), fw, fx, qn, qt


def staged_nt(g, w, fw, qn, out_dtype, n):
    gq = im.quant_rows_packed_plain(g, fw, qn)
    return im.int8_gemm_kmajor_plain(gq, im.kmajor_weight(w), qn, n, True,
                                     out_dtype)


def staged_tn(x, g, fx, qt, out_dtype, m, splits=1):
    xt = im.transpose_packed_plain(x)
    gt = im.quant_cols_packed_t_plain(g, fx, qt)
    if splits == 1:
        return im.int8_gemm_kmajor_plain(xt, gt, qt, m, False, out_dtype)
    return im.int8_split_reduce_plain(
        im.int8_gemm_partials_plain(xt, gt, m, splits), qt, False, out_dtype)


def valid_splits(kc):
    out = []
    for s in range(1, -(-kc // im.GEMM_STEP) + 1):
        try:
            im._split_bounds(kc, s)
        except ValueError:
            continue
        out.append(s)
    return out


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("out_dtype", DTYPES)
def test_staged_nt_equals_plain(m, n, k, dtype, out_dtype):
    g, w, _, fw, _, qn, _ = torch_inputs(m, n, k, dtype)
    got = staged_nt(g, w, fw, qn, out_dtype, n)
    assert got.dtype == out_dtype and tuple(got.shape) == (m, k)
    assert torch.equal(got, im.int8_matmul_nt_plain(g, w, fw, qn, out_dtype))


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("out_dtype", DTYPES)
def test_staged_tn_equals_plain(m, n, k, dtype, out_dtype):
    """Every split count the kernel can take gives the plain version's bits
    (the partials are exact integers)."""
    g, _, x, _, fx, _, qt = torch_inputs(m, n, k, dtype)
    want = im.int8_matmul_tn_plain(x, g, fx, qt, out_dtype)
    for s in valid_splits(m):
        got = staged_tn(x, g, fx, qt, out_dtype, m, s)
        assert got.dtype == out_dtype and tuple(got.shape) == (k, n)
        assert torch.equal(got, want), s


@pytest.mark.parametrize("m,n,k", SHAPES[:4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_matches_jax(m, n, k, dtype):
    """The plain stages against the JAX package's int8 backward with its
    Pallas kernels in interpret mode, as test_torch_train.py holds the
    plain versions: dx at the carrier, dW at float32 and at the carrier."""
    g, w, x, fw, fx = bwd_inputs(m, n, k, seed=m + n + k)
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    tg = torch.from_numpy(g).to(tdt)
    fw_t, fx_t = torch.from_numpy(fw), torch.from_numpy(fx)
    jdx = j_dx(jg, jnp.asarray(w), jnp.asarray(fw), interpret=True)
    tdx = staged_nt(tg, torch.from_numpy(w), fw_t, q_scales(tg, fw_t, 1),
                    tdt, n)
    np.testing.assert_array_equal(tdx.float().numpy(),
                                  np.asarray(jdx.astype(jnp.float32)))
    for out in ("float32", dtype):
        jdw = j_dw(jnp.asarray(x), jnp.asarray(fx), jg,
                   out_dtype=getattr(jnp, out), interpret=True)
        for s in valid_splits(m):
            tdw = staged_tn(torch.from_numpy(x), tg, fx_t,
                            q_scales(tg, fx_t, 0), getattr(torch, out), m, s)
            np.testing.assert_array_equal(
                tdw.float().numpy(), np.asarray(jdw.astype(jnp.float32)))


@pytest.mark.parametrize("m,n,k", [(33, 257, 90), (128, 128, 512), (1, 16, 5)])
def test_packed_layouts(m, n, k):
    """The payload buffers the GEMM reads: K-major, each row padded with
    zeros to a multiple of 16 bytes; the weight read as it is at N % 16 ==
    0 and as one zero-padded copy otherwise."""
    g, w, x, fw, fx, qn, qt = torch_inputs(m, n, k, torch.float32)
    pn, pm = -(-n // 16) * 16, -(-m // 16) * 16
    gq = im.quant_rows_packed_plain(g, fw, qn)
    gt = im.quant_cols_packed_t_plain(g, fx, qt)
    xt = im.transpose_packed_plain(x)
    assert gq.dtype == gt.dtype == xt.dtype == torch.int8
    assert (tuple(gq.shape), tuple(gt.shape), tuple(xt.shape)) == (
        (m, pn), (n, pm), (k, pm))
    assert not gq[:, n:].any() and not gt[:, m:].any() and not xt[:, m:].any()
    assert torch.equal(xt[:, :m], x.t())
    assert torch.equal(gq[:, :n], im._quant_grad(
        g, fw, im.scale_guard(qn).reshape(-1, 1)).to(torch.int8))
    assert torch.equal(gt[:, :m].t(), im._quant_grad(
        g, fx, im.scale_guard(qt).reshape(1, -1)).to(torch.int8))
    wk = im.kmajor_weight(w)
    if n % 16 == 0:
        assert wk is w
    else:
        assert tuple(wk.shape) == (k, pn) and wk.data_ptr() != w.data_ptr()
        assert torch.equal(wk[:, :n], w) and not wk[:, n:].any()


def test_split_bounds():
    """Splits cut the contraction into blocks of whole 128-byte steps, none
    empty; a count that would leave one empty is refused."""
    assert im._split_bounds(8192, 3) == [(0, 2816), (2816, 5632),
                                          (5632, 8192)]
    assert im._split_bounds(130, 2) == [(0, 128), (128, 130)]
    assert im._split_bounds(90, 1) == [(0, 90)]
    for kc, s in ((130, 3), (8192, 0), (640, 4)):
        with pytest.raises(ValueError):
            im._split_bounds(kc, s)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stage_wrappers_take_cpu_tensors(dtype):
    """On CPU tensors each stage wrapper runs its plain version, and the
    GEMM wrapper with a split count runs the split plain stages."""
    m, n, k = 130, 257, 90
    g, w, x, fw, fx, qn, qt = torch_inputs(m, n, k, dtype)
    assert torch.equal(im.quant_rows_packed(g, fw, qn),
                       im.quant_rows_packed_plain(g, fw, qn))
    xt, gt = im.pack_tn(x, g, fx, qt)
    assert torch.equal(gt, im.quant_cols_packed_t_plain(g, fx, qt))
    assert torch.equal(xt, im.transpose_packed_plain(x))
    ws = im.int8_gemm_partials(xt, gt, m, 2)
    assert ws.dtype == torch.int32 and tuple(ws.shape) == (2, k, n)
    assert torch.equal(im.int8_split_reduce(ws, qt, False, dtype),
                       im.int8_gemm_kmajor(xt, gt, qt, m, False, dtype))
    assert torch.equal(im.int8_gemm_kmajor(xt, gt, qt, m, False, dtype),
                       im.int8_matmul_tn_plain(x, g, fx, qt, dtype))
