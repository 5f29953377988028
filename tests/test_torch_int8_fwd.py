"""The staged int8 forward (``repro_torch.kernels.int8_matmul``) on the CPU.

On the card ``int8_matmul`` above ``FWD_GEMV_MAX_M`` rows runs in stages:
a transpose pass that writes the weight K-major once, wT (N, pad16(K)),
then the int8 GEMM of two K-major operands with both scales in its
epilogue, ((float)sum * g(rs)) * g(cs), split over the contraction where
its output tiles cannot fill the card (exact int32 partials and a
fixed-order reduction).  Each stage has a plain version; these tests hold
the plain stages' composition to ``int8_matmul_plain`` and to the JAX
package's ``int8_matmul`` (its Pallas kernel in interpret mode, through
``ops.int8_payload_linear``) and ``ref.int8_matmul_ref`` -- bit for bit:
every stage computes integers exactly and rounds the two products of the
epilogue in the reference's order.  The kernels themselves are held to the
same plain stages on the card (tests/test_torch_cuda.py).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import int8_payload_linear as j_payload_linear
from repro.kernels.ref import int8_matmul_ref as j_mm_ref

# the module (the package re-exports a function of the same name)
im = importlib.import_module("repro_torch.kernels.int8_matmul")

#: (M, K, N): ragged M (1, 17, 33, 130), contractions that are no multiple
#: of 16 bytes (40, 90, 200, 300; x is then read through a padded copy), N
#: off every tile (24, 257, 130), and a GPT-2 width (768, several splits)
SHAPES = [(1, 40, 24), (17, 90, 257), (64, 768, 96), (130, 200, 48),
          (33, 300, 130)]
DTYPES = [torch.float32, torch.bfloat16]


def mm_inputs(m, k, n, seed, zero_scales=True):
    """int8 payloads x (m, k), w (k, n) and scales rs (m, 1), cs (1, n);
    every 3rd row scale and 4th column scale 0 (the guard maps it to 1)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-128, 128, (k, n)).astype(np.int8)
    rs = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    cs = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    if zero_scales:
        rs[::3] = 0.0
        cs[:, ::4] = 0.0
    return x, w, rs, cs


def staged_fwd(x, w, rs, cs, out_dtype, splits=1):
    """The card's stages in plain torch: wT, then the GEMM of x and wT (or
    its split partials and their reduction)."""
    k = x.shape[1]
    wt = im.transpose_packed_plain(w)
    xk = im.kmajor_weight(x)
    if splits == 1:
        return im.int8_gemm_fwd_plain(xk, wt, rs, cs, k, out_dtype)
    return im.int8_split_reduce_fwd_plain(
        im.int8_gemm_partials_plain(xk, wt, k, splits), rs, cs, out_dtype)


def valid_splits(kc):
    out = []
    for s in range(1, -(-kc // im.GEMM_STEP) + 1):
        try:
            im._split_bounds(kc, s)
        except ValueError:
            continue
        out.append(s)
    return out


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("zero_scales", [False, True])
def test_staged_fwd_equals_plain(m, k, n, out_dtype, zero_scales):
    """Every split count the GEMM can take gives the plain version's bits."""
    x, w, rs, cs = (torch.from_numpy(a) for a in
                    mm_inputs(m, k, n, m + k + n, zero_scales))
    want = im.int8_matmul_plain(x, w, rs, cs, out_dtype)
    splits = valid_splits(k)
    assert splits[0] == 1 and (k <= im.GEMM_STEP or len(splits) > 1)
    for s in splits:
        got = staged_fwd(x, w, rs, cs, out_dtype, s)
        assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
        assert torch.equal(got, want), s


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_staged_fwd_matches_jax(m, k, n, out_dtype):
    """The plain stages against the Pallas kernel in interpret mode and the
    jnp oracle, zero scales included."""
    x, w, rs, cs = mm_inputs(m, k, n, seed=3 * m + k + n)
    jdt = getattr(jnp, out_dtype)
    j = j_payload_linear(jnp.asarray(x), jnp.asarray(rs), jnp.asarray(w),
                         jnp.asarray(cs), out_dtype=jdt, interpret=True)
    jr = j_mm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(rs),
                  jnp.asarray(cs), out_dtype=jdt)
    tx, tw, trs, tcs = (torch.from_numpy(a) for a in (x, w, rs, cs))
    for s in valid_splits(k):
        t = staged_fwd(tx, tw, trs, tcs, getattr(torch, out_dtype), s)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jr.astype(jnp.float32)))


def _order_sensitive_case():
    """One sum, a row scale and a column scale whose two roundings,
    (acc * rs) * cs, differ from one rounding of a folded rs * cs."""
    rng = np.random.RandomState(11)
    for _ in range(1000):
        acc = np.float32(rng.randint(1, 128))
        rs, cs = rng.uniform(1e-3, 0.1, 2).astype(np.float32)
        if (acc * rs) * cs != acc * (rs * cs):
            return int(acc), rs, cs
    raise AssertionError("no order-sensitive case found")


@pytest.mark.parametrize("splits", [1, 2])
def test_epilogue_order_is_row_then_column(splits):
    """(acc * g(rs)) * g(cs), two roundings in the reference's order: a case
    where folding rs * cs first gives other bits pins it, in the one-kernel
    epilogue and in the split reduction."""
    acc, rs, cs = _order_sensitive_case()
    k = 256                                  # two GEMM steps: two splits
    x = torch.zeros((1, k), dtype=torch.int8)
    w = torch.zeros((k, 1), dtype=torch.int8)
    x[0, 0], w[0, 0] = acc, 1
    trs, tcs = torch.tensor([[rs]]), torch.tensor([[cs]])
    got = staged_fwd(x, w, trs, tcs, torch.float32, splits)
    two = (np.float32(acc) * rs) * cs
    assert got.item() == two != np.float32(acc) * (rs * cs)
    assert torch.equal(got, im.int8_matmul_plain(x, w, trs, tcs,
                                                 torch.float32))
    jr = j_mm_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                  jnp.asarray([[rs]]), jnp.asarray([[cs]]),
                  out_dtype=jnp.float32)
    assert float(jr[0, 0]) == two


@pytest.mark.parametrize("m,route", [
    (1, "gemv"), (16, "gemv"),            # decode: 16 slots and fewer
    (17, "wgmma"), (64, "wgmma"),         # a bucket of one prompt
    (32 * 4, "wgmma"), (512 * 16, "wgmma"),  # prefill, B x bucket
    (8 * 1024, "wgmma")])                 # a training step's tokens
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
def test_fwd_route(m, route, k, n):
    """The route of each forward shape of the main path: the decode step's
    16 slots on the cluster route (a split-K weight stream, one 16-row
    tile), prefill and training on the tensor-core GEMM."""
    assert im.fwd_route(m, n, k) == route
    assert im.FWD_GEMV_MAX_M == 16


def test_transposed_weight_layout():
    """wT as the GEMM reads it: (N, pad16(K)), w^T then zeros."""
    _, w, _, _ = mm_inputs(3, 90, 257, seed=1)
    wt = im.transpose_packed_plain(torch.from_numpy(w))
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (257, 96)
    assert torch.equal(wt[:, :90], torch.from_numpy(w).t())
    assert not wt[:, 90:].any()


@pytest.mark.parametrize("out_dtype", DTYPES)
def test_forward_stage_wrappers_take_cpu_tensors(out_dtype):
    """On CPU tensors the forward's stage wrappers, both routes and the
    wrapper run their plain versions (the wrapper counts no launch)."""
    m, k, n = 130, 300, 48
    x, w, rs, cs = (torch.from_numpy(a) for a in mm_inputs(m, k, n, 5))
    want = im.int8_matmul_plain(x, w, rs, cs, out_dtype)
    wt = im.transpose_packed(w)
    assert torch.equal(wt, im.transpose_packed_plain(w))
    xk = im.kmajor_weight(x)
    assert torch.equal(im.int8_gemm_fwd(xk, wt, rs, cs, k, out_dtype), want)
    ws = im.int8_gemm_partials(xk, wt, k, 3)
    assert torch.equal(im.int8_split_reduce_fwd(ws, rs, cs, out_dtype), want)
    assert torch.equal(im.int8_matmul_dp4a(x, w, rs, cs, out_dtype), want)
    assert torch.equal(im.int8_matmul_gemv(x[:16], w, rs[:16], cs, out_dtype),
                       want[:16])
    assert torch.equal(im.int8_matmul_wgmma(x, w, rs, cs, out_dtype), want)
    before = im.int8_matmul.launches
    assert torch.equal(im.int8_matmul(x, w, rs, cs, out_dtype), want)
    assert im.int8_matmul.launches == before
