"""The decode linear's fused entry (``repro_torch.kernels.int8_matmul``) on
the CPU.

On the card a prepared linear at the decode step's few rows is one kernel,
``int8_quant_matmul``: a cluster of blocks per 32 output columns, each
block streaming one contraction split of the weight, quantizing its slice
of the fp activations per token (each block's partial row absmax, their max
across the cluster, scale = max(absmax, 1e-12) / qmax, payload
clamp(rint(x / scale))), multiplying it exactly in int32 and summing the
splits' partials in rank order before the epilogue ((float)acc * scale) *
g(cs).  The kernel has no CPU mode; its plain version is ``quantize_int``
followed by ``int8_matmul_plain``.  These tests hold that plain version bit
for bit to the unfused chain and to the JAX package's
``ops.int8_prepared_linear`` (its Pallas kernel in interpret mode, run under
``jax.disable_jit()``: XLA's CPU backend fuses ``round(x / s)`` under
``jit`` and flips payloads), and hold a model of the kernel's algorithm --
per-split absmax partials, their max, per-split int32 partials summed in
rank order -- bit for bit to it at every cluster size, on contractions the
splits cut raggedly.  The kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qconfig import Granularity as JGranularity
from repro.core.qconfig import QuantSpec as JQuantSpec
from repro.kernels.ops import int8_prepared_linear as j_prepared_linear
from repro_torch.core.qconfig import Granularity, QuantSpec, RoundMode
from repro_torch.core.quantizer import quantize_int

# the modules (the package re-exports functions of the same names)
im = importlib.import_module("repro_torch.kernels.int8_matmul")
ops = importlib.import_module("repro_torch.kernels.ops")

SPEC = QuantSpec(8, Granularity.PER_TOKEN)
MS, KS, NS = [1, 2, 7, 16], [40, 90, 768], [48, 257, 768]
DTYPES = ["float32", "bfloat16"]


def decode_inputs(m, k, n, dtype, seed):
    """fp activations x (m, k) in ``dtype`` with rows of unlike magnitudes
    and, from two rows on, an all-zero row; an int8 weight wq (k, n) and its
    per-channel scale (1, n)."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((m, k))
         * rng.uniform(0.05, 4.0, (m, 1))).astype(np.float32)
    if m > 1:
        x[m // 2] = 0.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    wq = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
    ws = torch.from_numpy(rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32))
    return tx, wq, ws


def chain(x, wq, ws, spec, out_dtype):
    """The unfused decode linear: quantize_int, then the int8 matmul."""
    xq, scale, _ = quantize_int(x, spec)
    return im.int8_matmul_plain(xq, wq, scale, ws, out_dtype)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_matmul_plain_equals_chain(m, k, n, dtype):
    """The fused entry's plain version is quantize_int + int8_matmul_plain,
    bit for bit, all-zero row included (its payload is 0, its output 0)."""
    x, wq, ws = decode_inputs(m, k, n, dtype, seed=m + k + n)
    got = im.int8_quant_matmul_plain(x, wq, ws, SPEC, x.dtype)
    assert got.dtype == x.dtype and tuple(got.shape) == (m, n)
    assert torch.equal(got, chain(x, wq, ws, SPEC, x.dtype))
    if m > 1:
        assert not got[m // 2].any()


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_matmul_plain_matches_jax(m, k, n, dtype):
    """The plain version against the JAX package's int8_prepared_linear (its
    Pallas int8 matmul in interpret mode), eagerly."""
    x, wq, ws = decode_inputs(m, k, n, dtype, seed=3 * m + k + n)
    jx = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    with jax.disable_jit():
        j = j_prepared_linear(jx, jnp.asarray(wq.numpy()),
                              jnp.asarray(ws.numpy()),
                              JQuantSpec(8, JGranularity.PER_TOKEN),
                              interpret=True)
    got = im.int8_quant_matmul_plain(x, wq, ws, SPEC, x.dtype)
    assert str(j.dtype) == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


def gemv_bounds(k, splits):
    """The contraction range [lo, hi) of each block of a cluster of
    ``splits``, as ``csrc/int8_matmul.cu:launch_gemv`` and the kernel cut it:
    whole 32-row steps, the last ranges short or empty."""
    ks = -(-(-(-k // splits)) // im.GEMV_STEP) * im.GEMV_STEP
    return [(min(s * ks, k), min(s * ks + ks, k)) for s in range(splits)]


def cluster_model(x, wq, row_scale, ws, spec, splits, out_dtype):
    """The cluster kernel's algorithm in plain torch: each block's contraction
    range (``gemv_bounds``); with ``row_scale`` None (the fused entry) each
    block's partial row absmax, their max, the row scale and the block's
    slice quantized by it, else x is the int8 payload with ``row_scale``;
    each block's int32 partial, summed in rank order; the epilogue."""
    bounds = gemv_bounds(x.shape[1], splits)
    xf = x.to(torch.float32)
    if row_scale is None:
        part_max = [xf[:, lo:hi].abs().amax(dim=1) if hi > lo
                    else torch.zeros(x.shape[0]) for lo, hi in bounds]
        absmax = torch.stack(part_max).amax(dim=0).reshape(-1, 1)
        row_scale = (absmax.clamp_min(1e-12)
                     / torch.full_like(absmax, float(spec.qmax)))
    acc = torch.zeros((x.shape[0], wq.shape[1]), dtype=torch.int32)
    for lo, hi in bounds:
        q = xf[:, lo:hi]
        if x.dtype != torch.int8:
            # the int8 payload in shared memory, as quantize_int stores it
            q = torch.clamp(torch.round(q / row_scale), spec.qmin,
                            spec.qmax).to(torch.int8)
        acc = acc + torch.matmul(q.to(torch.int32), wq[lo:hi].to(torch.int32))
    return ((acc.to(torch.float32) * im.scale_guard(row_scale).reshape(-1, 1))
            * im.scale_guard(ws).reshape(1, -1)).to(out_dtype)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [90, 301, 1001])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_model_equals_plain(splits, k, bits, dtype):
    """Split absmax partials and split int32 partials give the plain
    version's bits at every cluster size, on contractions whose last split
    is short (and, at 8 splits of 90, empty)."""
    bounds = gemv_bounds(k, splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert splits == 1 or bounds[-1][1] - bounds[-1][0] < bounds[0][1]
    spec = QuantSpec(bits, Granularity.PER_TOKEN)
    x, wq, ws = decode_inputs(16, k, 257, dtype, seed=k + splits + bits)
    want = im.int8_quant_matmul_plain(x, wq, ws, spec, x.dtype)
    assert torch.equal(cluster_model(x, wq, None, ws, spec, splits, x.dtype),
                       want)
    # the int8 entry: the payload and scale given
    xq, scale, _ = quantize_int(x, spec)
    assert torch.equal(cluster_model(xq, wq, scale, ws, spec, splits,
                                     x.dtype), want)


def same_or_both_nan(a, b):
    """Equal values, NaN where and only where the other has NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_model_carries_nonfinite_rows(splits, dtype):
    """A NaN or an infinity in a row reaches that row's outputs through the
    split absmax partials as through quantize_int (torch.amax and
    torch.clamp keep NaN): a NaN row is all NaN, an infinite row non-finite,
    the other rows unchanged, and the model equals the plain version."""
    k = 301
    x, wq, ws = decode_inputs(16, k, 257, dtype, seed=splits)
    clean = im.int8_quant_matmul_plain(x, wq, ws, SPEC, x.dtype)
    last = max(lo for lo, hi in gemv_bounds(k, splits) if hi > lo)
    x[3, last] = float("nan")            # in the last split with rows
    x[5, 0] = float("inf")               # in the first
    x[9, k // 2] = float("-inf")
    want = im.int8_quant_matmul_plain(x, wq, ws, SPEC, x.dtype)
    got = cluster_model(x, wq, None, ws, SPEC, splits, x.dtype)
    assert same_or_both_nan(got, want)
    assert want[3].isnan().all()
    assert not want[[5, 9]].isfinite().any()
    finite = [r for r in range(16) if r not in (3, 5, 9)]
    assert torch.equal(want[finite], clean[finite])


def test_gemv_splits_fill_the_card_at_gpt2_widths():
    """The cluster size: 8 blocks at GPT-2's contractions (24 or 96
    clusters of 8 at N = 768 or 3072), fewer only where the contraction has
    fewer 32-row steps."""
    for k in (768, 3072):
        assert im.gemv_splits(k) == 8
    assert im.gemv_splits(40) == 2 and im.gemv_splits(32) == 1


@pytest.mark.parametrize("spec,ok", [
    (SPEC, True), (QuantSpec(4, Granularity.PER_TOKEN), True),
    (QuantSpec(8, Granularity.PER_TENSOR), False),
    (QuantSpec(8, Granularity.PER_CHANNEL), False),
    (QuantSpec(8, Granularity.PER_TOKEN, symmetric=False), False),
    (QuantSpec(8, Granularity.PER_TOKEN, block_size=128), False),
    (QuantSpec(8, Granularity.PER_TOKEN, round_mode=RoundMode.STOCHASTIC),
     False),
    (QuantSpec(16, Granularity.PER_TOKEN), False)])
def test_quant_fwd_eligible(spec, ok):
    """The fused entry takes only what its prologue computes exactly, and
    raises on anything else."""
    assert im.quant_fwd_eligible(spec) is ok
    x, wq, ws = decode_inputs(4, 40, 48, "float32", seed=0)
    assert not im.takes_quant_fwd(x, spec, torch.float32)   # CPU tensors
    if not ok:
        with pytest.raises(ValueError):
            im.int8_quant_matmul(x, wq, ws, spec, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w_scale_cols", [257, 1])
def test_prepared_linear_same_bits_with_or_without_fused_entry(
        monkeypatch, dtype, w_scale_cols):
    """ops.int8_prepared_linear gives the same bits whether it takes the
    fused entry (forced here: on the CPU it never does) or quantizes and
    multiplies in two steps, for a per-channel and a per-tensor weight
    scale; the fused entry is reached through the ops module's name, so
    chip_smoke.plain_versions can swap it."""
    x, wq, ws = decode_inputs(16, 90, 257, dtype, seed=5)
    ws = ws[:, :w_scale_cols]
    x3 = x.reshape(16, 1, 90)
    before = im.int8_matmul.launches
    unfused = ops.int8_prepared_linear(x3, wq, ws, SPEC)
    taken = []
    monkeypatch.setattr(ops, "takes_quant_fwd", lambda *a: True)
    monkeypatch.setattr(ops, "int8_quant_matmul", lambda *a, **kw: (
        taken.append(a) or im.int8_quant_matmul(*a, **kw)))
    fused = ops.int8_prepared_linear(x3, wq, ws, SPEC)
    assert len(taken) == 1 and tuple(fused.shape) == (16, 1, 257)
    assert fused.dtype == unfused.dtype == x.dtype
    assert torch.equal(fused, unfused)
    assert im.int8_matmul.launches == before     # CPU tensors count nothing
