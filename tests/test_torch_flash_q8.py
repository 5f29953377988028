"""#11, the int8-KV flash prefill (``flash_attention_fwd_q8``), on the CPU.

On the card the bf16 carrier runs ``csrc/flash_q8_sm90.cu`` on the tensor
cores and the float32 carrier the CUDA-core kernel
(``kernels/flash_attn.py:q8_library``).  The tensor-core kernel keeps the
reference's fp32 arithmetic by feeding fp32 values as exact bf16 terms:
fl(q * scale) as one term at hd 64 and three elsewhere, and fl(p * g(vs))
as three terms on the accumulator fragment.  These tests hold what can be
held here:

* the three-term split of p * g(vs) sums back to it exactly (and within
  2**-134 below bf16's normal range), and each term is a bf16 value;
* the routing rule by dtype;
* the plain version against the JAX package's Pallas kernel in interpret
  mode, within 1e-5 at float32 (GQA, q_offset, hd 32 / 64 / 128, a cache
  tail that was never written);
* the kernel's order of operations, emulated in plain torch (two streams
  of 32-key half-tiles, each with its online softmax, merged at the end;
  the Q terms, the three p * g(vs) terms, the division last), against the
  plain version within 1e-5, and a control that rounds p * g(vs) to one
  bf16 term, which lands farther off.

The kernels themselves are held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention_fwd_q8 as j_flash

from repro_torch.core.qconfig import Granularity, QuantSpec
from repro_torch.core.quantizer import quantize_int
from repro_torch.kernels.int8_matmul import scale_guard

# the module (the package re-exports a function of the same name)
fa = importlib.import_module("repro_torch.kernels.flash_attn")

SPEC = QuantSpec(8, Granularity.PER_TOKEN)
TILE = 64          # key rows per tile of the tensor-core kernel
HALF = 32          # key rows of a tile per warpgroup (one stream)


def q8_inputs(b, sq, skv, h, kh, hd, written, seed):
    """q (bf16 values, as float32), an int8 cache (b, skv, kh, hd) whose
    rows >= ``written`` are never written (payload 0, scale 0), as numpy."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, sq, h, hd).astype(np.float32))
    q = q.bfloat16().float().numpy()
    valid = np.arange(skv)[None, :, None, None] < written
    out = [q]
    for _ in range(2):
        x = torch.from_numpy(rng.randn(b, skv, kh, hd).astype(np.float32))
        p, s, _ = quantize_int(x, SPEC)
        out += [np.where(valid, p.numpy(), 0).astype(np.int8),
                np.where(valid, s.numpy(), 0.0).astype(np.float32)]
    return out                       # q, kq, ks, vq, vs


def kernel_order(q, kq, ks, vq, vs, q_offset, pv_terms=3):
    """The tensor-core kernel's arithmetic in plain torch, to fp32 before
    the cast: two streams of 32-key half-tiles (keys 64t..64t+31 and
    64t+32..64t+63 of every 64-key tile t), each with its own online
    softmax -- s = (x . k) * g(ks) with x = fl(q * scale) given as its bf16
    terms (bf16_q_terms) and each product exact (summed in float64,
    rounded once), -1e30 past the causal limit, acc = acc * alpha + (sum of
    the terms of fl(p * g(vs))) . v -- merged at the end (m = max(m0, m1),
    each side scaled by exp(m_w - m)), and acc / max(l, 1e-30) last.
    ``pv_terms=1`` rounds p * g(vs) to one bf16 term (the control)."""
    b, sq, h, hd = q.shape
    skv, kh = kq.shape[1], kq.shape[2]
    g = h // kh
    x = sum(t.double() for t in fa.bf16_q_terms(q, hd))
    qpos = torch.arange(sq)[:, None] + q_offset
    out = torch.zeros((b, sq, h, hd), dtype=torch.float32)
    for bi in range(b):
        for hi in range(h):
            kv = hi // g
            streams = []
            for w in range(2):
                m = torch.full((sq, 1), -1e30)
                l = torch.zeros((sq, 1))
                acc = torch.zeros((sq, hd))
                for k0 in range(w * HALF, skv, TILE):
                    sl = slice(k0, min(k0 + HALF, skv))
                    s = (x[bi, :, hi] @ kq[bi, sl, kv].double().t()).float()
                    s = s * scale_guard(ks[bi, sl, kv, 0])[None, :]
                    kpos = torch.arange(sl.start, sl.stop)[None, :]
                    s = s.masked_fill(kpos > qpos, -1e30)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.exp(s - m_new)
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum(-1, keepdim=True)
                    m = m_new
                    pv = p * scale_guard(vs[bi, sl, kv, 0])[None, :]
                    terms = (fa.bf16_terms(pv) if pv_terms == 3
                             else (pv.bfloat16().float(),))
                    acc = acc * alpha + (sum(t.double() for t in terms)
                                         @ vq[bi, sl, kv].double()).float()
                streams.append((m, l, acc))
            (m0, l0, a0), (m1, l1, a1) = streams
            mm = torch.maximum(m0, m1)
            e0, e1 = torch.exp(m0 - mm), torch.exp(m1 - mm)
            out[bi, :, hi] = ((e0 * a0 + e1 * a1)
                              / (e0 * l0 + e1 * l1).clamp_min(1e-30))
    return out


@pytest.mark.parametrize("regime", ["normal", "tiny"])
def test_pv_terms_sum_back_exactly(regime):
    """fl(p * g(vs)) == hi + mid + lo for probabilities in (0, 1] and the
    cache's scales (guarded 0 -> 1); each term is a bf16 value, so each
    product with an int8 payload is exact in fp32.  Below 2**-110 the sum
    is within bf16's half subnormal step, 2**-134."""
    rng = np.random.RandomState(1 if regime == "normal" else 2)
    n = 20000
    if regime == "normal":
        p = rng.uniform(0.0, 1.0, n)
        p[:4] = [1.0, 0.5, 2.0 ** -20, 1e-30]
    else:
        p = 10.0 ** rng.uniform(-44, -30, n)
    vs = rng.uniform(1e-3, 0.1, n)
    vs[::5] = 0.0
    x = (torch.from_numpy(p).float()
         * scale_guard(torch.from_numpy(vs).float()))
    terms = fa.bf16_terms(x)
    for t in terms:
        assert torch.equal(t, t.bfloat16().float())
    total = sum(t.double() for t in terms)
    err = (total - x.double()).abs()
    exact = x.abs() >= 2.0 ** -110
    assert bool((err[exact] == 0).all())
    assert bool((err <= 2.0 ** -134).all())
    assert (regime == "tiny") == bool((~exact).any())
    # the control: one bf16 term does not hold p * g(vs)
    if regime == "normal":
        assert not torch.equal(terms[0], x)


def test_q8_library_routes_by_dtype():
    """bfloat16 to the tensor cores, float32 to the CUDA-core kernel
    (TF32 would drop 13 bits)."""
    assert fa.q8_library(torch.bfloat16) == "flash_q8_sm90"
    assert fa.q8_library(torch.float32) == "flash_attn_q8"


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("h,kh,q_offset", [(6, 2, 0), (4, 4, 7), (2, 1, 7)])
def test_plain_matches_pallas(hd, h, kh, q_offset):
    """The plain version against the Pallas kernel in interpret mode: GQA
    and MQA through h // (H / K), an offset, the head dims the kernels take,
    and cache rows past q_offset + Sq never written (hidden by the causal
    mask)."""
    b, sq, skv = 1, 16, 40
    q, kq, ks, vq, vs = q8_inputs(b, sq, skv, h, kh, hd, q_offset + sq,
                                  seed=hd + h + q_offset)
    j = j_flash(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs)), causal=True,
                q_offset=q_offset, block_q=8, block_k=8, interpret=True)
    t = fa.flash_attention_fwd_q8_plain(
        *(torch.from_numpy(a) for a in (q, kq, ks, vq, vs)), causal=True,
        q_offset=q_offset)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("hd,h,kh,q_offset", [(32, 4, 4, 7), (64, 6, 2, 0),
                                              (128, 2, 1, 7), (256, 4, 1, 7)])
def test_kernel_order_matches_plain(hd, h, kh, q_offset):
    """The tensor-core kernel's order of operations over three key tiles
    (one ragged, a tail never written; both streams) equals the plain
    version within 1e-5 at fp32; rounding p * g(vs) to one bf16 term
    instead lands at least 10x farther off."""
    b, sq, skv = 2, 70, 150
    arrays = q8_inputs(b, sq, skv, h, kh, hd, q_offset + sq, seed=hd + h)
    q, kq, ks, vq, vs = (torch.from_numpy(a) for a in arrays)
    want = fa.flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=True,
                                           q_offset=q_offset)
    got = kernel_order(q, kq, ks, vq, vs, q_offset)
    err = (got - want).abs().max().item()
    assert err <= 1e-5
    ctl = (kernel_order(q, kq, ks, vq, vs, q_offset, pv_terms=1)
           - want).abs().max().item()
    assert ctl >= 10 * max(err, 1e-7), (err, ctl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_runs_the_plain_version(dtype):
    """CPU tensors take the plain version and count no launch; the card's
    launcher refuses them."""
    arrays = q8_inputs(1, 10, 24, 4, 2, 32, 10, seed=3)
    q, kq, ks, vq, vs = (torch.from_numpy(a) for a in arrays)
    q = q.to(dtype)
    before = fa.flash_attention_fwd_q8.launches
    got = fa.flash_attention_fwd_q8(q, kq, ks, vq, vs)
    assert fa.flash_attention_fwd_q8.launches == before
    assert torch.equal(got, fa.flash_attention_fwd_q8_plain(q, kq, ks, vq,
                                                            vs))
    assert got.dtype == dtype
    with pytest.raises(ValueError, match="unsupported device"):
        fa.launch_q8(fa.q8_library(dtype), q, kq, ks, vq, vs)
