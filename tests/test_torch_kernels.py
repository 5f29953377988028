"""Port parity of the three serving kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the JAX Pallas kernel in interpret mode on the same numpy inputs:

* ``int8_matmul``: bit for bit (exact integer sums, the same epilogue
  order), ragged shapes and zero scales included;
* ``decode_attention``: context within 1e-5 (fp32 sums in another order),
  the written cache rows bit for bit; the CUDA kernel's split-KV recurrence
  (chunks combined in a fixed order) within 1e-6 of both;
* ``flash_attention_fwd_q8``: within 1e-5.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.qconfig import Granularity as JGran, QuantSpec as JSpec
from repro.core.quantizer import quantize_int as jquant
from repro.kernels.decode_attn import decode_attention as j_decode
from repro.kernels.flash_attn import flash_attention_fwd_q8 as j_flash
from repro.kernels.ops import int8_payload_linear as j_payload_linear
from repro.kernels.ref import int8_matmul_ref as j_mm_ref

from repro_torch.kernels import (decode_attention, flash_attention_fwd_q8,
                                 int8_matmul)
from repro_torch.kernels.decode_attn import (DECODE_CHUNK,
                                             decode_attention_plain)

SPEC = JSpec(8, JGran.PER_TOKEN)


def _mm_inputs(m, k, n, seed, zero_scales=False):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-128, 128, (k, n)).astype(np.int8)
    rs = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    cs = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    if zero_scales:
        rs[::3] = 0.0
        cs[:, ::4] = 0.0
    return x, w, rs, cs


@pytest.mark.parametrize("m,k,n", [(16, 128, 128), (5, 40, 24),
                                   (130, 96, 200), (3, 3072, 8)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_scales", [False, True])
def test_int8_matmul_bit_exact(m, k, n, out_dtype, zero_scales):
    """The plain version (what the wrapper runs on CPU tensors) equals the
    Pallas kernel through its padding wrapper and the jnp oracle."""
    x, w, rs, cs = _mm_inputs(m, k, n, seed=m + k + n,
                              zero_scales=zero_scales)
    jdt = getattr(jnp, out_dtype)
    j = j_payload_linear(jnp.asarray(x), jnp.asarray(rs), jnp.asarray(w),
                         jnp.asarray(cs), out_dtype=jdt, interpret=True)
    jr = j_mm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(rs),
                  jnp.asarray(cs), out_dtype=jdt)
    t = int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(rs), torch.from_numpy(cs),
                    out_dtype=getattr(torch, out_dtype))
    got = t.to(torch.float32).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.astype(jnp.float32)))
    np.testing.assert_array_equal(got, np.asarray(jr.astype(jnp.float32)))
    assert np.isfinite(got).all()


def test_int8_matmul_rejects_bad_shapes():
    x, w, rs, cs = _mm_inputs(4, 8, 6, seed=0)
    with pytest.raises(ValueError):
        int8_matmul(torch.from_numpy(x), torch.from_numpy(w[:7]),
                    torch.from_numpy(rs), torch.from_numpy(cs))
    with pytest.raises(ValueError):
        int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(rs[:3]), torch.from_numpy(cs))


def _decode_inputs(b, s, kh, g, hd, lengths, seed):
    """Ragged int8 cache: rows < lengths[i] hold quantized random K/V, the
    rest the never-written state (payload 0, scale 0)."""
    rng = np.random.RandomState(seed)
    kf = rng.randn(b, s, kh, hd).astype(np.float32)
    vf = rng.randn(b, s, kh, hd).astype(np.float32)
    kq, ks, _ = (np.asarray(a) for a in jquant(jnp.asarray(kf), SPEC))
    vq, vs, _ = (np.asarray(a) for a in jquant(jnp.asarray(vf), SPEC))
    valid = (np.arange(s)[None, :, None, None]
             < np.asarray(lengths)[:, None, None, None])
    kq, vq = np.where(valid, kq, 0).astype(np.int8), \
        np.where(valid, vq, 0).astype(np.int8)
    ks, vs = np.where(valid, ks, 0.0).astype(np.float32), \
        np.where(valid, vs, 0.0).astype(np.float32)
    q = rng.randn(b, kh, g, hd).astype(np.float32)
    nk = rng.randn(b, kh, hd).astype(np.float32)
    nv = rng.randn(b, kh, hd).astype(np.float32)
    pos = np.asarray(lengths, np.int32)
    return q, kq, ks, vq, vs, nk, nv, pos


@pytest.mark.parametrize("hd", [16, 256])                     # 256: gemma
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2), (3, 1)])   # MHA/GQA/MQA
@pytest.mark.parametrize("lengths", [[1, 5, 11], [0, 12, 7]])  # 12 == S
def test_decode_attention_matches_pallas(h, kh, lengths, hd):
    """Context within 1e-5 of the Pallas kernel; the in-place write lands
    the same payload and scale bits at row min(pos, S - 1) and touches no
    other row (pos 0: only the new row is attended; pos == S: the freed
    slot's write clamps to the last row)."""
    q, kq, ks, vq, vs, nk, nv, pos = _decode_inputs(3, 12, kh, h // kh, hd,
                                                    lengths, seed=h + kh)
    jout = j_decode(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs, nk, nv, pos)),
                    block_k=4, interpret=True)
    tcache = [torch.from_numpy(a.copy()) for a in (kq, ks, vq, vs)]
    ctx = decode_attention(torch.from_numpy(q), *tcache, torch.from_numpy(nk),
                           torch.from_numpy(nv), torch.from_numpy(pos))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jout[0]), atol=1e-5)
    # the written rows: payloads equal the Pallas kernel's; scales equal the
    # JAX codec's (quantize_int of the new rows) -- interpret-mode XLA may
    # give the kernel's own `absmax / qmax` 1 ulp off
    rows = np.arange(3), np.minimum(pos, 11)
    for i, (cache, new) in enumerate(((ks, nk), (vs, nv))):
        want = cache.copy()
        want[rows] = np.asarray(jquant(jnp.asarray(new), SPEC)[1])
        np.testing.assert_array_equal(tcache[1 + 2 * i].numpy(), want)
        np.testing.assert_allclose(tcache[1 + 2 * i].numpy(),
                                   np.asarray(jout[2 + 2 * i]), rtol=1e-6)
    for i in (0, 2):
        np.testing.assert_array_equal(tcache[i].numpy(), np.asarray(jout[1 + i]))
    assert np.isfinite(ctx.numpy()).all()


def _chunked_decode(q, kq, ks, vq, vs, nk, nv, pos, chunk, qmin=-128,
                    qmax=127):
    """The CUDA kernel's recurrence (``csrc/decode_attn.cu``) in float32:
    each chunk of ``chunk`` logical rows below pos[b] gives its own max m,
    sum l and p * g(vs) . V; the chunks combine in chunk order 0..n-1
    (M = max m_c, L = sum exp(m_c - M) l_c, A likewise); then the freshly
    quantized new row folds in and A / L is the context."""
    b, kh, g, hd = q.shape
    s = kq.shape[1]
    qf = q.float() * (1.0 / np.sqrt(hd))
    guard = lambda t: torch.where(t == 0, torch.ones_like(t), t)   # noqa: E731

    def quant(x):
        x = x.float()
        sc = x.abs().amax(-1, keepdim=True).clamp_min(1e-12) / qmax
        return torch.clamp(torch.round(x / sc), qmin, qmax), sc

    (nkq, nks), (nvq, nvs) = quant(nk), quant(nv)
    out = torch.empty(b, kh, g, hd)
    for i in range(b):
        n_valid = min(max(int(pos[i]), 0), s)
        for h in range(kh):
            parts = []
            for t0 in range(0, n_valid, chunk):
                rows = slice(t0, min(t0 + chunk, n_valid))
                sc = (qf[i, h] @ kq[i, rows, h].float().T) * guard(
                    ks[i, rows, h, 0])
                m = sc.amax(-1, keepdim=True)
                p = torch.exp(sc - m)
                acc = (p * guard(vs[i, rows, h, 0])) @ vq[i, rows, h].float()
                parts.append((m, p.sum(-1, keepdim=True), acc))
            big_m = torch.full((g, 1), -1e30)
            for m, _, _ in parts:
                big_m = torch.maximum(big_m, m)
            big_l, big_a = torch.zeros(g, 1), torch.zeros(g, hd)
            for m, l, acc in parts:
                f = torch.exp(m - big_m)
                big_l = big_l + f * l
                big_a = big_a + f * acc
            s_new = (qf[i, h] @ (nkq[i, h] * nks[i, h]))[:, None]
            m_new = torch.maximum(big_m, s_new)
            alpha, p_new = torch.exp(big_m - m_new), torch.exp(s_new - m_new)
            big_l = alpha * big_l + p_new
            big_a = big_a * alpha + p_new * (nvq[i, h] * nvs[i, h])
            out[i, h] = big_a / big_l.clamp_min(1e-30)
    return out


@pytest.mark.parametrize("chunk", [4, 8, DECODE_CHUNK])
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2), (3, 1)])    # MHA/GQA/MQA
@pytest.mark.parametrize("lengths", [[0, 12, 7], [4, 8, 9]])  # chunk edges
def test_decode_chunked_combine_matches_pallas(chunk, h, kh, lengths):
    """The split-KV recurrence and fixed-order combine of the CUDA kernel,
    at chunks of 4 and 8 rows (and the kernel's own, one chunk here) on
    12-row caches, within 1e-6 of the Pallas kernel (kv tiles of 4, one
    online softmax) and of the plain version (one softmax over every row):
    the three take float32 sums and exponentials in other orders, a few ulp
    of a context of order 1 apart."""
    q, kq, ks, vq, vs, nk, nv, pos = _decode_inputs(3, 12, kh, h // kh, 16,
                                                    lengths, seed=h * kh)
    t = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, nk, nv, pos)]
    got = _chunked_decode(*t, chunk=chunk)
    jout = j_decode(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs, nk, nv, pos)),
                    block_k=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout[0]), atol=1e-6)
    plain = decode_attention_plain(t[0], *(a.clone() for a in t[1:5]), *t[5:])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)


def test_decode_attention_scale_zero_rows_inert():
    """Garbage payloads under scale-0 (never-written) rows past pos change
    nothing: the validity mask and the scale guard keep them out."""
    q, kq, ks, vq, vs, nk, nv, pos = _decode_inputs(2, 8, 2, 2, 16, [2, 5], 4)
    args = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, nk, nv, pos)]
    clean = decode_attention_plain(args[0], *(a.clone() for a in args[1:5]),
                                   *args[5:])
    tail = np.arange(8)[None, :, None, None] >= pos[:, None, None, None]
    dirty = [torch.from_numpy(np.where(tail, 127, kq).astype(np.int8)),
             args[2].clone(),
             torch.from_numpy(np.where(tail, -128, vq).astype(np.int8)),
             args[4].clone()]
    out = decode_attention_plain(args[0], *dirty, *args[5:])
    np.testing.assert_array_equal(out.numpy(), clean.numpy())


@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (2, 1)])
@pytest.mark.parametrize("q_offset", [0, 3])
def test_flash_q8_matches_pallas(h, kh, q_offset):
    """GQA via h // (H / K); the never-written cache tail (rows >= q_offset
    + Sq) is hidden by the causal mask."""
    b, sq, smax, hd = 2, 6, 12, 16
    q, kq, ks, vq, vs, *_ = _decode_inputs(b, smax, kh, 1, hd,
                                           [q_offset + sq] * b, seed=7 + h)
    q = np.random.RandomState(kh).randn(b, sq, h, hd).astype(np.float32)
    j = j_flash(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs)), causal=True,
                q_offset=q_offset, block_q=4, block_k=4, interpret=True)
    t = flash_attention_fwd_q8(*(torch.from_numpy(a) for a in
                                 (q, kq, ks, vq, vs)),
                               causal=True, q_offset=q_offset)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_flash_q8_noncausal_needs_full_cache():
    q, kq, ks, vq, vs, *_ = _decode_inputs(1, 8, 2, 1, 16, [6], seed=0)
    q = np.zeros((1, 6, 2, 16), np.float32)
    with pytest.raises(ValueError, match="fully written cache"):
        flash_attention_fwd_q8(*(torch.from_numpy(a) for a in
                                 (q, kq, ks, vq, vs)), causal=False)
