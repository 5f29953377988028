"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible (the kernels have no CPU mode); on a machine with a card, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: the three int8 matmuls (forward, nt, tn) bit for bit; the
attention kernels within 1e-5 of the plain version at the float32 carrier
(fp32 sums in another order), within one bfloat16 rounding step at the
bfloat16 carrier (two fp32 values a few ulp apart can round to
neighbouring bf16 values), and the decode step's written cache rows bit
for bit; the paged decode step equal to the dense one bit for bit on the
same logical cache (context and written rows), its written pools equal
to its plain version's outside the trash page 0; the fused AdamW step bit for bit in params, payloads, scales and
zero points (both versions round every op on its own), its update-norm sum
within 1e-5 relative (partial sums in another order); the fused fake
quantization kernels ``qdq_row`` / ``qdq_scaled`` bit for bit, exact x.5
ties, all-zero rows and NaN rows included; the fp flash kernels #7-#10
against their plain versions on the same inputs (the plain backward reads
the kernels' lse and delta): outputs within 2e-5 at float32 and 2e-2 at
bfloat16, LSE rows within 2e-5, gradients within 1e-4 relative L2 at
float32, and at bfloat16 o and the gradients within
``chip_smoke.FLASH_BF16`` (relative L2, and the share of elements more
than one bf16 step apart), #7 equal to #8's output, every launch
repeating its bits, a NaN in q reaching o, the LSE and every gradient it
touches.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.qconfig import Granularity, QuantSpec
from repro_torch.core.quantizer import quantize_int
from repro_torch.kernels import (decode_attention, decode_attention_paged,
                                 flash_attention_fwd_q8, fused_adamw_blocks,
                                 int8_matmul, int8_matmul_nt, int8_matmul_tn,
                                 qdq_row, qdq_scaled)
from repro_torch.kernels.decode_attn import (decode_attention_paged_plain,
                                             decode_attention_plain)
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
from repro_torch.kernels.int8_matmul import (int8_matmul_nt_plain,
                                             int8_matmul_plain,
                                             int8_matmul_tn_plain)
from repro_torch.kernels.opt_update import (codec_of,
                                            fused_adamw_blocks_plain)
from repro_torch.kernels.qdq import qdq_row_plain, qdq_scaled_plain
from repro_torch.core.qconfig import parse_recipe

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (limits and helpers; imports no torch)

SPEC = QuantSpec(8, Granularity.PER_TOKEN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_attention_close(got, want):
    """1e-5 at float32; at bfloat16 one rounding step apart, or 1e-5 where
    cancellation leaves a value so small that the fp32 noise is more than
    one bf16 step of it."""
    g, w = got.float(), want.float()
    tol = torch.full_like(w, 1e-5)
    if got.dtype == torch.bfloat16:
        tol = torch.maximum(tol, torch.maximum(g.abs(), w.abs()) * 2.0 ** -7)
    assert bool(((g - w).abs() <= tol).all()), (g - w).abs().max().item()


def _cache(dev, b, s, kh, hd, lengths, seed):
    gen = torch.Generator().manual_seed(seed)
    valid = (torch.arange(s)[None, :, None, None]
             < torch.as_tensor(lengths)[:, None, None, None])
    out = []
    for _ in range(2):
        q, sc, _ = quantize_int(torch.randn((b, s, kh, hd), generator=gen),
                                SPEC)
        out += [torch.where(valid, q, 0).to(dev),
                torch.where(valid, sc, 0.0).to(dev)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 768, 3072), (70, 3072, 768),
                                   (5, 40, 24)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel(cuda, m, k, n, out_dtype):
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
    rs = torch.from_numpy(rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32))
    cs = torch.from_numpy(rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32))
    rs[::3] = 0.0                   # zero scales: the guard maps them to 1
    x, w, rs, cs = (t.to(cuda) for t in (x, w, rs, cs))
    before = int8_matmul.launches
    got = int8_matmul(x, w, rs, cs, out_dtype=out_dtype)
    assert int8_matmul.launches == before + 1
    assert torch.equal(got, int8_matmul_plain(x, w, rs, cs,
                                              out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,g,hd", [(2, 3, 64), (4, 1, 32), (1, 8, 128)])
def test_decode_attention_kernel(cuda, dtype, kh, g, hd):
    b, s = 4, 300
    pos = torch.tensor([0, 1, 299, 300], dtype=torch.int32, device=cuda)
    cache = _cache(cuda, b, s, kh, hd, pos.cpu(), seed=kh * g)
    gen = torch.Generator().manual_seed(1)
    q, nk, nv = (torch.randn(shape, generator=gen).to(cuda, dtype)
                 for shape in ((b, kh, g, hd), (b, kh, hd), (b, kh, hd)))
    kc = [t.clone() for t in cache]
    pc = [t.clone() for t in cache]
    got = decode_attention(q, *kc, nk, nv, pos)
    want = decode_attention_plain(q, *pc, nk, nv, pos)
    assert_attention_close(got, want)
    for a, c in zip(kc, pc):
        assert torch.equal(a, c)


def _paged(cache, lengths, page, seed):
    """Dense (B, S, K, x) caches -> shuffled page pools + (B, S / page)
    table; slot 0 becomes a freed slot (its table row all trash page 0)."""
    b, s = cache[0].shape[:2]
    maxp = s // page
    need = [min(maxp, -(-int(n) // page) + 1) for n in lengths]
    total = 2 + sum(need)
    order = list(np.random.RandomState(seed).permutation(np.arange(1, total)))
    table = torch.zeros((b, maxp), dtype=torch.int32)
    pools = [torch.zeros((total, page) + tuple(t.shape[2:]), dtype=t.dtype,
                         device=t.device) for t in cache]
    for i in range(b):
        for j in range(need[i]):
            table[i, j] = int(order.pop())
            for pool, t in zip(pools, cache):
                pool[int(table[i, j])] = t[i, j * page:(j + 1) * page]
    table[0] = 0
    return pools, table.to(cache[0].device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [8, 256])
@pytest.mark.parametrize("kh,g,hd", [(2, 3, 64), (1, 8, 128), (4, 1, 32)])
def test_decode_attention_paged_kernel(cuda, dtype, page, kh, g, hd):
    """Pos 0 on the freed slot, pos == maxp * page on a full one; pages
    smaller than the kernel's 128-row tile and larger."""
    b, s = 4, 512
    pos = torch.tensor([0, 1, 300, s], dtype=torch.int32, device=cuda)
    cache = _cache(cuda, b, s, kh, hd, pos.cpu(), seed=page + kh)
    pools, table = _paged(cache, pos.tolist(), page, seed=page)
    gen = torch.Generator().manual_seed(3)
    q, nk, nv = (torch.randn(shape, generator=gen).to(cuda, dtype)
                 for shape in ((b, kh, g, hd), (b, kh, hd), (b, kh, hd)))
    kc = [t.clone() for t in pools]
    pc = [t.clone() for t in pools]
    before = decode_attention_paged.launches
    got = decode_attention_paged(q, *kc, nk, nv, pos, table)
    assert decode_attention_paged.launches == before + 1
    want = decode_attention_paged_plain(q, *pc, nk, nv, pos, table)
    assert_attention_close(got, want)
    for a, c in zip(kc, pc):
        assert torch.equal(a[1:], c[1:])
    # the dense kernel on the source cache: bit for bit
    dc = [t.clone() for t in cache]
    kc = [t.clone() for t in pools]
    dense = decode_attention(q, *dc, nk, nv, pos)
    assert torch.equal(decode_attention_paged(q, *kc, nk, nv, pos, table),
                       dense)
    live = torch.arange(1, b, device=cuda)
    at = pos.long().clamp(max=s - 1)[1:]
    pid = table[live, at // page].long()
    for a, c in zip(kc, dc):
        assert torch.equal(a[pid, at % page], c[live, at])


@pytest.mark.cuda
def test_decode_attention_paged_rejects_what_it_cannot_take(cuda):
    b, kh, hd, page = 2, 2, 64, 16
    q = torch.zeros((b, kh, 1, hd), device=cuda)
    pool = torch.zeros((4, page, kh, hd), dtype=torch.int8, device=cuda)
    sc = torch.zeros((4, page, kh, 1), device=cuda)
    rows = torch.zeros((b, kh, hd), device=cuda)
    pos = torch.zeros((b,), dtype=torch.int32, device=cuda)
    table = torch.zeros((b, 2), dtype=torch.int32, device=cuda)
    for bad in (dict(table=table.long()), dict(pos=pos.long()),
                dict(pool=pool[:, :, :, 1:]),
                dict(q=torch.zeros((b, kh, 1, 48), device=cuda))):
        args = {**dict(q=q, pool=pool, table=table, pos=pos), **bad}
        with pytest.raises(ValueError, match="decode_attention_paged"):
            decode_attention_paged(args["q"], args["pool"], sc, args["pool"],
                                   sc, rows, rows, args["pos"], args["table"])

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,q_offset", [(6, 2, 64, 0), (4, 4, 32, 7),
                                              (2, 1, 128, 0)])
def test_flash_q8_kernel(cuda, dtype, h, kh, hd, q_offset):
    b, sq, skv = 2, 130, 200
    kq, ks, vq, vs = _cache(cuda, b, skv, kh, hd, [q_offset + sq] * b, seed=h)
    q = torch.randn((b, sq, h, hd), generator=torch.Generator().manual_seed(2)
                    ).to(cuda, dtype)
    got = flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True,
                                 q_offset=q_offset)
    want = flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=True,
                                        q_offset=q_offset)
    assert_attention_close(got, want)


def _bwd_inputs(m, n, other, dtype, seed):
    """A gradient g (m, n) with an all-zero row and column and exact
    rounding ties (row 0 and column 6 reach a scale of exactly 1 when their
    fold scales are 1, as the tests set them), and an int8 payload
    (other, n) or (m, other)."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(m, n) * 0.02).astype(np.float32)
    g[0, :8] = [127.0, 0.5, 1.5, 2.5, -2.5, 0.0, 127.0, -3.5]
    g[1:8, 6] = [0.5, 1.5, 2.5, -2.5, -0.5, -1.5, 4.5]
    g[3] = 0.0
    g[:, 5] = 0.0
    return (torch.from_numpy(g).to(dtype),
            torch.from_numpy(rng.randint(-128, 128, (other, n)
                                         ).astype(np.int8)),
            torch.from_numpy(rng.randint(-128, 128, (m, other)
                                         ).astype(np.int8)),
            rng)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(256, 768, 3072), (130, 257, 90),
                                   (64, 3072, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_nt_kernel(cuda, m, n, k, dtype):
    g, w, _, rng = _bwd_inputs(m, n, k, dtype, seed=m + n + k)
    fold = torch.from_numpy(rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32))
    fold[0, :8] = 1.0
    absmax = (g.float().abs() * fold).amax(dim=1, keepdim=True)
    qs = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    qs[7::7] = 0.0                  # zero scales: the guard maps them to 1
    g, w, fold, qs = (t.to(cuda) for t in (g, w, fold, qs))
    before = int8_matmul_nt.launches
    got = int8_matmul_nt(g, w, fold, qs, out_dtype=dtype)
    assert int8_matmul_nt.launches == before + 1
    assert torch.equal(got, int8_matmul_nt_plain(g, w, fold, qs,
                                                 out_dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(512, 768, 3072), (130, 257, 90),
                                   (1024, 3072, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_tn_kernel(cuda, m, n, k, dtype):
    g, _, x, rng = _bwd_inputs(m, n, k, dtype, seed=m * n + k)
    fold = torch.from_numpy(rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32))
    fold[:8] = 1.0
    absmax = (g.float().abs() * fold).amax(dim=0, keepdim=True)
    qs = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    qs[:, 7::7] = 0.0
    x, g, fold, qs = (t.to(cuda) for t in (x, g, fold, qs))
    before = int8_matmul_tn.launches
    got = int8_matmul_tn(x, g, fold, qs, out_dtype=dtype)
    assert int8_matmul_tn.launches == before + 1
    assert torch.equal(got, int8_matmul_tn_plain(x, g, fold, qs,
                                                 out_dtype=dtype))


def adamw_bucket(rows, bs, recipe, seed, pad_rows=0):
    """A (rows, bs) AdamW bucket in the blockwise codec layout: moments
    encoded from random fp values (m2 non-negative), the last ``pad_rows``
    rows zero as the bucket's padding is, and the eight scalars."""
    from repro_torch.core.quantizer import quantize_int
    rng = np.random.RandomState(seed)
    g = torch.from_numpy((rng.randn(rows, bs) * 1e-2).astype(np.float32))
    p = torch.from_numpy(rng.randn(rows, bs).astype(np.float32))
    m1 = torch.from_numpy((rng.randn(rows, bs) * 1e-3).astype(np.float32))
    m2 = torch.from_numpy((rng.rand(rows, bs) * 1e-5).astype(np.float32))
    r2 = recipe.adam_m2
    m2 = m2.sqrt() if r2.sqrt_domain else m2
    state = [*quantize_int(m1, recipe.adam_m1), *quantize_int(m2, r2)]
    out = [g, p] + state
    if pad_rows:
        for t in out:
            t[rows - pad_rows:] = 0
    step = 3
    sc = torch.tensor([0.7, 1e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** step,
                       1 - 0.95 ** step], dtype=torch.float32)
    return out + [sc]


ADAM_RECIPES = ["m1:8c-b128,m2:8c-asym-b128-sqrt", "m1:8c-b128,m2:8c-b128",
                "m1:8c-b64,m2:8c-asym-b64"]


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ADAM_RECIPES)
def test_fused_adamw_kernel(cuda, recipe):
    rec = parse_recipe(recipe)
    bs = rec.adam_m1.block_size
    bucket = [t.to(cuda) for t in adamw_bucket(1000, bs, rec, seed=bs,
                                                pad_rows=37)]
    kw = dict(m1_codec=codec_of(rec.adam_m1), m2_codec=codec_of(rec.adam_m2),
              weight_decay=True)
    ref = [t.clone() for t in bucket]
    before = fused_adamw_blocks.launches
    got = fused_adamw_blocks(*bucket, **kw)
    assert fused_adamw_blocks.launches == before + 1
    want = fused_adamw_blocks_plain(*ref, **kw)
    for a, b in zip(bucket[1:8], ref[1:8]):     # p and the six moment parts
        assert torch.equal(a, b)
    assert torch.isclose(got[3], want[3], rtol=1e-5, atol=0.0)


def qdq_inputs(rows, f, bits, seed):
    """(rows, f) float32 values with the rounding cases planted: row 0
    reaches absmax qmax (a per-row scale of exactly 1) and holds exact x.5
    ties of both signs, row 1 is all zero, and column 2 holds x.5 values
    (ties under a scale of 1, which the per-channel test gives it)."""
    qmax = 2 ** (bits - 1) - 1
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, f) * 0.02).astype(np.float32)
    ties = [qmax, 0.5, 1.5, 2.5, -2.5, -0.5, -3.5, 4.5]
    x[0, :min(f, 8)] = ties[:min(f, 8)]
    if rows > 1:
        x[1] = 0.0
    if f > 2 and rows > 3:
        col = np.array([0.5, -1.5, 2.5, -4.5] + [0.25] * (rows - 4))
        x[2:, 2] = col[:rows - 2]
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f", [(8192, 768), (300, 3072), (7, 257),
                                    (1, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_qdq_row_kernel(cuda, rows, f, dtype, bits):
    x = qdq_inputs(rows, f, bits, seed=rows + f + bits).to(dtype).to(cuda)
    before = qdq_row.launches
    got = qdq_row(x, bits)
    assert qdq_row.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, qdq_row_plain(x, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f", [(8192, 3072), (300, 768), (7, 257),
                                    (1, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [True, False])
def test_qdq_scaled_kernel(cuda, rows, f, dtype, bits, per_channel):
    qmax = 2 ** (bits - 1) - 1
    x = qdq_inputs(rows, f, bits, seed=rows * f + bits).to(dtype).to(cuda)
    xf = x.float().abs()
    absmax = (xf.amax(dim=0, keepdim=True) if per_channel
              else xf.amax().reshape(1, 1))
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, float(qmax))
    if per_channel and f > 2:
        scale[0, 2] = 1.0           # the planted ties of column 2
    before = qdq_scaled.launches
    got = qdq_scaled(x, scale, bits)
    assert qdq_scaled.launches == before + 1
    assert torch.equal(got, qdq_scaled_plain(x, scale, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdq_kernels_unaligned_and_nonfinite(cuda, dtype):
    """An input 4 bytes past a 16-byte boundary takes the scalar path; NaN
    rows come out all NaN and inf rows as the plain version gives them."""
    buf = qdq_inputs(65, 768, 8, seed=3).to(dtype).reshape(-1).to(cuda)
    x = buf[2:2 + 64 * 768].view(64, 768)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(qdq_row(x), qdq_row_plain(x))
    scale = torch.full((1, 768), 0.01, device=cuda)
    assert torch.equal(qdq_scaled(x, scale), qdq_scaled_plain(x, scale))
    y = x.clone()
    y[5, 7] = float("nan")
    y[9, 3] = float("inf")
    for got, want in ((qdq_row(y), qdq_row_plain(y)),
                      (qdq_scaled(y, scale), qdq_scaled_plain(y, scale))):
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
    assert bool(qdq_row(y)[5].isnan().all())


@pytest.mark.cuda
def test_qdq_kernels_reject_what_they_cannot_take(cuda):
    x = torch.randn(16, 32, device=cuda)
    scale = torch.ones(1, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qdq_row(x.t())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qdq_row(x.half())
    with pytest.raises(ValueError, match="bits"):
        qdq_row(x, bits=1)
    with pytest.raises(ValueError, match="rows, F"):
        qdq_row(x[None])
    with pytest.raises(ValueError, match=r"\(1, 32\) or \(1, 1\)"):
        qdq_scaled(x, torch.ones(32, device=cuda))
    with pytest.raises(ValueError, match="float32 tensor on"):
        qdq_scaled(x, scale.cpu())
    with pytest.raises(ValueError, match="float32 tensor on"):
        qdq_scaled(x, scale.bfloat16())


def _flash_inputs(cuda, bh, sq, skv, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to(cuda, dtype)
                   for shape in ((bh, sq, d), (bh, skv, d), (bh, skv, d),
                                 (bh, sq, d)))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,skv,d,causal,off", [
    (8, 256, 256, 64, True, 0), (3, 200, 1000, 64, True, 800),
    (2, 1000, 1000, 16, True, 0), (2, 129, 300, 32, False, 0),
    (2, 300, 1024, 64, True, 0), (2, 96, 96, 48, True, 0),
    (2, 256, 256, 128, True, 0), (2, 100, 256, 160, True, 156),
    (2, 130, 130, 256, True, 0), (1, 70, 70, 256, False, 0)])
def test_flash_kernels(cuda, dtype, bh, sq, skv, d, causal, off):
    q, k, v, do = _flash_inputs(cuda, bh, sq, skv, d, dtype, seed=sq + d)
    counts = [f.launches for f in (fa.flash_attention_fwd_lse,
                                   fa.flash_attention_bwd_dkdv,
                                   fa.flash_attention_bwd_dq)]
    got = chip_smoke._flash_all(fa, q, k, v, do, causal, off)
    assert [f.launches for f in (fa.flash_attention_fwd_lse,
                                 fa.flash_attention_bwd_dkdv,
                                 fa.flash_attention_bwd_dq)] == \
        [n + 1 for n in counts]
    want = chip_smoke._flash_plain(fa, q, k, v, do, got[1], got[5], causal,
                                   off)
    dname = str(dtype)[6:]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=chip_smoke.FLASH_TOL[dname])
    torch.testing.assert_close(got[1], want[1], rtol=0,
                               atol=chip_smoke.FLASH_LSE_TOL)
    if dtype == torch.float32:
        for name, g, w in zip(("dq", "dk", "dv"), got[2:5], want[2:]):
            rel = chip_smoke._rel_l2(torch, [g], [w])
            assert rel <= chip_smoke.FLASH_GRAD_TOL, (name, rel)
    else:
        lim = chip_smoke.FLASH_BF16
        for name, g, w in zip(("o", "dq", "dk", "dv"), got[:1] + got[2:5],
                              want[:1] + want[2:]):
            rel, over = chip_smoke._bf16_distance(torch, g, w)
            assert rel <= lim["rel_l2"] and over <= lim["over_ulp"], \
                (name, rel, over)
    # #7 is #8's body without the LSE store; a launch repeats its bits
    assert torch.equal(fa.flash_attention_fwd(q, k, v, causal=causal,
                                              q_offset=off), got[0])
    again = chip_smoke._flash_all(fa, q, k, v, do, causal, off)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_propagate_nan(cuda, dtype):
    """A NaN in q row 70 of head 1: that row's o and LSE, its dq row and
    every dk / dv row it attends to come out NaN; head 0 stays finite."""
    q, k, v, do = _flash_inputs(cuda, 2, 128, 128, 64, dtype, seed=9)
    q[1, 70, 5] = float("nan")
    o, lse, dq, dk, dv, _ = chip_smoke._flash_all(fa, q, k, v, do, True, 0)
    assert bool(o[1, 70].isnan().all()) and bool(lse[1, 70].isnan())
    assert bool(dq[1, 70].isnan().all())
    assert bool(dk[1, :71].isnan().all()) and bool(dv[1, :71].isnan().all())
    for t in (o, dq, dk, dv):
        assert bool(t[0].isfinite().all())


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_cannot_take(cuda):
    q = torch.randn(2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16 from 16 to 256"):
        fa.flash_attention_fwd(q[..., :40].contiguous(), q[..., :40]
                               .contiguous(), q[..., :40].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd_lse(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q, q.transpose(1, 2), q)
    with pytest.raises(ValueError, match="on cuda"):
        fa.flash_attention_fwd(q, q.cpu(), q)
