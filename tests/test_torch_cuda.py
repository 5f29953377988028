"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible (the kernels have no CPU mode); on a machine with a card, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: the three int8 matmuls (forward, nt, tn) bit for bit -- the
forward on both its routes (the cluster's split-K weight stream up to 16
rows, at every cluster size, and the tensor cores at any M) and the first
dp4a kernel, the wrapper taking the route ``fwd_route`` names, the fused
decode entry ``int8_quant_matmul`` against quantize_int + the plain
matmul (rows holding a NaN or an infinity included), a repeat
bit-identical -- and so each
stage of the
forward and the backward against its plain stage (the quantize passes,
the transposes, the int8 GEMM with its scale per row, per column or both,
the split partials and their reduction), a second nt or tn launch
repeating the first's bits; the
attention kernels within 1e-5 of the plain version at the float32 carrier
(fp32 sums in another order), within one bfloat16 rounding step at the
bfloat16 carrier (two fp32 values a few ulp apart can round to
neighbouring bf16 values; the int8-KV prefill's tensor-core kernel also
within 1e-3 of the float32 plain version before its cast, and routed by
``q8_library``), and the decode step's written cache rows bit
for bit, a second launch repeating its bits, at G of 1-16 and positions on
the edges of the kernel's chunks; the paged decode step equal to the dense
one bit for bit on the same logical cache (context and written rows) at
pages of 8-256 rows, its written pools equal to its plain version's
outside the trash page 0; the fused AdamW step bit for bit in params, payloads, scales and
zero points (both versions round every op on its own) through both of its
entries -- a bucket in place (also 4 bytes off alignment) and leaves read
where they lie (one 4 bytes off, ragged tails, two steps, a repeat
bit-identical) -- its update-norm sum within 1e-5 relative (partial sums
in another order); the fused fake
quantization kernels ``qdq_row`` / ``qdq_scaled`` bit for bit, exact x.5
ties, all-zero rows and NaN rows included, ``qdq_row`` at widths on both
sides of each of its paths' limits; the fp flash kernels #7-#10
against their plain versions on the same inputs (the plain backward reads
the kernels' lse and delta): outputs within 2e-5 at float32 and 2e-2 at
bfloat16, LSE rows within 2e-5, gradients within 1e-4 relative L2 at
float32, and at bfloat16 o and the gradients within
``chip_smoke.FLASH_BF16`` (relative L2, and the share of elements more
than one bf16 step apart), #7 equal to #8's output, every launch
repeating its bits, a NaN in q reaching o, the LSE and every gradient it
touches (at bf16 and d <= 128 the backward is ``flash_bwd_sm90.cu``'s
tensor-core kernels, held to the plain backward with float64 sums and
delta summed in float64, ``chip_smoke._flash_all``; the rule and the
exported head-dim limit are checked too); the bf16 forward's key tile
equal to ``kv_tile`` at every head dim, and every flash wrapper refusing a
CUDA tensor that does not start on a 16-byte boundary (the bf16 kernels
read by TMA); a small llama config's loss and gradients bit for bit with
recomputation on and off.
"""
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.qconfig import Granularity, QuantSpec
from repro_torch.core.quantizer import quantize_int
from repro_torch.kernels import (decode_attention, decode_attention_paged,
                                 flash_attention_fwd_q8, fused_adamw_blocks,
                                 fused_adamw_leaves, int8_matmul, int8_matmul_nt, int8_matmul_tn,
                                 qdq_row, qdq_scaled)
from repro_torch.kernels.decode_attn import (DECODE_CHUNK,
                                             decode_attention_paged_plain,
                                             decode_attention_plain)
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
from repro_torch.kernels.int8_matmul import (int8_matmul_nt_plain,
                                             int8_matmul_plain,
                                             int8_matmul_tn_plain)
from repro_torch.kernels.opt_update import (codec_of,
                                            fused_adamw_blocks_plain,
                                            fused_adamw_leaves_plain)
from repro_torch.kernels.qdq import qdq_row_plain, qdq_scaled_plain
from repro_torch.core.qconfig import parse_recipe

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (limits and helpers; imports no torch)

SPEC = QuantSpec(8, Granularity.PER_TOKEN)
# the int8 matmul module (the package re-exports a function of its name)
im = importlib.import_module("repro_torch.kernels.int8_matmul")


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


def _mm_case(cuda, m, k, n):
    """int8 payloads and scales, every 3rd row scale and 4th column scale
    0 (the guard maps them to 1)."""
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
    rs = torch.from_numpy(rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32))
    cs = torch.from_numpy(rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32))
    rs[::3] = 0.0
    cs[:, ::4] = 0.0
    return tuple(t.to(cuda) for t in (x, w, rs, cs))


#: (M, K, N): the decode step's 16 slots, M = 17 and 64 past the route's
#: limit,
#: the training shape M = 8192, ragged M, N and K (K = 40 and 90: x is read
#: through a padded copy), GPT-2's three linears
FWD_CUDA_SHAPES = [(16, 768, 3072), (70, 3072, 768), (5, 40, 24),
                   (17, 768, 768), (64, 768, 3072), (8192, 768, 3072),
                   (130, 90, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", FWD_CUDA_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel(cuda, m, k, n, out_dtype):
    """The wrapper (one launch on its counter), both routes at every M they
    take (the cluster route up to 16 rows) and the first dp4a kernel, bit for
    bit against the plain version."""
    x, w, rs, cs = _mm_case(cuda, m, k, n)
    before = int8_matmul.launches
    got = int8_matmul(x, w, rs, cs, out_dtype=out_dtype)
    assert int8_matmul.launches == before + 1
    want = int8_matmul_plain(x, w, rs, cs, out_dtype=out_dtype)
    assert torch.equal(got, want)
    routes = [im.int8_matmul_dp4a, im.int8_matmul_wgmma]
    if m <= im.FWD_GEMV_MAX_M:
        routes.append(im.int8_matmul_gemv)
    for route in routes:
        assert torch.equal(route(x, w, rs, cs, out_dtype), want), route
    assert int8_matmul.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 768, 768), (16, 3072, 768),
                                   (7, 90, 257), (1, 40, 24), (13, 300, 130),
                                   (16, 5000, 100), (16, 131071, 48)])
def test_int8_gemv_every_cluster_size(cuda, m, k, n):
    """The cluster route at every cluster size (1-8 blocks, a short or empty
    last split), ragged K and N (N = 257 and 130 read through a padded
    weight copy), contractions over several 256-row stages and the longest
    the int32 sums allow: the plain version's bits, and a repeat's.  More
    than 16 rows raise."""
    x, w, rs, cs = _mm_case(cuda, m, k, n)
    for out in (torch.float32, torch.bfloat16):
        want = int8_matmul_plain(x, w, rs, cs, out)
        for splits in range(1, im.GEMV_MAX_SPLITS + 1):
            got = im.int8_matmul_gemv(x, w, rs, cs, out, splits=splits)
            again = im.int8_matmul_gemv(x, w, rs, cs, out, splits=splits)
            assert torch.equal(got, want), splits
            assert torch.equal(again, got), splits
    x, w, rs, cs = _mm_case(cuda, im.FWD_GEMV_MAX_M + 1, k, n)
    with pytest.raises(ValueError):
        im.int8_matmul_gemv(x, w, rs, cs)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 16])
@pytest.mark.parametrize("k,n", [(768, 768), (3072, 768), (90, 257),
                                 (40, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quant_matmul_kernel(cuda, m, k, n, dtype):
    """The fused decode entry: per-token quantization in the kernel's
    prologue, an all-zero row included, bit for bit quantize_int +
    int8_matmul_plain (its plain version) at ragged K and N, a repeat
    bit-identical, one launch on int8_matmul's counter per call; and
    ops.int8_prepared_linear takes it (one launch) with the same bits."""
    import repro_torch.kernels.ops as ops
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 3).astype(np.float32))
    x[m // 2] = 0.0
    x = x.to(dtype).to(cuda)
    _, w, _, cs = _mm_case(cuda, m, k, n)
    cs = cs.abs() + 1e-3                    # a prepared weight's scales
    want = im.int8_quant_matmul_plain(x, w, cs, SPEC, dtype)
    before = int8_matmul.launches
    got = im.int8_quant_matmul(x, w, cs, SPEC, dtype)
    again = im.int8_quant_matmul(x, w, cs, SPEC, dtype)
    assert int8_matmul.launches == before + 2
    assert torch.equal(got, want) and torch.equal(again, got)
    xq, scale, _ = quantize_int(x, SPEC)
    assert torch.equal(got, int8_matmul_plain(xq, w, scale, cs, dtype))
    assert im.takes_quant_fwd(x, SPEC, dtype)
    lin = ops.int8_prepared_linear(x, w, cs, SPEC)
    assert int8_matmul.launches == before + 3
    assert torch.equal(lin, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768), (90, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quant_matmul_nonfinite_rows(cuda, k, n, dtype):
    """The fused entry on rows holding a NaN, +inf or -inf (in the first,
    a middle and the last contraction split): the row scale carries them as
    quantize_int's torch.amax and torch.clamp do, so the outputs equal the
    plain version's -- NaN where it has NaN, the same bits elsewhere -- a
    NaN row all NaN, the finite rows untouched."""
    rng = np.random.RandomState(k + n)
    x = torch.from_numpy((rng.standard_normal((16, k)) * 3).astype(np.float32))
    clean_x = x.clone()
    x[3, k - 1] = float("nan")
    x[5, 0] = float("inf")
    x[9, k // 2] = float("-inf")
    x[11, 1] = float("nan")
    x[11, 2] = float("inf")
    x, clean_x = (t.to(dtype).to(cuda) for t in (x, clean_x))
    _, w, _, cs = _mm_case(cuda, 16, k, n)
    cs = cs.abs() + 1e-3
    want = im.int8_quant_matmul_plain(x, w, cs, SPEC, dtype)
    got = im.int8_quant_matmul(x, w, cs, SPEC, dtype)
    again = im.int8_quant_matmul(x, w, cs, SPEC, dtype)
    same = (got == want) | (got.isnan() & want.isnan())
    assert bool(same.all()), (got[~same][:8], want[~same][:8])
    assert bool(((again == got) | (again.isnan() & got.isnan())).all())
    assert bool(got[3].isnan().all() and got[11].isnan().all())
    assert not bool(got[[5, 9]].isfinite().any())
    finite = [r for r in range(16) if r not in (3, 5, 9, 11)]
    clean = im.int8_quant_matmul(clean_x, w, cs, SPEC, dtype)
    assert torch.equal(got[finite], clean[finite])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(17, 768, 768), (130, 90, 257),
                                   (1024, 768, 768), (300, 3072, 48)])
def test_int8_fwd_stage_kernels(cuda, m, k, n):
    """The forward's stage kernels against their plain stages, bit for bit:
    the weight's transpose pass, the GEMM with both scales at every split
    count (up to 4), the split partials' reduction."""
    x, w, rs, cs = _mm_case(cuda, m, k, n)
    wt = im.transpose_packed(w)
    assert torch.equal(wt, im.transpose_packed_plain(w))
    xk = im.kmajor_weight(x)
    for out in (torch.float32, torch.bfloat16):
        want = im.int8_gemm_fwd_plain(xk, wt, rs, cs, k, out)
        assert torch.equal(want, int8_matmul_plain(x, w, rs, cs, out))
        for s in range(1, min(-(-k // im.GEMM_STEP), 4) + 1):
            try:
                im._split_bounds(k, s)
            except ValueError:
                continue
            assert torch.equal(im.int8_gemm_fwd(xk, wt, rs, cs, k, out,
                                                splits=s), want), s
            if s > 1:
                ws = im.int8_gemm_partials(xk, wt, k, s)
                assert torch.equal(im.int8_split_reduce_fwd(ws, rs, cs, out),
                                   want)


@pytest.mark.cuda
def test_int8_matmul_routes_by_rows(cuda, monkeypatch):
    """A CUDA call takes the route ``fwd_route`` names: the cluster's
    split-K weight stream at M <= FWD_GEMV_MAX_M, the transpose pass and the
    tensor-core GEMM above (one launch on the counter either way); the
    first dp4a kernel on no route."""
    taken = []
    for name in ("int8_matmul_dp4a", "int8_matmul_gemv", "int8_matmul_wgmma"):
        real = getattr(im, name)
        monkeypatch.setattr(im, name, lambda *a, _r=real, _n=name, **kw:
                            taken.append(_n) or _r(*a, **kw))
    for m in (1, 16, 17, 64):
        x, w, rs, cs = _mm_case(cuda, m, 768, 768)
        taken.clear()
        im.int8_matmul(x, w, rs, cs)
        assert taken == ["int8_matmul_" + im.fwd_route(m, 768, 768)], m
        assert taken == ["int8_matmul_gemv" if m <= im.FWD_GEMV_MAX_M
                         else "int8_matmul_wgmma"]


#: decode kernel cases (kv heads, group, head dim): G in {1, 3, 8, 16} at
#: every head dim the kernel takes
DECODE_CASES = [(4, 1, 32), (2, 3, 64), (1, 8, 128), (2, 16, 64),
                (1, 16, 128), (1, 16, 32), (12, 1, 64)]


def _decode_pos(s):
    """Per-slot positions: pos 0 (slot 0), the edges of the kernel's
    chunks (1, C - 1, C, C + 1), a middle one, S - 1 and S (the clamped
    write of a full slot)."""
    c = DECODE_CHUNK
    return [0, 1, c - 1, c, c + 1, min(2 * c + 37, s - 2), s - 1, s]


def _decode_rows(dev, dtype, b, kh, g, hd, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dev, dtype)
            for shape in ((b, kh, g, hd), (b, kh, hd), (b, kh, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,g,hd", DECODE_CASES)
@pytest.mark.parametrize("s", [300, 1024])
def test_decode_attention_kernel(cuda, dtype, kh, g, hd, s):
    """Against the plain version (context, and the written rows bit for
    bit) at positions on the chunk edges; a second launch on a clone of the
    same cache repeats the context's and the written rows' bits."""
    from repro_torch.kernels import _build
    assert _build.load("decode_attn").repro_decode_chunk() == DECODE_CHUNK
    pos_l = _decode_pos(s)
    b = len(pos_l)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda)
    cache = _cache(cuda, b, s, kh, hd, pos_l, seed=kh * g + s)
    q, nk, nv = _decode_rows(cuda, dtype, b, kh, g, hd, seed=1)
    kc = [t.clone() for t in cache]
    pc = [t.clone() for t in cache]
    rc = [t.clone() for t in cache]
    got = decode_attention(q, *kc, nk, nv, pos)
    want = decode_attention_plain(q, *pc, nk, nv, pos)
    assert_attention_close(got, want)
    for a, c in zip(kc, pc):
        assert torch.equal(a, c)
    again = decode_attention(q, *rc, nk, nv, pos)
    assert torch.equal(again, got)
    for a, c in zip(rc, kc):
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
@pytest.mark.parametrize("page", [8, 16, 64, 256])
@pytest.mark.parametrize("kh,g,hd", [(2, 3, 64), (1, 8, 128), (4, 1, 32),
                                     (2, 16, 64)])
def test_decode_attention_paged_kernel(cuda, dtype, page, kh, g, hd):
    """Pos 0 on the freed slot, the chunk edges, pos == maxp * page on a
    full one over a 1024-row logical cache; pages smaller than the
    kernel's chunk and larger.  Against the plain version, bit for bit
    against the dense kernel on the source cache, and a second launch
    repeats the first's bits."""
    s = 1024
    pos_l = _decode_pos(s)
    b = len(pos_l)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda)
    cache = _cache(cuda, b, s, kh, hd, pos_l, seed=page + kh)
    pools, table = _paged(cache, pos_l, page, seed=page)
    q, nk, nv = _decode_rows(cuda, dtype, b, kh, g, hd, seed=3)
    kc = [t.clone() for t in pools]
    pc = [t.clone() for t in pools]
    rc = [t.clone() for t in pools]
    before = decode_attention_paged.launches
    got = decode_attention_paged(q, *kc, nk, nv, pos, table)
    assert decode_attention_paged.launches == before + 1
    want = decode_attention_paged_plain(q, *pc, nk, nv, pos, table)
    assert_attention_close(got, want)
    for a, c in zip(kc, pc):
        assert torch.equal(a[1:], c[1:])
    assert torch.equal(decode_attention_paged(q, *rc, nk, nv, pos, table),
                       got)
    for a, c in zip(rc, kc):
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

#: (B, Sq, Skv, H, KH, hd, q_offset): GQA 6/2 and MQA 2/1, hd 32 / 64 /
#: 128, an offset of 7, ragged Sq and Skv, and the engine's shapes (16
#: slots at the 512 bucket, one prompt at 32, over 1024-row buffers)
Q8_CUDA_SHAPES = [(2, 130, 200, 6, 2, 64, 0), (2, 130, 200, 4, 4, 32, 7),
                  (2, 130, 200, 2, 1, 128, 0), (16, 512, 1024, 12, 12, 64, 0),
                  (1, 32, 1024, 12, 12, 64, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kh,hd,q_offset", Q8_CUDA_SHAPES)
def test_flash_q8_kernel(cuda, dtype, b, sq, skv, h, kh, hd, q_offset):
    """Within 1e-5 at float32 and one bf16 step at bfloat16; the bf16
    kernel's output before its cast within 1e-3 of the plain version at
    float32 (phase 3's limit), and a second launch repeats its bits."""
    kq, ks, vq, vs = _cache(cuda, b, skv, kh, hd, [q_offset + sq] * b, seed=h)
    q = torch.randn((b, sq, h, hd), generator=torch.Generator().manual_seed(2)
                    ).to(cuda, dtype)
    got = flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True,
                                 q_offset=q_offset)
    want = flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=True,
                                        q_offset=q_offset)
    assert_attention_close(got, want)
    assert torch.equal(flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True,
                                              q_offset=q_offset), got)
    if dtype == torch.bfloat16:
        f32 = fa.launch_q8("flash_q8_sm90", q, kq, ks, vq, vs, causal=True,
                           q_offset=q_offset, out_dtype=torch.float32)
        want32 = flash_attention_fwd_q8_plain(q.float(), kq, ks, vq, vs,
                                              causal=True, q_offset=q_offset)
        assert (f32 - want32).abs().max().item() <= 1e-3
        assert torch.equal(f32.bfloat16(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", chip_smoke.YI_INT8_KN)
def test_int8_matmul_yi_shapes(cuda, k, n):
    """#3 at a Yi-6B layer's four (K, N) (contractions up to 11,008):
    the wrapper and both routes at the decode step's 16 rows, the wrapper at
    a 2048-row prefill, and the fused decode entry at 16 bf16 rows, bit for
    bit against the plain versions."""
    for m in (16, 2048):
        x, w, rs, cs = _mm_case(cuda, m, k, n)
        want = int8_matmul_plain(x, w, rs, cs, torch.bfloat16)
        assert torch.equal(int8_matmul(x, w, rs, cs), want), m
        if m <= im.FWD_GEMV_MAX_M:
            for route in (im.int8_matmul_gemv, im.int8_matmul_wgmma):
                assert torch.equal(route(x, w, rs, cs, torch.bfloat16),
                                   want), route
    rng = np.random.RandomState(k + n)
    xf = torch.from_numpy((rng.standard_normal((16, k)) * 3).astype(
        np.float32)).to(cuda, torch.bfloat16)
    cs = cs.abs() + 1e-3
    assert torch.equal(im.int8_quant_matmul(xf, w, cs, SPEC, torch.bfloat16),
                       im.int8_quant_matmul_plain(xf, w, cs, SPEC,
                                                  torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [None, 16, 64, 256])
def test_decode_attention_yi_shape(cuda, dtype, page):
    """#12 (``page`` None) and #13 at Yi-6B's decode step: 4 KV heads of
    128, 8 query rows each, a 4096-row logical cache, positions on the
    chunk edges: against the plain version (the written rows bit for bit),
    #13 bit for bit against #12 on the same logical cache."""
    _, s, kh, g, hd = chip_smoke.YI_DECODE_SHAPE
    pos_l = _decode_pos(s)
    b = len(pos_l)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda)
    cache = _cache(cuda, b, s, kh, hd, pos_l, seed=7)
    q, nk, nv = _decode_rows(cuda, dtype, b, kh, g, hd, seed=5)
    dc = [t.clone() for t in cache]
    pc = [t.clone() for t in cache]
    dense = decode_attention(q, *dc, nk, nv, pos)
    assert_attention_close(dense, decode_attention_plain(q, *pc, nk, nv, pos))
    for a, c in zip(dc, pc):
        assert torch.equal(a, c)
    if page is None:
        return
    pools, table = _paged(cache, pos_l, page, seed=page)
    kc = [t.clone() for t in pools]
    pc = [t.clone() for t in pools]
    got = decode_attention_paged(q, *kc, nk, nv, pos, table)
    want = decode_attention_paged_plain(q, *pc, nk, nv, pos, table)
    assert_attention_close(got, want)
    for a, c in zip(kc, pc):
        assert torch.equal(a[1:], c[1:])
    assert torch.equal(got, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_q8_yi_shape(cuda, dtype):
    """#11 at Yi-6B's prefill, one 2048-token prompt over a 4096-row
    buffer, 32 query heads over 4 KV heads of 128: within 1e-5 at float32
    and one bf16 step at bfloat16, the bf16 kernel before its cast within
    1e-3 of the float32 plain version."""
    _, sq, skv, h, kh, hd = chip_smoke.YI_Q8_SHAPE
    kq, ks, vq, vs = _cache(cuda, 1, skv, kh, hd, [sq], seed=11)
    q = torch.randn((1, sq, h, hd), generator=torch.Generator().manual_seed(4)
                    ).to(cuda, dtype)
    got = flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True)
    assert_attention_close(got, flash_attention_fwd_q8_plain(
        q, kq, ks, vq, vs, causal=True))
    if dtype == torch.bfloat16:
        f32 = fa.launch_q8("flash_q8_sm90", q, kq, ks, vq, vs, causal=True,
                           out_dtype=torch.float32)
        want32 = flash_attention_fwd_q8_plain(q.float(), kq, ks, vq, vs,
                                              causal=True)
        assert (f32 - want32).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_flash_q8_routes_bf16_to_the_tensor_cores(cuda, monkeypatch):
    """A CUDA call of #11 loads the library ``q8_library`` names: at bf16
    ``flash_q8_sm90``, at float32 ``flash_attn_q8``; the tensor-core
    kernel refuses a q that is not bf16 and a misaligned kq."""
    from repro_torch.kernels import _build
    loaded = []
    real_load = _build.load
    monkeypatch.setattr(_build, "load",
                        lambda name: loaded.append(name) or real_load(name))
    kq, ks, vq, vs = _cache(cuda, 1, 64, 2, 64, [64], seed=0)
    for dtype, want in ((torch.bfloat16, "flash_q8_sm90"),
                        (torch.float32, "flash_attn_q8")):
        q = torch.randn((1, 64, 4, 64), device=cuda).to(dtype)
        loaded.clear()
        flash_attention_fwd_q8(q, kq, ks, vq, vs)
        assert loaded == [want], (dtype, loaded)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.launch_q8("flash_q8_sm90", q, kq, ks, vq, vs)
    buf = torch.zeros(kq.numel() + 1, dtype=torch.int8, device=cuda)
    odd = buf[1:].view(kq.shape)
    odd.copy_(kq)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd_q8(q.bfloat16(), odd, ks, vq, vs)


def _bwd_inputs(m, n, other, dtype, seed):
    """A gradient g (m, n) with an all-zero row (where m > 3) and column
    and exact rounding ties (row 0 and column 6 reach a scale of exactly 1
    when their fold scales are 1, as the tests set them), and an int8
    payload (other, n) or (m, other)."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(m, n) * 0.02).astype(np.float32)
    g[0, :8] = [127.0, 0.5, 1.5, 2.5, -2.5, 0.0, 127.0, -3.5]
    g[1:8, 6] = [0.5, 1.5, 2.5, -2.5, -0.5, -1.5, 4.5][:max(0, min(m, 8) - 1)]
    if m > 3:
        g[3] = 0.0
    g[:, 5] = 0.0
    return (torch.from_numpy(g).to(dtype),
            torch.from_numpy(rng.randint(-128, 128, (other, n)
                                         ).astype(np.int8)),
            torch.from_numpy(rng.randint(-128, 128, (m, other)
                                         ).astype(np.int8)),
            rng)


def _nt_case(cuda, m, n, k, dtype):
    g, w, _, rng = _bwd_inputs(m, n, k, dtype, seed=m + n + k)
    fold = torch.from_numpy(rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32))
    fold[0, :8] = 1.0
    absmax = (g.float().abs() * fold).amax(dim=1, keepdim=True)
    qs = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    qs[7::7] = 0.0                  # zero scales: the guard maps them to 1
    return tuple(t.to(cuda) for t in (g, w, fold, qs))


def _tn_case(cuda, m, n, k, dtype):
    g, _, x, rng = _bwd_inputs(m, n, k, dtype, seed=m * n + k)
    fold = torch.from_numpy(rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32))
    fold[:8] = 1.0
    absmax = (g.float().abs() * fold).amax(dim=0, keepdim=True)
    qs = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    qs[:, 7::7] = 0.0
    return tuple(t.to(cuda) for t in (x, g, fold, qs))


#: (M, N, K): the training shape M = 8192 at (768, 768) (tn takes the split
#: path there), the ragged shapes (N = 257: nt reads a padded copy of w),
#: M < 64, and GPT-2's other linears at fewer tokens
BWD_CUDA_SHAPES = [(8192, 768, 768), (256, 768, 3072), (130, 257, 90),
                   (33, 257, 90), (64, 3072, 768), (1, 48, 40),
                   (2048, 256, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", BWD_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_nt_kernel(cuda, m, n, k, dtype, out_dtype):
    g, w, fold, qs = _nt_case(cuda, m, n, k, dtype)
    before = int8_matmul_nt.launches
    got = int8_matmul_nt(g, w, fold, qs, out_dtype=out_dtype)
    assert int8_matmul_nt.launches == before + 1
    assert torch.equal(got, int8_matmul_nt_plain(g, w, fold, qs,
                                                 out_dtype=out_dtype))
    # a second launch repeats the bits
    assert torch.equal(int8_matmul_nt(g, w, fold, qs, out_dtype=out_dtype),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", BWD_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_tn_kernel(cuda, m, n, k, dtype, out_dtype):
    x, g, fold, qs = _tn_case(cuda, m, n, k, dtype)
    before = int8_matmul_tn.launches
    got = int8_matmul_tn(x, g, fold, qs, out_dtype=out_dtype)
    assert int8_matmul_tn.launches == before + 1
    assert torch.equal(got, int8_matmul_tn_plain(x, g, fold, qs,
                                                 out_dtype=out_dtype))
    assert torch.equal(int8_matmul_tn(x, g, fold, qs, out_dtype=out_dtype),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", BWD_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_bwd_stage_kernels(cuda, m, n, k, dtype):
    """Each stage kernel of the backward against its plain stage, bit for
    bit: nt's quantize pass, tn's (the gradient quantized and transposed,
    x transposed, one launch), the GEMM at both scale sides
    and, for every split count, the split partials and their reduction."""
    g, w, fw, qn = _nt_case(cuda, m, n, k, dtype)
    x, _, fx, qt = _tn_case(cuda, m, n, k, dtype)
    gq = im.quant_rows_packed(g, fw, qn)
    assert torch.equal(gq, im.quant_rows_packed_plain(g, fw, qn))
    xt, gt = im.pack_tn(x, g, fx, qt)
    assert torch.equal(gt, im.quant_cols_packed_t_plain(g, fx, qt))
    assert torch.equal(xt, im.transpose_packed_plain(x))
    wk = im.kmajor_weight(w)
    for out in (torch.float32, torch.bfloat16):
        assert torch.equal(
            im.int8_gemm_kmajor(gq, wk, qn, n, True, out, splits=1),
            im.int8_gemm_kmajor_plain(gq, wk, qn, n, True, out))
        want = im.int8_gemm_kmajor_plain(xt, gt, qt, m, False, out)
        steps = -(-m // im.GEMM_STEP)
        for s in range(1, min(steps, 4) + 1):
            try:
                im._split_bounds(m, s)
            except ValueError:
                continue
            assert torch.equal(
                im.int8_gemm_kmajor(xt, gt, qt, m, False, out, splits=s),
                want), s
            if s > 1:
                ws = im.int8_gemm_partials(xt, gt, m, s)
                assert torch.equal(ws, im.int8_gemm_partials_plain(xt, gt, m,
                                                                   s))
                assert torch.equal(im.int8_split_reduce(ws, qt, False, out),
                                   want)


@pytest.mark.cuda
def test_int8_bwd_split_path_and_padded_weight(cuda):
    """tn at the training shape (768, 768) takes the split path and equals
    its plain version; nt reads a zero-padded copy of a w whose rows are not
    a multiple of 16 bytes, or that starts off a 16-byte boundary, and w
    itself otherwise."""
    assert im.gemm_splits(768, 768, 8192) > 1
    assert im.gemm_splits(8192, 768, 768) == 1
    x, g, fold, qs = _tn_case(cuda, 8192, 768, 768, torch.bfloat16)
    assert torch.equal(int8_matmul_tn(x, g, fold, qs, out_dtype=torch.float32),
                       int8_matmul_tn_plain(x, g, fold, qs,
                                            out_dtype=torch.float32))
    g, w, fold, qs = _nt_case(cuda, 130, 257, 90, torch.float32)
    wk = im.kmajor_weight(w)
    assert tuple(wk.shape) == (90, 272) and not wk[:, 257:].any()
    g2, w2, fold2, qs2 = _nt_case(cuda, 130, 256, 90, torch.float32)
    assert im.kmajor_weight(w2) is w2
    buf = torch.zeros(90 * 256 + 1, dtype=torch.int8, device=cuda)
    w_off = buf[1:].view(90, 256)
    w_off.copy_(w2)
    assert w_off.data_ptr() % 16 and im.kmajor_weight(w_off) is not w_off
    assert torch.equal(int8_matmul_nt(g2, w_off, fold2, qs2),
                       int8_matmul_nt_plain(g2, w2, fold2, qs2))


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


def adamw_leaves(shapes, recipe, seed, device):
    """Leaves of the given shapes as the optimizer reads them (fp32 params
    and gradients, both moments quantized per leaf from random values);
    leaf 1's params start 4 bytes into their allocation, so the kernel
    takes that segment by its direct path."""
    from repro_torch.core.qadam import QState
    from repro_torch.core.quantizer import quantize_int
    rng = np.random.RandomState(seed)
    g, p, m1, m2 = [], [], [], []
    for i, sh in enumerate(shapes):
        n = int(np.prod(sh))
        buf = torch.from_numpy(rng.randn(n + 1).astype(np.float32)).to(device)
        p.append(buf[1:].view(sh) if i == 1 else buf[:n].view(sh).clone())
        g.append(torch.from_numpy(
            (rng.randn(*sh) * 1e-2).astype(np.float32)).to(device))
        v2 = rng.rand(*sh) * 1e-5
        v2 = np.sqrt(v2) if recipe.adam_m2.sqrt_domain else v2
        m1.append(QState(*(t.to(device) for t in quantize_int(
            torch.from_numpy((rng.randn(*sh) * 1e-3).astype(np.float32)),
            recipe.adam_m1))))
        m2.append(QState(*(t.to(device) for t in quantize_int(
            torch.from_numpy(v2.astype(np.float32)), recipe.adam_m2))))
    return g, p, m1, m2


def leaves_flat(out):
    p, m1, m2, _ = out
    return [*p, *(t for m in m1 for t in m), *(t for m in m2 for t in m)]


#: the leaves entry also at 32- and 256-wide rows: at 32 a consumer warp
#: holds 8 rows, so a part tile of 4 rows leaves half of it idle
LEAVES_RECIPES = ADAM_RECIPES + ["m1:8c-b32,m2:8c-asym-b32",
                                 "m1:8c-b256,m2:8c-asym-b256-sqrt"]


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", LEAVES_RECIPES)
def test_fused_adamw_leaves_kernel(cuda, recipe):
    """The leaves entry bit for bit against its plain version: a ragged
    leaf, one at a 4-byte offset (the direct path), aligned ones that
    stream through the ring (whole tiles and a part tile); a second step
    from the first's outputs (views into its bucket); a repeat
    bit-identical, the update-norm sum too."""
    rec = parse_recipe(recipe)
    sc = adamw_bucket(1, 64, rec, seed=0)[-1]
    kw = dict(m1_codec=codec_of(rec.adam_m1), m2_codec=codec_of(rec.adam_m2),
              weight_decay=True)
    shapes = [(130, 70), (96, 200), (12, 768, 64), (5000,), (64, 128)]
    g, p, m1, m2 = adamw_leaves(shapes, rec, seed=5, device=cuda)
    sc = sc.to(cuda)
    inputs = (g, p, m1, m2)
    for _ in range(2):
        before = fused_adamw_leaves.launches
        got = fused_adamw_leaves(*inputs, sc, **kw)
        assert fused_adamw_leaves.launches == before + 1
        want = fused_adamw_leaves_plain(*inputs, sc, **kw)
        for a, b in zip(leaves_flat(got), leaves_flat(want)):
            assert a.shape == b.shape and torch.equal(a, b)
        assert torch.isclose(got[3], want[3], rtol=1e-5, atol=0.0)
        again = fused_adamw_leaves(*inputs, sc, **kw)
        for a, b in zip(leaves_flat(again), leaves_flat(got)):
            assert torch.equal(a, b)
        assert torch.equal(again[3], got[3])
        inputs = (g, *got[:3])


@pytest.mark.cuda
def test_fused_adamw_leaves_over_launches(cuda, monkeypatch):
    """More leaves than a launch's table holds (2 here, 256 in the
    kernel): one launch a group, rows following each other, the partials
    summed in order; bit for bit against the plain version."""
    from repro_torch.kernels import opt_update
    monkeypatch.setattr(opt_update, "MAX_SEGMENTS", 2)
    rec = parse_recipe(ADAM_RECIPES[0])
    sc = adamw_bucket(1, 64, rec, seed=0)[-1].to(cuda)
    kw = dict(m1_codec=codec_of(rec.adam_m1), m2_codec=codec_of(rec.adam_m2),
              weight_decay=True)
    g, p, m1, m2 = adamw_leaves([(130, 70), (96, 200), (5000,), (64, 128),
                                 (33, 129)], rec, seed=8, device=cuda)
    got = fused_adamw_leaves(g, p, m1, m2, sc, **kw)
    want = fused_adamw_leaves_plain(g, p, m1, m2, sc, **kw)
    for a, b in zip(leaves_flat(got), leaves_flat(want)):
        assert torch.equal(a, b)
    assert torch.isclose(got[3], want[3], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_fused_adamw_blocks_unaligned_bucket(cuda):
    """A bucket whose tensors start 4 bytes into their allocations: the
    kernel takes every row by its direct path, in place."""
    rec = parse_recipe(ADAM_RECIPES[0])
    bucket = adamw_bucket(300, 128, rec, seed=9)
    off = []
    for t in bucket[:-1]:
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=cuda)
        view = buf[4 // t.element_size():][:t.numel()].view(t.shape)
        view.copy_(t.to(cuda))
        off.append(view)
    kw = dict(m1_codec=codec_of(rec.adam_m1), m2_codec=codec_of(rec.adam_m2),
              weight_decay=True)
    sc = bucket[-1].to(cuda)
    ref = [t.clone() for t in off]
    got = fused_adamw_blocks(*off, sc, **kw)
    want = fused_adamw_blocks_plain(*ref, sc, **kw)
    for a, b in zip(off[1:], ref[1:]):
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


#: qdq_row by width: rows up to 2 KB held in registers, up to 24 KB
#: streamed through shared memory, wider ones in two passes -- widths on
#: both sides of each limit (bf16 1024 / 1032 and 12288 / 12296, fp32 512
#: / 520 and 6144 / 6152 values), 1-8 rows to a stage, and narrow rows
QDQ_STREAM_WIDTHS = [8, 16, 512, 520, 1024, 1032, 1536, 3080, 6144, 6152,
                     12288, 12296]


@pytest.mark.cuda
@pytest.mark.parametrize("f", QDQ_STREAM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdq_row_stream_widths(cuda, f, dtype):
    """Bit for bit at every width the register, streaming, two-pass and
    element paths divide, with row counts off every tile multiple, ties,
    an all-zero row and a NaN row; a repeat bit-identical."""
    for rows in (37, 5):
        x = qdq_inputs(rows, f, 8, seed=f + rows).to(dtype).to(cuda)
        x[rows - 1, f // 2] = float("nan")
        got = qdq_row(x)
        torch.testing.assert_close(got, qdq_row_plain(x), rtol=0, atol=0,
                                   equal_nan=True)
        assert bool(got[rows - 1].isnan().all())
        torch.testing.assert_close(qdq_row(x), got, rtol=0, atol=0,
                                   equal_nan=True)


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
    (2, 130, 130, 256, True, 0), (1, 70, 70, 256, False, 0),
    (2, 200, 260, 96, True, 60), (2, 150, 150, 192, True, 0),
    (2, 140, 300, 224, False, 0), (2, 200, 200, 80, True, 0),
    (2, 180, 180, 112, False, 0), (2, 160, 600, 128, True, 440),
    (2, 300, 1024, 128, True, 0), (3, 1, 70, 64, True, 69),
    (3, 17, 17, 32, False, 0)])
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
def test_flash_bwd_routes_bf16_to_the_tensor_cores(cuda, monkeypatch):
    """The tensor-core backward exports the wrappers' head-dim limit, and a
    CUDA backward call loads the library ``bwd_library`` names: at bf16 and
    d <= 128 ``flash_bwd_sm90``, at float32 or d > 128 ``flash_attn``."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_bwd_sm90")
    assert lib.repro_flash_bwd_max_head_dim() == fa.FLASH_BWD_SM90_MAX_HEAD_DIM
    loaded = []
    real_load = _build.load
    monkeypatch.setattr(_build, "load",
                        lambda name: loaded.append(name) or real_load(name))
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                     (torch.bfloat16, 144), (torch.float32, 64)):
        q, k, v, do = _flash_inputs(cuda, 1, 64, 64, d, dtype, seed=d)
        loaded.clear()
        chip_smoke._flash_all(fa, q, k, v, do, True, 0)
        want = ("flash_bwd_sm90" if dtype == torch.bfloat16 and d <= 128
                else "flash_attn")
        assert loaded[-2:] == [want, want], (dtype, d, loaded)


@pytest.mark.cuda
def test_flash_kv_tile_is_the_kernels(cuda):
    """The plain forward rounds p against the running max of ``kv_tile(d)``
    keys; the bf16 kernel's tile (``repro_flash_kv_tile``) is the same at
    every head dim the wrappers take."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_fwd_sm90")
    for d in range(16, 257, 16):
        assert lib.repro_flash_kv_tile(d) == fa.kv_tile(d), d


@pytest.mark.cuda
def test_flash_kernels_reject_misaligned_tensors(cuda):
    """The bf16 forward reads q, k and v by TMA from 16-byte aligned bases:
    a contiguous view at an odd element offset is refused by every
    wrapper."""
    q = torch.randn(2, 64, 64, device=cuda, dtype=torch.bfloat16)
    buf = torch.randn(2 * 64 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    odd = buf[1:].view(2, 64, 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    for args in ((odd, q, q), (q, odd, q), (q, q, odd)):
        for fn in (fa.flash_attention_fwd, fa.flash_attention_fwd_lse):
            with pytest.raises(ValueError, match="16-byte"):
                fn(*args)
    o, lse = fa.flash_attention_fwd_lse(q, q, q)
    delta = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dq(odd, q, q, o, lse, delta)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dkdv(q, q, q, odd, lse, delta)


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


# ---------------------------------------------------------------------------
# the serving degradation ladder on the card
# ---------------------------------------------------------------------------

def _ladder_engine(cuda, policy="kv_cache=a8t,*=w8c+a8t@int8_cuda", **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.infer import Engine
    from repro_torch.models import build_model
    cfg = get_smoke_config("gpt2-small")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=cuda)
    return Engine(model, params, policy, max_slots=2, max_seq=64,
                  device=cuda, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("policy, libs", [
    ("kv_cache=a8t,*=w8c+a8t@int8_cuda",
     ["int8_matmul", "decode_attn", "flash_q8_sm90"]),
    ("kv_cache=a8n,*=w8c+a8t@int8_cuda", ["int8_matmul"])])
def test_engine_loads_rung0_libraries(cuda, monkeypatch, policy, libs):
    """The constructor loads (building if needed) every library rung 0
    launches, so a library that fails to load raises there and is never
    absorbed by the ladder as a failing decode step."""
    from repro_torch.kernels import _build
    loaded = []
    real = _build.load
    monkeypatch.setattr(_build, "load",
                        lambda name: loaded.append(name) or real(name))
    eng = _ladder_engine(cuda, policy)
    assert loaded == libs and eng.resilience_summary()["rung_index"] == 0

    def broken(name):
        raise RuntimeError(f"cannot load {name}")
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(RuntimeError, match="cannot load int8_matmul"):
        _ladder_engine(cuda, policy)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_engine_dequant_and_fused_rungs_serve(cuda, paged):
    """An a8t engine serves a short request on its fused rung (the decode
    kernel launches once a layer a step), forced onto the dequant rung it
    serves one without the decode kernel, and promoted back the kernel's
    launch count rises again."""
    from repro_torch import kernels
    from repro_torch.infer import Request
    kw = dict(paged=True, page_size=16) if paged else {}
    eng = _ladder_engine(cuda, **kw)
    name = "decode_attention_paged" if paged else "decode_attention"
    layers = eng.cfg.n_layers

    def serve():
        kernels.reset_launch_counts()
        eng.submit(Request(tokens=[1, 2, 3, 4], max_new_tokens=5))
        [r] = eng.run()
        assert r.finish_reason == "length" and len(r.tokens) == 5
        return kernels.launch_counts()
    counts = serve()
    assert counts[name] == 4 * layers
    assert counts["flash_attention_fwd_q8"] == layers
    assert eng._demote("test-forced", step=0)
    assert eng.path_summary().endswith("degraded=dequant(rung 1/2)")
    counts = serve()
    assert counts[name] == 0 and counts["flash_attention_fwd_q8"] == layers
    assert eng._try_promote(step=0) and eng._rung == 0
    counts = serve()
    assert counts[name] == 4 * layers


@pytest.mark.cuda
def test_engine_launch_failure_propagates(cuda, monkeypatch):
    """A decode kernel that fails on the card (any exception other than an
    injected ``FaultInjected``) propagates out of the step: no kernel
    error is recorded, no rung is left, and the plain rungs never serve
    around it."""
    import repro_torch.models.attention as attention
    from repro_torch.infer import Request

    def failing(*args, **kwargs):
        raise RuntimeError("decode_attention: launch failed")
    monkeypatch.setattr(attention, "decode_attention", failing)
    eng = _ladder_engine(cuda)
    eng.submit(Request(tokens=[1, 2, 3, 4], max_new_tokens=5))
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.run()
    s = eng.resilience_summary()
    assert (s["kernel_errors"], s["demotions"], s["rung_index"]) == (0, [], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["flash_pallas", "xla"])
def test_remat_on_and_off_on_the_card(cuda, impl):
    """A small llama config (yi-smoke's widths at 8 layers, 4 x 1024
    tokens, ``chip_smoke.TRAIN_POLICY``): recomputation on and off give
    bit-identical ce and gradients (the kernels use no float atomics), the
    peak above the weights is lower with it, and the launch counters count
    the recomputed launches (``chip_smoke.train_launches``)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke_config("yi-6b"), n_layers=8,
                              attention_impl=impl)
    params = build_model(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = chip_smoke._yi_tokens(torch, cuda, cfg, 4, 1024)
    # a first step allocates what stays (cuBLAS's workspace, the
    # libraries' buffers): keep it out of both peaks
    chip_smoke._loss_and_grads(torch, cfg, params, toks)
    on = chip_smoke._loss_and_grads(torch, cfg, params, toks)
    off_cfg = dataclasses.replace(cfg, remat=False)
    off = chip_smoke._loss_and_grads(torch, off_cfg, params, toks)
    assert chip_smoke._grads_distance(torch, on, off)[2]
    assert on[3] < off[3], (on[3], off[3])
    for got, c in ((on[2], cfg), (off[2], off_cfg)):
        assert got == dict(chip_smoke.train_launches(c),
                           fused_adamw_leaves=0)
