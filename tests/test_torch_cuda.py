"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible (the kernels have no CPU mode); on a machine with a card, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: ``int8_matmul`` bit for bit; the attention kernels within 1e-5
of the plain version at the float32 carrier (fp32 sums in another order),
within one bfloat16 rounding step at the bfloat16 carrier (two fp32 values
a few ulp apart can round to neighbouring bf16 values), and the decode
step's written cache rows bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.qconfig import Granularity, QuantSpec
from repro_torch.core.quantizer import quantize_int
from repro_torch.kernels import (decode_attention, flash_attention_fwd_q8,
                                 int8_matmul)
from repro_torch.kernels.decode_attn import decode_attention_plain
from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
from repro_torch.kernels.int8_matmul import int8_matmul_plain

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
