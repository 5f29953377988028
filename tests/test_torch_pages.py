"""Port parity of the paged KV cache: the host-side ``PagePool`` against the
JAX ``PagePool`` op for op, the pool geometry, and the plain version of
``decode_attention_paged`` (what its wrapper runs on CPU tensors) against
the JAX Pallas kernel in interpret mode and its gather reference
(``repro.kernels.ref.decode_attn_paged_ref``) on the same numpy inputs.

Tolerances: the context within 1e-5 of JAX (the bound of the JAX package's
own test, tests/test_pages.py, for its kernel against the reference; fp32
sums in another order); the written pools bit for bit outside the trash
page 0 (freed slots all write its row 0, in an order the kernel leaves
undefined) against the reference, whose codec runs eagerly -- the
interpret-mode kernel's scales may sit 1 ulp off its own eager codec, so
they are held to 1e-6 relative there, its payloads to the bit; and against the port's plain dense step on the same logical
cache, bit for bit in context and written rows.  The CUDA kernel is held
against this plain version and the dense kernel on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import parse_policy as jparse_policy
from repro.infer import (CapacityError as JCapacityError,
                         PagePool as JPagePool,
                         init_paged_caches as j_init_paged,
                         page_nbytes as j_page_nbytes, pages_for as j_pages_for)
from repro.kernels.decode_attn import decode_attention_paged as j_paged
from repro.kernels.ref import (decode_attn_inputs, decode_attn_paged_ref,
                               paged_from_dense)

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core.qpolicy import parse_policy
from repro_torch.infer import (CapacityError, PagePool, init_paged_caches,
                               page_nbytes, pages_for)
from repro_torch.kernels import decode_attention_paged
from repro_torch.kernels.decode_attn import (decode_attention_paged_plain,
                                             decode_attention_plain,
                                             decode_kv_read_bytes,
                                             effective_block_k)


def _capacity_fields(e):
    return {k: getattr(e, k) for k in (
        "tokens", "max_seq", "page_size", "pages_needed", "pages_total",
        "pages_free", "slots_total", "slots_free")}


def _pool_state(p):
    return (p.table.tolist(), p.refcount.tolist(), p.used.tolist(),
            list(p._free), p.free_pages, p.live_pages)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_op_for_op(seed):
    """A seeded random sequence of alloc/assign, share, append, pin,
    release and release_slot drives both pools; tables, refcounts, pages
    per slot and the free list agree after every op, and so do the
    CapacityError fields of every refused allocation."""
    rng = np.random.RandomState(seed)
    kw = dict(n_pages=12, page_size=4, max_slots=3, max_pages_per_slot=5)
    pools = (JPagePool(**kw), PagePool(**kw))
    pinned = []
    refused = 0
    for _ in range(400):
        op, slot = rng.randint(6), rng.randint(3)
        used = int(pools[1].used[slot])
        other = int(rng.randint(3))
        if op == 0 and used == 0:
            n = int(rng.randint(1, 6))
            out = []
            for p in pools:
                try:
                    pids = p.alloc(n)
                    p.assign(slot, pids)
                    out.append(pids)
                except (CapacityError, JCapacityError) as e:
                    out.append(_capacity_fields(e))
            refused += isinstance(out[1], dict)
            assert out[0] == out[1]
        elif op == 1 and used == 0 and other != slot \
                and pools[1].used[other] > 0:
            for p in pools:
                p.assign(slot, p.share(p.slot_pages(other)))
        elif op == 2 and 0 < used < kw["max_pages_per_slot"]:
            out = []
            for p in pools:
                try:
                    p.append(slot, p.alloc(1)[0])
                    out.append(None)
                except (CapacityError, JCapacityError) as e:
                    out.append(_capacity_fields(e))
            assert out[0] == out[1]
        elif op == 3:
            assert pools[0].release_slot(slot) == pools[1].release_slot(slot)
        elif op == 4 and used > 0:
            pids = pools[1].slot_pages(slot)[:1]
            for p in pools:
                p.pin(pids)
            pinned.append(pids)
        elif op == 5 and pinned:
            pids = pinned.pop(int(rng.randint(len(pinned))))
            for p in pools:
                p.release(pids)
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        for s in range(kw["max_slots"]):
            assert pools[0].slot_pages(s) == pools[1].slot_pages(s)
    assert refused > 0
    assert torch.equal(pools[1].table_array(),
                       torch.from_numpy(np.array(pools[0].table_array())))
    assert pools[1].table_array().dtype == torch.int32


def test_pages_for_and_page_nbytes():
    assert [pages_for(n, 4) for n in range(1, 20)] == \
        [j_pages_for(n, 4) for n in range(1, 20)]
    jcfg = dataclasses.replace(get_smoke_config("gpt2-small"),
                               dtype="float32")
    tcfg = dataclasses.replace(tsmoke("gpt2-small"), dtype="float32")
    for pol in ("*=w8c", "kv_cache=a8t,*=w8c"):
        jc = j_init_paged(jcfg, 3, 4, jnp.float32,
                          kv_spec=jparse_policy(pol).kv_spec())
        tc = init_paged_caches(tcfg, 3, 4, torch.float32,
                               kv_spec=parse_policy(pol).kv_spec())
        assert sorted(jc) == sorted(tc)
        for k in jc:
            assert tuple(jc[k].shape) == tuple(tc[k].shape)
            assert str(jc[k].dtype) == str(tc[k].dtype).replace("torch.", "")
            assert not bool(tc[k].any())
        assert page_nbytes(tc) == j_page_nbytes(jc)
    with pytest.raises(ValueError, match="trash page"):
        PagePool(n_pages=1, page_size=4, max_slots=1, max_pages_per_slot=1)


def test_tile_rule_and_read_bytes_match_the_reference():
    from repro.kernels.decode_attn import decode_kv_read_bytes as j_bytes
    from repro.kernels.decode_attn import effective_block_k as j_block
    for s in (24, 32, 100, 1024, 4096):
        for bk in (None, 8, 64, 256, 512):
            assert effective_block_k(s, bk) == j_block(s, bk)
    for mode in ("fp", "dequant", "fused"):
        assert (decode_kv_read_bytes(mode, 3, 40, 4, 32, n_layers=2,
                                     fp_bytes=4)
                == j_bytes(mode, 3, 40, 4, 32, n_layers=2, fp_bytes=4))


def _paged_case(page, g, seed, hd=32):
    """Ragged logical caches of 32 rows (B = 4, K = 2, hd = 32 unless
    given) re-laid as shuffled pools with a spare page; slot 0 is a freed
    slot (pos 0, a table row of trash-page entries), slot 3 is full (pos
    == maxp * page, the clamped write).  Returns numpy (q, kq, ks, vq, vs, new_k, new_v,
    pos, pools..., table)."""
    b, s, kh = 4, 32, 2
    lengths = [0, 5, 17, 32]
    (q, kq, ks, vq, vs, _, _, nk, nv, pos) = decode_attn_inputs(
        b, s, kh, g, hd, lengths, seed=seed)
    pools = paged_from_dense(kq, ks, vq, vs, lengths, page, seed=seed + 11)
    table = np.array(pools[4])
    table[0] = 0
    dense = [np.asarray(x) for x in (q, kq, ks, vq, vs, nk, nv, pos)]
    return dense, [np.asarray(x) for x in pools[:4]], table


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("hd", [32, 256])                     # 256: gemma
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_plain_matches_jax(page, g, hd):
    (q, kq, ks, vq, vs, nk, nv, pos), pools, table = _paged_case(
        page, g, seed=page + g, hd=hd)
    jout = j_paged(*(jnp.asarray(x) for x in (q, *pools, nk, nv, pos,
                                              table)), interpret=True)
    tpools = _t(pools)
    before = decode_attention_paged.launches
    ctx = decode_attention_paged(*_t([q]), *tpools, *_t([nk, nv, pos, table]))
    assert decode_attention_paged.launches == before       # CPU: plain
    d = np.abs(ctx.numpy() - np.asarray(jout[0])).max()
    assert d <= 1e-5, d
    # payloads bit for bit; the kernel's own absmax / qmax may come out of
    # interpret-mode XLA 1 ulp off (as for the dense kernel in
    # test_torch_kernels.py), so its scales are held to 1e-6 relative and
    # the reference's eager codec to the bit
    for i, (got, want) in enumerate(zip(tpools, jout[1:])):
        got, want = got.numpy()[1:], np.asarray(want)[1:]
        if i % 2 == 0:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the gather reference attends the overwritten last row in place of
    # the new one at pos == maxp * page, so its context is held on the
    # other slots; its written pools bit for bit
    rctx, rpools = decode_attn_paged_ref(
        *(jnp.asarray(x) for x in (q, *pools, nk, nv, pos, table)))
    d = np.abs(ctx.numpy()[:3] - np.asarray(rctx)[:3]).max()
    assert d <= 1e-5, d
    for got, want in zip(tpools, rpools):
        assert np.array_equal(got.numpy()[1:], np.asarray(want)[1:])


@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_plain_equals_dense_plain(page, dtype):
    """On the same logical cache the paged step and the dense step give
    the same context and write the same rows, bit for bit."""
    (q, kq, ks, vq, vs, nk, nv, pos), pools, table = _paged_case(page, 2,
                                                                 seed=page)
    q, nk, nv = (x.to(dtype) for x in _t([q, nk, nv]))
    dense = _t([kq, ks, vq, vs])
    tpools = _t(pools)
    pos_t, table_t = _t([pos, table])
    want = decode_attention_plain(q, *dense, nk, nv, pos_t)
    got = decode_attention_paged_plain(q, *tpools, nk, nv, pos_t, table_t)
    assert got.dtype == dtype and torch.equal(got, want)
    at = pos_t.long().clamp(max=31)
    for b in range(1, 4):                    # slot 0 wrote the trash page
        pid = int(table_t[b, at[b] // page])
        for d_buf, p_buf in zip(dense, tpools):
            assert torch.equal(p_buf[pid, at[b] % page], d_buf[b, at[b]])


def test_paged_wrapper_rejects_mismatched_shapes():
    (q, kq, ks, vq, vs, nk, nv, pos), pools, table = _paged_case(8, 1, 0)
    args = _t([q, *pools, nk, nv, pos])
    with pytest.raises(ValueError, match="decode_attention_paged"):
        decode_attention_paged(*args, torch.zeros((3, 4), dtype=torch.int32))
    bad = torch.zeros((5, 8, 3, 32), dtype=torch.int8)    # 3 kv heads, not 2
    with pytest.raises(ValueError, match="decode_attention_paged"):
        decode_attention_paged(args[0], bad, *args[2:], *_t([table]))
