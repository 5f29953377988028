#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build the five CUDA kernel libraries from ``src/repro_torch/csrc`` (one
   nvcc per source, all at once; ``decode_attn.cu`` holds the dense and the
   paged decode kernels) and print the build time;
2. print the card's name and power limit (nvidia-smi);
3. hold each serving kernel against its plain PyTorch version on the card
   at the serving path's shapes, and time kernel, plain version and a
   library yardstick (``torch._int_mm``; SDPA on dequantized K/V) beside
   the bound computed from the inputs' bytes and operations; 3b. the paged
   decode kernel the same way at pages of 16, 64 and 256 rows, and bit for
   bit against the dense decode kernel on the same logical cache
   (``check_decode_attention_paged``);
4. serve GPT-2 small (random weights from ``--seed``, bf16 carrier, W8A8
   prepared weights, int8 KV cache) through the continuous-batching engine:
   32 requests, prompts of 32-512 tokens, 64 new tokens each, 16 slots of
   1024 rows; every kernel must have launched, as often as the engine's
   prefill and decode counts say; 4b. the same requests through the paged
   engine (pages of 64 rows) under the async scheduler, arriving with
   exponential gaps: phase 4's tokens, the paged kernel's launch counts,
   peak live KV below the dense cache, every page back (``serve_paged``);
   4c. preemption under a 24-page pool and prefix sharing
   (``serve_paged_pressure``);
5. teacher-forced logits of the card against the CPU (plain versions) at
   the float32 carrier on the same weights, and of the card with the
   plain ``int8_matmul`` in the kernel's place (see ``card_vs_cpu`` for
   the policies, the weights and the limits);
6. hold the training kernels against their plain versions at the training
   path's shapes -- ``int8_matmul_nt`` and ``int8_matmul_tn`` bit for bit
   at M = 8192 tokens, ``fused_adamw_blocks`` on a bucket of GPT-2 small's
   size (bit for bit in params, payloads and scales) -- and time each
   beside its bound, its plain version and a yardstick (``torch._int_mm``
   on int8 operands of the same contraction; none for AdamW);
7. train GPT-2 small at full width and depth (random weights from
   ``--seed``, bf16 carrier, 8 x 1024 tokens a step from the port's
   synthetic corpus, the paper's W8/A8/G8 recipe on the int8 kernels with
   blockwise 8-bit Adam moments) for 10 steps: ce, grad norm and ms per
   step, tokens/s, peak memory and, over one profiled step, the device's
   idle share; every ce and grad norm must be finite and each training
   kernel must launch exactly 72 / 72 / 72 / 1 times a step (and the
   serving kernels never);
8. one train step on gpt2-mini, card against CPU (see
   ``train_card_vs_cpu`` for the checks and their limits).

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside it, it exits with 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
POLICY = "kv_cache=a8t,*=w8c+a8t@int8_cuda"
# H100 SXM published peaks (NVIDIA data sheet), dense: HBM3 bytes/s, int8
# tensor-core ops/s, fp32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
SERVE_KERNELS = ("int8_matmul", "flash_attention_fwd_q8", "decode_attention")
TRAIN_KERNELS = ("int8_matmul_nt", "int8_matmul_tn", "fused_adamw_blocks")
KERNEL_NAMES = SERVE_KERNELS + TRAIN_KERNELS + ("decode_attention_paged",)
#: phases 4 and 4b: 32 requests, prompts of 32-512 tokens, 64 new tokens
#: each, 16 slots of 1024 rows; 4b's pages hold 64 rows, its requests
#: arrive with exponential gaps of this mean
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_SEQ = 32, 64, 16, 1024
PAGE, ARRIVAL_MEAN_S = 64, 0.02
#: the training path's policy: paper Section 4.5's W8/A8/G8 on the int8
#: kernels, Adam moments stored blockwise in 8 bits
TRAIN_POLICY = "*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda"
TRAIN_STEPS = 10
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# phase 5, policy B: limit on max |d logit| of the card against the CPU, set
# from the readings recorded in PERF.md (not sized at run time)
B_LIMIT = 0.1
# phase 8, A: limits of the card against the CPU for one train step, set
# from the readings at seeds 0-5 recorded in PERF.md (not sized at run
# time): |d ce| (readings 1.0e-5 to 1.1e-4), the gradients' relative L2
# distance (1.0e-2 to 1.4e-2), the share of elements whose gradient sign
# differs (2.6e-3 to 4.0e-3) and the parameter updates' relative L2 distance
# where the sign agrees (5.3e-3 to 5.8e-3).  Adam's first step is nearly
# sign(g), so each sign flip moves its update by about 2 lr and the updates
# as a whole part by about 2 sqrt(share): 9.6e-2 to 1.22e-1, held to
# 2 sqrt(1e-2), the sign-flip limit's worth.
TRAIN_LIMITS = {"ce": 1e-3, "grads": 5e-2, "sign_flips": 1e-2,
                "updates_sign": 2e-2, "updates": 0.2}


def bound_ms(nbytes: float, ops: float, rate: float):
    """Least time for the work: the larger of bytes over memory rate and
    operations over peak rate; returns (ms, 'bytes' | 'operations')."""
    t_mem, t_ops = nbytes / HBM_BPS, ops / rate
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check_int8_matmul(torch, dev, gen, results):
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain
    rows = []
    for m in (16, 2048):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            rs = torch.rand((m, 1), generator=gen, device=dev) * 0.05
            cs = torch.rand((1, n), generator=gen, device=dev) * 0.01
            got = int8_matmul(x, w, rs, cs, out_dtype=torch.bfloat16)
            want = int8_matmul_plain(x, w, rs, cs, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                fail(f"int8_matmul M={m} K={k} N={n} not bit-exact "
                     f"(max err {err})")
            ms = time_ms(lambda: int8_matmul(x, w, rs, cs))
            plain = time_ms(lambda: int8_matmul_plain(x, w, rs, cs), iters=5)
            # torch._int_mm (int8 x int8 -> int32, no epilogue) takes M > 16
            lib = (time_ms(lambda: torch._int_mm(x, w)) if m > 16 else None)
            b, by = bound_ms(m * k + k * n + 4 * (m + n) + 2 * m * n,
                             2.0 * m * n * k, INT8_OPS)
            rows.append(dict(shape=f"M={m},K={k},N={n}", max_abs_err=err,
                             ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=lib))
            print(f"int8_matmul M={m:5d} K={k:4d} N={n:4d}: bit-exact "
                  f"(tol 0), ms {ms:.4f}, plain_ms {plain:.4f}, bound_ms "
                  f"{b:.5f} ({by}), library_ms(_int_mm) "
                  f"{'n/a (M<=16)' if lib is None else f'{lib:.4f}'}")
    # the JSON entry reports the shape with the most launches on the main
    # path: the decode step's wq, wk, wv and wo at M = 16 slots (4 of every
    # 6 decode launches); kernels.json keeps every shape
    results["int8_matmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:84", tol=0.0,
        shapes=rows, **rows[0])


def _int8_cache(torch, dev, gen, b, s, kh, hd, lengths):
    """Ragged int8 cache: rows < lengths[i] hold quantized random K/V, the
    rest the never-written state (payload 0, scale 0)."""
    from repro_torch.core.qconfig import Granularity, QuantSpec
    from repro_torch.core.quantizer import quantize_int
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    valid = (torch.arange(s, device=dev)[None, :, None, None]
             < torch.as_tensor(lengths, device=dev)[:, None, None, None])
    out = []
    for _ in range(2):
        q, sc, _ = quantize_int(torch.randn((b, s, kh, hd), generator=gen,
                                            device=dev), spec)
        out += [torch.where(valid, q, torch.zeros_like(q)).contiguous(),
                torch.where(valid, sc, torch.zeros_like(sc)).contiguous()]
    return out        # kq, ks, vq, vs


def attention_err(torch, got, want) -> float:
    """Max |kernel - plain| of an attention output.  At the float32 carrier
    the caller holds it to the stated tolerance; at bfloat16 two fp32
    results a few ulp apart may round to neighbouring bf16 values, so each
    element must be within one bf16 rounding step (or 1e-5, where
    cancellation leaves a value too small for that step to cover fp32
    noise)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    d = (g - w).abs()
    step = torch.clamp(torch.maximum(g.abs(), w.abs()) * 2.0 ** -7, min=1e-5)
    if got.dtype == torch.bfloat16 and not bool((d <= step).all()):
        fail(f"bf16 attention output off by more than one bf16 step "
             f"(max err {d.max().item()})")
    return d.max().item()


def _dequant(torch, q, s):
    from repro_torch.kernels.int8_matmul import scale_guard
    return q.float() * scale_guard(s)


def check_decode_attention(torch, dev, gen, results):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_plain)
    b, s, kh, g, hd = 16, 1024, 12, 1, 64
    pos = torch.randint(1, s, (b,), generator=gen, device=dev)
    pos[0], pos[1] = 0, s
    pos = pos.to(torch.int32)
    cache = _int8_cache(torch, dev, gen, b, s, kh, hd, pos)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).bfloat16()
    nk = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    nv = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        kc = [t.clone() for t in cache]
        pc = [t.clone() for t in cache]
        args = [t.to(dt) for t in (q, nk, nv)]
        got = decode_attention(args[0], *kc, *args[1:], pos)
        want = decode_attention_plain(args[0], *pc, *args[1:], pos)
        errs[dt] = attention_err(torch, got, want)
        for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, pc):
            if not torch.equal(a, c):
                fail(f"decode_attention written cache {name} not bit-exact "
                     f"({dt})")
    err, tol = errs[torch.float32], 1e-3
    ms = time_ms(lambda: decode_attention(q, *kc, nk, nv, pos))
    plain = time_ms(lambda: decode_attention_plain(q, *pc, nk, nv, pos),
                    iters=5)
    # yardstick: SDPA over K/V dequantized beforehand (not timed)
    kd = _dequant(torch, cache[0], cache[1]).bfloat16().permute(0, 2, 1, 3)
    vd = _dequant(torch, cache[2], cache[3]).bfloat16().permute(0, 2, 1, 3)
    qs = q.reshape(b, kh * g, 1, hd)
    mask = (torch.arange(s, device=dev)[None, :] < pos[:, None].clamp(min=1)
            )[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(qs, kd, vd,
                                                         attn_mask=mask))
    rows = pos.clamp(0, s).long()
    row_bytes = kh * (hd + 4)
    nbytes = (2 * int(rows.sum()) * row_bytes + 2 * q.numel() * 2
              + 2 * nk.numel() * 2 + 2 * b * row_bytes + 4 * b)
    ops = 4.0 * hd * g * kh * float((rows + 1).sum())
    bd, by = bound_ms(nbytes, ops, FP32_FLOPS)
    print(f"decode_attention B={b} S={s} K={kh} G={g} hd={hd} pos "
          f"[0, {s}, ragged]: ctx max err {err:.2e} (tol {tol}, fp32 "
          f"carrier, bf16-valued inputs), bf16 carrier within one bf16 "
          f"step (max err {errs[torch.bfloat16]:.2e}), "
          f"written rows bit-exact, ms {ms:.4f}, plain_ms {plain:.4f}, "
          f"bound_ms {bd:.5f} ({by}), library_ms(SDPA) {lib:.4f}")
    results["decode_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:250", tol=tol,
        shape=f"B={b},S={s},K={kh},G={g},hd={hd}", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


def paged_from_dense(torch, dense, lengths, page, seed):
    """Re-lay dense (B, S, K, x) caches as page pools and a (B, S / page)
    table (a torch copy of repro/kernels/ref.py:paged_from_dense): slot
    b's first min(maxp, ceil(len / page) + 1) logical pages go to pages in
    an order shuffled by ``seed``, one spare page pads the pool, the rest
    of the table points at the trash page 0."""
    import numpy as np
    b, s = dense[0].shape[:2]
    maxp = s // page
    need = [min(maxp, -(-int(n) // page) + 1) for n in lengths]
    total = 1 + sum(need) + 1
    order = list(np.random.RandomState(seed).permutation(np.arange(1, total)))
    table = np.zeros((b, maxp), np.int32)
    bi, ji, pid = [], [], []
    for i in range(b):
        for j in range(need[i]):
            table[i, j] = order.pop()
            bi.append(i), ji.append(j), pid.append(int(table[i, j]))
    pools = []
    for t in dense:
        pool = torch.zeros((total, page) + tuple(t.shape[2:]), dtype=t.dtype,
                           device=t.device)
        pool[pid] = t.reshape(b, maxp, page, *t.shape[2:])[bi, ji]
        pools.append(pool)
    return pools, torch.from_numpy(table).to(dense[0].device)


def check_decode_attention_paged(torch, dev, gen, results):
    """Phase 3b: #13 at GPT-2 small's decode widths (16 slots, a logical
    cache of 1024 rows, 12 kv heads of 64) over shuffled pools of pages of
    16, 64 (the serving phases' page) and 256 rows, ragged positions with a
    freed slot (pos 0, a table row of trash-page entries) and a full one
    (pos == maxp * page, the clamped write).  (a) Against its plain version
    at both carriers: ctx within 1e-3 at float32 (within one bf16 step at
    bfloat16), the written pools bit for bit outside the trash page.
    (b) Against #12 on the source dense cache: ctx and the written rows at
    their logical positions bit for bit."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_paged,
                                                 decode_attention_paged_plain,
                                                 paged_logical_view)
    b, s, kh, g, hd = 16, 1024, 12, 1, 64
    pos = torch.randint(1, s, (b,), generator=gen, device=dev)
    pos[0], pos[1] = 0, s
    pos = pos.to(torch.int32)
    dense = _int8_cache(torch, dev, gen, b, s, kh, hd, pos)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).bfloat16()
    nk = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    nv = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    rows = pos.clamp(0, s).long()
    live = torch.arange(1, b, device=dev)            # slot 0: the trash page
    at = rows.clamp(max=s - 1)[1:]
    rows_out = []
    for page in (16, PAGE, 256):
        pools, table = paged_from_dense(torch, dense, pos.tolist(), page,
                                        seed=page)
        table[0] = 0
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            args = [t.to(dt) for t in (q, nk, nv)]
            kc = [t.clone() for t in pools]
            pc = [t.clone() for t in pools]
            got = decode_attention_paged(args[0], *kc, *args[1:], pos, table)
            want = decode_attention_paged_plain(args[0], *pc, *args[1:], pos,
                                                table)
            errs[dt] = attention_err(torch, got, want)
            for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, pc):
                if not torch.equal(a[1:], c[1:]):
                    fail(f"decode_attention_paged page {page}: written pool "
                         f"{name} not bit-exact against the plain version "
                         f"({dt})")
            dc = [t.clone() for t in dense]
            kc = [t.clone() for t in pools]
            dctx = decode_attention(args[0], *dc, *args[1:], pos)
            pctx = decode_attention_paged(args[0], *kc, *args[1:], pos, table)
            torch.cuda.synchronize()
            if not torch.equal(dctx, pctx):
                fail(f"decode_attention_paged page {page} ({dt}): ctx differs "
                     f"from decode_attention on the same logical cache (max "
                     f"{(dctx.float() - pctx.float()).abs().max().item()})")
            pid = table[live, at // page].long()
            for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, dc):
                if not torch.equal(a[pid, at % page], c[live, at]):
                    fail(f"decode_attention_paged page {page} ({dt}): written "
                         f"rows of {name} differ from decode_attention's")
        err, tol = errs[torch.float32], 1e-3
        if not err <= tol:
            fail(f"decode_attention_paged page {page}: ctx max err {err} "
                 f"> {tol}")
        kc = [t.clone() for t in pools]
        pc = [t.clone() for t in pools]
        ms = time_ms(lambda: decode_attention_paged(q, *kc, nk, nv, pos,
                                                    table))
        plain = time_ms(lambda: decode_attention_paged_plain(
            q, *pc, nk, nv, pos, table), iters=5)
        # yardstick: SDPA over the gathered K/V, dequantized beforehand
        # (neither the gather nor the dequantization is timed)
        view = [paged_logical_view(t, table) for t in pools]
        kd = _dequant(torch, view[0], view[1]).bfloat16().permute(0, 2, 1, 3)
        vd = _dequant(torch, view[2], view[3]).bfloat16().permute(0, 2, 1, 3)
        qs = q.reshape(b, kh * g, 1, hd)
        mask = (torch.arange(s, device=dev)[None, :]
                < pos[:, None].clamp(min=1))[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask))
        row_bytes = kh * (hd + 4)
        nbytes = (2 * int(rows.sum()) * row_bytes + 2 * q.numel() * 2
                  + 2 * nk.numel() * 2 + 2 * b * row_bytes + 4 * b
                  + 4 * table.numel())
        ops = 4.0 * hd * g * kh * float((rows + 1).sum())
        bd, by = bound_ms(nbytes, ops, FP32_FLOPS)
        print(f"decode_attention_paged B={b} S={s} page={page} K={kh} G={g} "
              f"hd={hd} pos [0 (trash slot), {s}, ragged]: ctx max err "
              f"{err:.2e} (tol {tol}, fp32 carrier), bf16 carrier within one "
              f"bf16 step (max err {errs[torch.bfloat16]:.2e}), written pools "
              f"bit-exact outside page 0; ctx and written rows bit-identical "
              f"to decode_attention on the dense cache (both carriers); ms "
              f"{ms:.4f}, plain_ms {plain:.4f}, bound_ms {bd:.5f} ({by}), "
              f"library_ms(SDPA) {lib:.4f}")
        rows_out.append(dict(shape=f"B={b},S={s},page={page},K={kh},G={g},"
                             f"hd={hd}", max_abs_err=err, ms=ms,
                             plain_ms=plain, bound_ms=bd, bound_by=by,
                             library_ms=lib))
    # the JSON entry reports the serving phases' page of 64 rows
    results["decode_attention_paged"] = dict(
        route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:374", tol=1e-3,
        shapes=rows_out, **rows_out[1])


def check_flash_q8(torch, dev, gen, results):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (flash_attention_fwd_q8,
                                                flash_attention_fwd_q8_plain)
    b, sq, skv, h, kh, hd = 4, 256, 1024, 12, 12, 64
    kq, ks, vq, vs = _int8_cache(torch, dev, gen, b, skv, kh, hd, [sq] * b)
    q = torch.randn((b, sq, h, hd), generator=gen, device=dev).bfloat16()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        got = flash_attention_fwd_q8(q.to(dt), kq, ks, vq, vs, causal=True)
        want = flash_attention_fwd_q8_plain(q.to(dt), kq, ks, vq, vs,
                                            causal=True)
        errs[dt] = attention_err(torch, got, want)
    err, tol = errs[torch.float32], 1e-3
    ms = time_ms(lambda: flash_attention_fwd_q8(q, kq, ks, vq, vs))
    plain = time_ms(lambda: flash_attention_fwd_q8_plain(q, kq, ks, vq, vs),
                    iters=5)
    kd = _dequant(torch, kq, ks).bfloat16().permute(0, 2, 1, 3)
    vd = _dequant(torch, vq, vs).bfloat16().permute(0, 2, 1, 3)
    qt = q.permute(0, 2, 1, 3)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                         is_causal=True))
    visible = min(skv, sq)                   # q_offset 0: causal rows
    nbytes = (2 * q.numel() * 2 + 2 * b * visible * kh * (hd + 4))
    ops = 4.0 * hd * b * h * (sq * (sq + 1) / 2)
    bd, by = bound_ms(nbytes, ops, FP32_FLOPS)
    print(f"flash_attention_fwd_q8 B={b} Sq={sq} Skv={skv} H={h} hd={hd} "
          f"causal: max err {err:.2e} (tol {tol}, fp32 carrier, bf16-valued "
          f"inputs), bf16 carrier within one bf16 step (max err "
          f"{errs[torch.bfloat16]:.2e}), ms {ms:.4f}, "
          f"plain_ms {plain:.4f}, bound_ms {bd:.5f} ({by}), "
          f"library_ms(SDPA) {lib:.4f}")
    results["flash_attention_fwd_q8"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_attn_q8.cu",
        replaces="src/repro/kernels/flash_attn.py:468", tol=tol,
        shape=f"B={b},Sq={sq},Skv={skv},H={h},hd={hd}", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


def serve_model(torch, dev, seed):
    """GPT-2 small at full width and depth, random weights from ``seed``:
    (cfg, model, params) of phases 4, 4b and 4c."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("gpt2-small")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    return cfg, model, params


def serve_prompts(cfg, seed):
    """The 32 prompts of phases 4 and 4b (32-512 tokens), drawn from
    ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(32, 513, size=SERVE_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def serve(torch, dev, seed):
    """Phase 4: the dense engine on GPT-2 small; returns the launch counts,
    each request's tokens and the engine's KV bytes."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.infer import Engine, Request
    cfg, model, params = serve_model(torch, dev, seed)
    eng = Engine(model, params, POLICY, max_slots=SERVE_SLOTS,
                 max_seq=SERVE_SEQ, device=dev, seed=seed)
    prompts = serve_prompts(cfg, seed)
    lens = np.asarray([len(p) for p in prompts])
    new = SERVE_NEW
    ids = [eng.submit(Request(tokens=p, max_new_tokens=new))
           for p in prompts]
    rng = np.random.RandomState(seed + 3)
    print(f"engine: {eng.path_summary()}, {cfg.name} {cfg.n_layers}L "
          f"d={cfg.d_model} carrier {cfg.dtype}, 16 slots x 1024 rows, "
          f"{len(ids)} requests, prompts {lens.min()}-{lens.max()} tokens, "
          f"{new} new tokens each")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = eng.stats
    if sorted(r.request_id for r in out) != sorted(ids):
        fail("engine did not answer every request")
    for r in out:
        if (len(r.tokens) != new or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    lat = eng.scheduler.latency_stats()
    gen_tok = sum(len(r.tokens) for r in out)
    print(f"engine: {len(out)} requests served, {gen_tok} tokens in "
          f"{wall:.3f} s ({gen_tok / wall:.1f} tok/s end to end); prefill "
          f"{st['prefill_calls']} launches {st['prefill_s'] * 1e3:.1f} ms "
          f"({st['prefill_tokens']} prompt tokens); decode "
          f"{st['decode_steps']} steps {st['decode_s'] * 1e3:.1f} ms "
          f"({st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} "
          f"ms/step, {st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} "
          f"tok/s); latency p50 {lat['p50_s']:.3f} s p99 {lat['p99_s']:.3f} s")
    print(f"engine: launch counts {counts}")
    linears = 6 * cfg.n_layers
    want = {"int8_matmul": linears * (st["prefill_calls"] + st["decode_steps"]),
            "flash_attention_fwd_q8": cfg.n_layers * st["prefill_calls"],
            "decode_attention": cfg.n_layers * st["decode_steps"]}
    for name, n in want.items():
        if counts[name] <= 0 or counts[name] != n:
            fail(f"{name} launched {counts[name]} times on the main path, "
                 f"expected {n}")
    if counts["decode_attention_paged"]:
        fail("the dense engine launched decode_attention_paged")
    tokens = {r.request_id: r.tokens for r in out}
    dense_bytes, stats = eng.kv_cache_nbytes(), dict(st)
    profile_decode(torch, eng, cfg, rng)
    eng.scheduler.stop()          # ends the emit thread, which holds eng
    return counts, [tokens[i] for i in ids], dense_bytes, stats


def profile_decode(torch, eng, cfg, rng) -> None:
    """Where a decode step's time goes: torch.profiler over 4 steps with
    every slot live (16 fresh 64-token requests, admitted outside the
    window, stepped on this thread); device time by kernel and the device's
    idle share of the steps' wall time.  Runs after the main path's launch
    counts are read (phases 4 and 4b)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.infer import Request
    for _ in range(eng.max_slots):
        eng.submit(Request(tokens=rng.randint(0, cfg.vocab_size, 64).tolist(),
                           max_new_tokens=8))
    eng.scheduler.step()                     # prefill + one decode step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.scheduler.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(k[1] for k in kern)
    if not busy:
        print("profile: no device time recorded (not measured)")
        return
    kern.sort(key=lambda k: -k[1])
    print(f"profile: {'paged' if eng.paged else 'dense'} engine, 4 decode "
          f"steps x 16 slots, wall {wall_us / 4e3:.2f} ms/step, "
          f"device busy {busy / 4e3:.2f} ms/step, idle share "
          f"{1 - busy / wall_us:.3f}, {sum(k[2] for k in kern) / 4:.0f} "
          f"kernel launches/step")
    for name, us, n in kern[:8]:
        print(f"profile:   {us / 4e3:8.3f} ms/step {n // 4:5d} launches/step "
              f"{name[:90]}")


def serve_paged(torch, dev, seed, dense_tokens, dense_bytes, dense_stats):
    """Phase 4b: the paged engine (pages of 64 rows, the default pool of
    1 + 16 x 16 pages) under the async scheduler, on the weights and the
    32 requests of phase 4, submitted from this thread with exponential
    gaps (mean 20 ms) while the background loop serves.  Every request
    must be answered to length with phase 4's tokens; the counts must show
    the paged path (12 ``decode_attention_paged`` a decode step, no
    ``decode_attention``); the peak live KV must stay below the dense
    cache; every page must be back after ``stop()``.  Returns the counts."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.infer import Engine, Request
    cfg, model, params = serve_model(torch, dev, seed)
    eng = Engine(model, params, POLICY, max_slots=SERVE_SLOTS,
                 max_seq=SERVE_SEQ, device=dev, seed=seed, paged=True,
                 page_size=PAGE)
    prompts = serve_prompts(cfg, seed)
    gaps = np.random.RandomState(seed + 1).exponential(ARRIVAL_MEAN_S,
                                                       size=len(prompts))
    groups = []                  # request ids of each prefill launch
    admit = eng._admit_paged

    def logged(selected, shares):
        groups.append([r.request_id for r in selected])
        return admit(selected, shares)
    eng._admit_paged = logged
    sched = eng.scheduler
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sched.start()
    try:
        ids = []
        for p, gap in zip(prompts, gaps):
            ids.append(eng.submit(Request(tokens=p, max_new_tokens=SERVE_NEW)))
            time.sleep(float(gap))
        sched.wait(ids, timeout=600)
    finally:
        sched.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    out = [sched.result(i) for i in ids]
    st = eng.stats
    print(f"engine paged: {eng.path_summary()}, {cfg.name} {cfg.n_layers}L "
          f"d={cfg.d_model}, {SERVE_SLOTS} slots x {SERVE_SEQ} rows, "
          f"{eng.n_pages} pages of {PAGE} rows, {len(ids)} requests "
          f"(phase 4's), exponential arrival gaps of mean "
          f"{ARRIVAL_MEAN_S * 1e3:.0f} ms (submitting took "
          f"{float(gaps.sum()):.3f} s), async scheduler")
    for r in out:
        if (len(r.tokens) != SERVE_NEW or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"paged request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    for i, (r, want) in enumerate(zip(out, dense_tokens)):
        if r.tokens != want:
            at = next(j for j, (a, c) in enumerate(zip(r.tokens, want))
                      if a != c)
            fail(f"paged request {i} differs from the dense engine's at "
                 f"token {at} ({r.tokens[at]} vs {want[at]}); prompt of "
                 f"{len(prompts[i])} tokens; prefill groups {groups}")
    lat = sched.latency_stats()
    gen_tok = sum(len(r.tokens) for r in out)
    dec_ms = st["decode_s"] * 1e3 / max(st["decode_steps"], 1)
    dense_ms = dense_stats["decode_s"] * 1e3 / max(
        dense_stats["decode_steps"], 1)
    print(f"engine paged: {len(out)} requests served, tokens equal to phase "
          f"4's for all {len(out)}; {gen_tok} tokens in {wall:.3f} s "
          f"({gen_tok / wall:.1f} tok/s end to end, arrivals included); "
          f"prefill {st['prefill_calls']} launches {st['prefill_s'] * 1e3:.1f}"
          f" ms ({st['prefill_tokens']} prompt tokens, groups of "
          f"{[len(g) for g in groups]}); decode {st['decode_steps']} steps "
          f"{st['decode_s'] * 1e3:.1f} ms ({dec_ms:.2f} ms/step against the "
          f"dense engine's {dense_ms:.2f} in phase 4, "
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tok/s); "
          f"latency p50 {lat['p50_s']:.3f} s p99 {lat['p99_s']:.3f} s mean "
          f"{lat['mean_s']:.3f} s; peak live KV {sched.peak_live_bytes} B = "
          f"{sched.peak_live_bytes / dense_bytes:.3f} of the dense cache's "
          f"{dense_bytes} B; peak queue depth {lat['peak_queue_depth']}; "
          f"preemptions {eng.preemptions}")
    print(f"engine paged: launch counts {counts}")
    linears = 6 * cfg.n_layers
    want = {"int8_matmul": linears * (st["prefill_calls"] + st["decode_steps"]),
            "flash_attention_fwd_q8": cfg.n_layers * st["prefill_calls"],
            "decode_attention_paged": cfg.n_layers * st["decode_steps"],
            "decode_attention": 0}
    for name, n in want.items():
        if counts[name] != n or (n == 0 and name != "decode_attention"):
            fail(f"paged path: {name} launched {counts[name]} times, "
                 f"expected {n} (> 0 for a kernel of the path)")
    if not sched.peak_live_bytes < dense_bytes:
        fail(f"paged peak live KV {sched.peak_live_bytes} B not below the "
             f"dense cache's {dense_bytes} B")
    if eng.pool.free_pages != eng.n_pages - 1 or eng.pool.live_pages:
        fail(f"paged engine kept pages after stop(): {eng.pool.free_pages} "
             f"free of {eng.n_pages - 1}")
    profile_decode(torch, eng, cfg, np.random.RandomState(seed + 3))
    sched.stop()
    return counts


def serve_paged_pressure(torch, dev, seed):
    """Phase 4c, at full width and depth on the card, after the main
    path's counts are read.  (i) A pool of 1 + 24 pages of 64 rows and 16
    requests of 300- and 500-token prompts: every request must finish with 64
    tokens ("length") through at least one preemption, and every page must
    come back.  (ii) ``cache_prefix`` of a 256-token prefix, then 8
    requests of that prefix plus 16-64 random tokens: the tokens must equal
    the same requests' on a fresh paged engine without the cached prefix,
    the admitted requests must share the prefix pages, and afterwards the
    prefix pages' refcounts must be back at their pin (alloc + pin)."""
    import numpy as np
    from repro_torch.infer import Engine, Request
    cfg, model, params = serve_model(torch, dev, seed)
    kw = dict(max_slots=SERVE_SLOTS, max_seq=SERVE_SEQ, device=dev, seed=seed,
              paged=True, page_size=PAGE)
    rng = np.random.RandomState(seed + 2)
    eng = Engine(model, params, POLICY, n_pages=25, **kw)
    # preemption follows from the lengths alone (no eos): alternating 300
    # and 500 tokens preempts, where a random draw of 300-500 may fit the
    # admission headroom (seed 0's does) and test nothing
    lens = np.asarray([300, 500] * 8)
    ids = [eng.submit(Request(tokens=rng.randint(0, cfg.vocab_size, n)
                              .tolist(), max_new_tokens=SERVE_NEW))
           for n in lens]
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.scheduler.stop()
    bad = [(r.request_id, len(r.tokens), r.finish_reason) for r in out
           if len(r.tokens) != SERVE_NEW or r.finish_reason != "length"]
    st = eng.stats
    print(f"engine paged pressure (i): 16 requests, prompts {lens.min()}-"
          f"{lens.max()} tokens, {SERVE_NEW} new, a pool of 24 pages of "
          f"{PAGE} rows: {len(out)} served in {wall:.3f} s, preemptions "
          f"{eng.preemptions}, prefill {st['prefill_calls']} launches, "
          f"decode {st['decode_steps']} steps, peak live KV "
          f"{eng.scheduler.peak_live_bytes} B, pages free after "
          f"{eng.pool.free_pages}/24")
    if sorted(r.request_id for r in out) != sorted(ids) or bad:
        fail(f"paged pressure: requests not served to length: {bad}")
    if eng.preemptions < 1:
        fail("paged pressure: no preemption under a 24-page pool")
    if eng.pool.free_pages != 24:
        fail(f"paged pressure: {24 - eng.pool.free_pages} pages not returned")

    prefix = rng.randint(0, cfg.vocab_size, 256).tolist()
    prompts = [prefix + rng.randint(0, cfg.vocab_size,
                                    rng.randint(16, 65)).tolist()
               for _ in range(8)]
    runs, engines = [], []
    for cached in (True, False):
        eng = Engine(model, params, POLICY, **kw)
        if cached:
            n_pg = eng.cache_prefix(prefix)
            pids = eng._prefixes[tuple(prefix)]
        ids = [eng.submit(Request(tokens=p, max_new_tokens=SERVE_NEW))
               for p in prompts]
        if cached:
            eng.scheduler.step()                 # admission + one step
            shared = int(eng.pool.refcount[pids].min())
        by_id = {r.request_id: r.tokens for r in eng.run()}
        eng.scheduler.stop()
        runs.append([by_id[i] for i in ids])
        engines.append(eng)
    torch.cuda.synchronize()
    refs = [int(engines[0].pool.refcount[p]) for p in pids]
    print(f"engine paged prefix (ii): a {len(prefix)}-token prefix cached "
          f"as {n_pg} pages, 8 requests of prefix + 16-64 tokens: each "
          f"prefix page held by at least {shared - 2} admitted requests "
          f"after the first step, refcounts after the run {refs} (alloc + "
          f"pin = 2); tokens {'equal' if runs[0] == runs[1] else 'DIFFER'} "
          f"to a fresh engine's without the cached prefix")
    if runs[0] != runs[1]:
        fail("paged prefix sharing changed the tokens")
    if shared < 3:
        fail(f"paged prefix pages not shared (refcount {shared})")
    if refs != [2] * n_pg or engines[0].pool.live_pages != n_pg:
        fail(f"prefix pages' refcounts {refs} after the run, expected 2 "
             f"each (live pages {engines[0].pool.live_pages})")


def _teacher_forced(torch, model, cfg, params, toks, policy, device):
    """Logits of a 64-token prefill and 8 teacher-forced decode steps,
    (9, B, vocab), on ``device``; the KV caches as the last step left them."""
    from repro_torch.infer.prepare import prepare_params
    from repro_torch.models.common import tree_map
    p = prepare_params(cfg, tree_map(lambda t: t.to(device), params), policy)
    lg, st = model.prefill(p, toks[:, :64].to(device), policy=policy,
                           max_seq=80)
    out = [lg.cpu()]
    for i in range(8):
        pos = torch.full((toks.shape[0],), 64 + i, dtype=torch.int32,
                         device=device)
        lg, st = model.decode(p, st, toks[:, 64 + i:65 + i].to(device), pos,
                              policy=policy)
        out.append(lg.cpu())
    return torch.stack(out)[..., :cfg.vocab_size], st["caches"]


@contextlib.contextmanager
def plain_versions(names):
    """Inside, the model calls the named kernels' plain versions in their
    place, on whatever device its tensors are: the card-against-card
    comparisons of phases 5 and 8.  Nothing in the port does this."""
    import repro_torch.kernels.ops as ops
    import repro_torch.kernels.opt_update as opt_update
    import repro_torch.models.attention as attention
    from repro_torch.kernels.decode_attn import decode_attention_plain
    from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
    from repro_torch.kernels.int8_matmul import (int8_matmul_nt_plain,
                                                 int8_matmul_plain,
                                                 int8_matmul_tn_plain)
    sites = {"int8_matmul": (ops, int8_matmul_plain),
             "flash_attention_fwd_q8": (attention,
                                        flash_attention_fwd_q8_plain),
             "decode_attention": (attention, decode_attention_plain),
             "int8_matmul_nt": (ops, int8_matmul_nt_plain),
             "int8_matmul_tn": (ops, int8_matmul_tn_plain),
             "fused_adamw_blocks": (opt_update,
                                    opt_update.fused_adamw_blocks_plain)}
    saved = [(sites[n][0], n, getattr(sites[n][0], n)) for n in names]
    try:
        for n in names:
            setattr(sites[n][0], n, sites[n][1])
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def _agreement(torch, card, cpu, margin):
    err = (card - cpu).abs().max().item()
    top2 = cpu.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > margin
    agree = card.argmax(-1) == cpu.argmax(-1)
    return err, int(agree.sum()), int((decided & ~agree).sum())


def true_fan_in(params, cfg):
    """The block weights rescaled from the reference init's std 1/sqrt(L)
    (its fan-in is read from the stacked layer dim; ROADMAP section 3) to
    the true fan-in's 1/sqrt(d_in).  At the reference's scale the random
    model's logits jump by up to about 1 with the last bit of its inputs,
    so the plain versions alone put the card that far from the CPU
    (PERF.md); at this scale they stay continuous enough to compare."""
    blocks = {mod: {n: (w * math.sqrt(cfg.n_layers / w.shape[-2])
                        if n.startswith("w") else w)
                    for n, w in leaves.items()}
              for mod, leaves in params["blocks"].items()}
    return dict(params, blocks=blocks)


def card_vs_cpu(torch, dev, seed):
    """Phase 5: teacher-forced logits of the card against the CPU, float32
    carrier, the weights of ``init_params`` (seed + 1) at the true fan-in
    scale (``true_fan_in``), 2 prompts of 64 tokens + 8 decode steps.  Each
    policy is also run on the card with the three kernels' plain versions
    in their place, which shows how far PyTorch's own CPU and CUDA ops take
    the two devices apart.

    A. int8 weights and the int8 KV cache through both attention kernels
       (``kv_cache=a8t,*=w8c``): max |d logit| <= 1e-2, top-1 equal wherever
       the CPU's top-2 margin exceeds 1e-2.
    B. the slice's policy, which also quantizes every block linear's input
       per token, so the logits jump wherever a last-bit difference between
       the devices moves an activation across a rounding boundary.  Card
       against CPU: max |d logit| <= ``B_LIMIT``, a fixed limit set from
       recorded readings (PERF.md), top-1 equal wherever the margin exceeds
       it.  Card against card: with the plain ``int8_matmul`` in the
       kernel's place every logit must be bit-identical -- every one of the
       forward's int8 matmuls equals its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("gpt2-small"), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    params = true_fan_in(model.init_params(gen, device="cpu"), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64 + 8), generator=gen)

    def run(policy, device):
        return _teacher_forced(torch, model, cfg, params, toks, policy,
                               device)
    ok = True
    for label, policy, limit in (("A", "kv_cache=a8t,*=w8c", 1e-2),
                                 ("B", POLICY, B_LIMIT)):
        cpu, cpu_kv = run(policy, "cpu")
        card, card_kv = run(policy, dev)
        with plain_versions(SERVE_KERNELS):
            card_plain, _ = run(policy, dev)
        err, n_agree, n_bad = _agreement(torch, card, cpu, limit)
        spread = (card_plain - cpu).abs().max().item()
        flips = [float((card_kv["k"][i].cpu() != cpu_kv["k"][i]).float()
                       .mean()) for i in range(cfg.n_layers)]
        print(f"card vs cpu {label} {policy} (float32 carrier, 2 x 64 prompt "
              f"+ 8 teacher-forced steps): max |dlogit| {err:.3e} (limit "
              f"{limit:.1e}), top-1 agree {n_agree}/{cpu.shape[0] * cpu.shape[1]}"
              f" ({n_bad} disagreements where the CPU's top-2 margin > "
              f"limit); plain versions on the card vs cpu: max |dlogit| "
              f"{spread:.3e}; share of K-cache payloads that differ, by "
              f"layer: {' '.join(f'{x:.1e}' for x in flips)}")
        ok &= err <= limit and n_bad == 0 and bool(torch.isfinite(card).all())
        if policy == POLICY:
            with plain_versions(["int8_matmul"]):
                card_mm_plain, _ = run(policy, dev)
            same = torch.equal(card_mm_plain, card)
            print(f"card vs card {label}: plain int8_matmul in the kernel's "
                  f"place: logits {'bit-identical' if same else 'DIFFER'} "
                  f"(tol 0; max |dlogit| "
                  f"{(card_mm_plain - card).abs().max().item():.3e})")
            ok &= same
    if not ok:
        fail("card and CPU logits disagree")


def _grad_scale(torch, g, fold, dim):
    """absmax / 127 of g * fold over ``dim``: the wrappers' q_scale."""
    absmax = (g.float().abs() * fold).amax(dim=dim, keepdim=True)
    return absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)


def check_int8_bwd(torch, dev, gen, results):
    """Phase 6a: nt and tn at the training path's shapes (M = 8192 tokens,
    the three (K, N) of GPT-2 small's linears, bf16 gradient and output),
    bit for bit against their plain versions."""
    from repro_torch.kernels.int8_matmul import (
        _quant_grad, int8_matmul_nt, int8_matmul_nt_plain, int8_matmul_tn,
        int8_matmul_tn_plain, scale_guard)
    m = TRAIN_BATCH * TRAIN_SEQ
    rows = {"int8_matmul_nt": [], "int8_matmul_tn": []}
    for k, n in ((768, 768), (768, 3072), (3072, 768)):
        g = (torch.randn((m, n), generator=gen, device=dev) * 0.02).bfloat16()
        w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        fw = torch.rand((1, n), generator=gen, device=dev) * 0.01 + 1e-4
        fx = torch.rand((m, 1), generator=gen, device=dev) * 0.05 + 1e-4
        qn = _grad_scale(torch, g, fw, 1)
        qt = _grad_scale(torch, g, fx, 0)
        cases = {
            "int8_matmul_nt": (
                lambda: int8_matmul_nt(g, w, fw, qn),
                lambda: int8_matmul_nt_plain(g, w, fw, qn),
                # yardstick operands: the quantized gradient, w^T
                (_quant_grad(g, fw, scale_guard(qn)).to(torch.int8),
                 w.t()),
                m * n * 2 + k * n + 4 * (n + m) + m * k * 2),
            "int8_matmul_tn": (
                lambda: int8_matmul_tn(x, g, fx, qt, out_dtype=torch.bfloat16),
                lambda: int8_matmul_tn_plain(x, g, fx, qt,
                                             out_dtype=torch.bfloat16),
                (x.t().contiguous(),
                 _quant_grad(g, fx, scale_guard(qt)).to(torch.int8)),
                m * k + m * n * 2 + 4 * (m + n) + k * n * 2),
        }
        for name, (kern, plain, (la, lb), nbytes) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                fail(f"{name} M={m} K={k} N={n} not bit-exact (max err {err})")
            ms = time_ms(kern)
            plain_ms = time_ms(plain, iters=3)
            lib = time_ms(lambda: torch._int_mm(la, lb))
            b, by = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS)
            rows[name].append(dict(shape=f"M={m},K={k},N={n}",
                                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b, bound_by=by, library_ms=lib))
            print(f"{name} M={m} K={k:4d} N={n:4d} bf16: bit-exact (tol 0), "
                  f"ms {ms:.4f}, plain_ms {plain_ms:.4f}, bound_ms {b:.5f} "
                  f"({by}), library_ms(_int_mm) {lib:.4f}")
    # the JSON entry reports the shape with the most launches on the main
    # path: wq, wk, wv and wo at K = N = 768 (48 of the 72 a step)
    for name, line in (("int8_matmul_nt", 146), ("int8_matmul_tn", 205)):
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/int8_matmul_bwd.cu",
            replaces=f"src/repro/kernels/int8_matmul.py:{line}", tol=0.0,
            shapes=rows[name], **rows[name][0])


def gpt2_bucket_rows(torch, dev, cfg):
    """(rows, params) of the fused AdamW bucket for ``cfg`` under 128-wide
    blocks: every quantizable leaf's blocks, padded to the optimizer's
    tile, and the parameters they hold."""
    from repro_torch.core import qadam
    from repro_torch.core.qconfig import parse_spec
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim.adamw import TILE_ROWS
    spec = parse_spec("8c-b128")
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = tree_flatten(params)[0]
    rows = sum(qadam.blockwise_state_shapes(p.shape, spec)[0][0]
               for p in leaves if qadam.quantizable(p))
    n_params = sum(p.numel() for p in leaves if qadam.quantizable(p))
    del params, leaves
    return rows + (-rows) % TILE_ROWS, n_params


def check_fused_adamw(torch, dev, gen, results):
    """Phase 6b: the fused AdamW step on a bucket of GPT-2 small's size
    (random gradient, params and moments; the slice's codecs), bit for bit
    against its plain version in params, payloads, scales and zero points;
    the update-norm sum within 1e-5 relative (another summation order)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qconfig import parse_recipe
    from repro_torch.core.quantizer import quantize_int
    from repro_torch.kernels.opt_update import (codec_of, fused_adamw_blocks,
                                                fused_adamw_blocks_plain)
    rec = parse_recipe("m1:8c-b128,m2:8c-asym-b128-sqrt")
    rows, n_params = gpt2_bucket_rows(torch, dev, get_config("gpt2-small"))
    bs = 128
    g = torch.randn((rows, bs), generator=gen, device=dev) * 1e-2
    p = torch.randn((rows, bs), generator=gen, device=dev) * 0.05
    m1 = torch.randn((rows, bs), generator=gen, device=dev) * 1e-3
    m2 = torch.rand((rows, bs), generator=gen, device=dev) * 1e-5
    bucket = [g, p, *quantize_int(m1, rec.adam_m1),
              *quantize_int(m2.sqrt(), rec.adam_m2)]
    del m1, m2
    sc = torch.tensor([0.7, 6e-4, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
                       1 - 0.95 ** 3], dtype=torch.float32, device=dev)
    kw = dict(m1_codec=codec_of(rec.adam_m1), m2_codec=codec_of(rec.adam_m2),
              weight_decay=True)
    ref = [t.clone() for t in bucket]
    got = fused_adamw_blocks(*bucket, sc, **kw)
    want = fused_adamw_blocks_plain(*ref, sc, **kw)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(bucket[1:], ref[1:]))
    if not all(torch.equal(a, b) for a, b in zip(bucket[1:], ref[1:])):
        fail(f"fused_adamw_blocks not bit-exact on {rows} x {bs} (max err "
             f"{err})")
    rel = abs(got[3].item() - want[3].item()) / want[3].item()
    if rel > 1e-5:
        fail(f"fused_adamw_blocks update-norm sum off by {rel:.2e} relative")
    ms = time_ms(lambda: fused_adamw_blocks(*bucket, sc, **kw))
    plain = time_ms(lambda: fused_adamw_blocks_plain(*ref, sc, **kw), iters=3)
    n = rows * bs
    # reads g, p (fp32) and both int8 payloads, writes p and both payloads;
    # scale and zero of both moments read and written once a row
    nbytes = n * (4 + 4 + 1 + 1 + 4 + 1 + 1) + rows * 4 * 4 * 2 + 8 * 4
    b, by = bound_ms(nbytes, 35.0 * n, FP32_FLOPS)
    print(f"fused_adamw_blocks {rows} x {bs} ({n_params} GPT-2 small params "
          f"in the bucket): bit-exact (tol 0; update-norm sum rel "
          f"{rel:.1e}, tol 1e-5), ms {ms:.4f}, plain_ms {plain:.4f}, "
          f"bound_ms {b:.5f} ({by}), library_ms none (no PyTorch call "
          f"computes blockwise 8-bit AdamW)")
    results["fused_adamw_blocks"] = dict(
        route="cuda", source="src/repro_torch/csrc/opt_update.cu",
        replaces="src/repro/kernels/opt_update.py:160", tol=0.0,
        shape=f"rows={rows},bs={bs}", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None)


def train(torch, dev, seed):
    """Phase 7: GPT-2 small's train step on the card; returns the launch
    counts of the main run."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import (init_train_state, make_train_step,
                                   train_path_summary)
    cfg = get_config("gpt2-small")
    model = build_model(cfg)
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=TRAIN_STEPS,
                    state_storage="int")
    state = init_train_state(model,
                             torch.Generator(device=dev).manual_seed(seed),
                             TRAIN_POLICY, opt, device=dev)
    step_fn = make_train_step(model, TRAIN_POLICY, opt)
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batches = [torch.from_numpy(next(loader)["tokens"]).to(dev)
               for _ in range(TRAIN_STEPS + 1)]
    print(f"train: {cfg.name} {cfg.n_layers}L d={cfg.d_model} carrier "
          f"{cfg.dtype}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, policy "
          f"{TRAIN_POLICY}, int moments; train-path: "
          f"{train_path_summary(TRAIN_POLICY, cfg.n_layers, opt, device=dev)}")
    want = {"int8_matmul": 6 * cfg.n_layers, "int8_matmul_nt": 6 * cfg.n_layers,
            "int8_matmul_tn": 6 * cfg.n_layers, "fused_adamw_blocks": 1,
            "flash_attention_fwd_q8": 0, "decode_attention": 0,
            "decode_attention_paged": 0}
    # the serving phases stopped their schedulers (a running emit thread
    # holds its engine), but an engine and its scheduler refer to each
    # other: collect the cycles so the peak below is the train step's own
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_ms = []
    for i in range(TRAIN_STEPS):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        state, met = step_fn(state, {"tokens": batches[i]})
        ce, gn = float(met["ce"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        print(f"train: step {i + 1:2d} ce {ce:.4f} grad_norm {gn:.4f} "
              f"update_norm {float(met['update_norm']):.4f} "
              f"{step_ms[-1]:.1f} ms")
        if not (math.isfinite(ce) and math.isfinite(gn)):
            fail(f"train step {i + 1}: ce {ce}, grad norm {gn}")
        if per != want:
            fail(f"train step {i + 1}: launches {per}, expected {want}")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = step_ms[1:]
    mean = sum(steady) / len(steady)
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {TRAIN_STEPS} steps, step 1 {step_ms[0]:.1f} ms (loads "
          f"the libraries), steps 2-{TRAIN_STEPS} mean {mean:.1f} ms "
          f"(min {min(steady):.1f}, max {max(steady):.1f}), "
          f"{tok / mean * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB")
    print(f"train: launch counts {counts}")
    profile_train_step(torch, step_fn, state, batches[-1])
    return counts


def profile_train_step(torch, step_fn, state, batch) -> None:
    """Where a train step's time goes: torch.profiler over one step after
    the main run's counts are read; device time by kernel and the device's
    idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, {"tokens": batch})
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(k[1] for k in kern)
    if not busy:
        print("profile: no device time recorded (not measured)")
        return
    kern.sort(key=lambda k: -k[1])
    print(f"profile: 1 train step, wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{sum(k[2] for k in kern)} kernel launches")
    for name, us, n in kern[:12]:
        print(f"profile:   {us / 1e3:8.3f} ms {n:5d} launches {name[:90]}")


def _rel_l2(torch, a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors, in float64 on the CPU."""
    num = sum(float((x.double().cpu() - y.double().cpu()).square().sum())
              for x, y in zip(a, b))
    den = sum(float(y.double().cpu().square().sum()) for y in b)
    return math.sqrt(num / max(den, 1e-300))


def _update_split(torch, card, cpu):
    """Where the parameter updates of the card and the CPU part: the share
    of elements whose gradient sign differs, the share whose sign agrees
    but whose m1 or m2 payload differs, and the updates' relative L2
    distance over the elements whose sign agrees."""
    from repro_torch.core.qadam import QState
    n_all = n_flip = n_pay = 0
    num_s = den_s = 0.0
    for i, (gc, gp) in enumerate(zip(card["grads"], cpu["grads"])):
        n = gp.numel()
        flip = (torch.sign(gc).cpu().reshape(-1)
                != torch.sign(gp).reshape(-1))
        pay = torch.zeros(n, dtype=torch.bool)
        for key in ("m1", "m2"):
            a, b = card[key][i], cpu[key][i]
            if isinstance(b, QState):
                pay |= (a.q.cpu().reshape(-1)[:n] != b.q.reshape(-1)[:n])
        uc = (card["p"][i] - card["p0"][i]).double().cpu().reshape(-1)
        up = (cpu["p"][i] - cpu["p0"][i]).double().reshape(-1)
        d2, u2 = (uc - up).square(), up.square()
        same = ~flip
        n_all, n_flip = n_all + n, n_flip + int(flip.sum())
        n_pay += int((same & pay).sum())
        num_s += float(d2[same].sum())
        den_s += float(u2[same].sum())
    return (n_flip / n_all, n_pay / n_all,
            math.sqrt(num_s / max(den_s, 1e-300)))


def train_card_vs_cpu(torch, dev, seed):
    """Phase 8: one train step of gpt2-mini (float32 carrier, batch 4 x 128
    from the synthetic corpus, the slice's policy, int moments), weights of
    ``init_params`` (seed + 2) at the true fan-in scale (``true_fan_in``,
    as phase 5), the same on both devices.

    A. the card (kernels) against the CPU (plain versions): |d ce|, the
       gradients' relative L2 distance, the share of elements whose
       gradient sign differs, and the parameter updates' relative L2
       distance over all elements and over those whose sign agrees, each
       within a fixed limit (``TRAIN_LIMITS``);
    B. the card twice, the second time with only ``int8_matmul_nt`` and
       ``int8_matmul_tn`` swapped for their plain versions: every gradient
       bit-identical (and the card run twice without a swap, the control,
       bit-identical too);
    C. on the card, the fused AdamW path against the reference loop on the
       same gradients: params within 1e-6 relative (to each leaf's largest
       magnitude), payloads at most one codec step apart, scales within
       1e-6 relative -- the AdamW limits of
       tests/test_torch_train.py (the loop rounds 1 - b1 in Python
       float64, the kernel in float32, so moments can differ by an ulp)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qadam import QState
    from repro_torch.core.qpolicy import as_policy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten, tree_map
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import adamw_update, init_adam_state
    from repro_torch.train.step import value_and_grad
    cfg = dataclasses.replace(get_smoke_config("gpt2-small"), dtype="float32")
    model = build_model(cfg)
    params = true_fan_in(model.init_params(
        torch.Generator().manual_seed(seed + 2), device="cpu"), cfg)
    toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=4, seq_len=128))
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                    state_storage="int")
    policy = as_policy(TRAIN_POLICY)

    def run(device, fused=True, swap=()):
        p = tree_map(lambda t: t.to(device), params)
        st = init_adam_state(p, policy, opt)
        with plain_versions(swap):
            loss, _, grads = value_and_grad(model, policy, p,
                                            {"tokens": toks.to(device)})
            new_p, new_st, stats = adamw_update(p, grads, st, opt, policy,
                                                fused=fused)
        return dict(loss=float(loss), grads=tree_flatten(grads)[0],
                    p0=tree_flatten(p)[0], p=tree_flatten(new_p)[0],
                    m1=tree_flatten(new_st.m1)[0],
                    m2=tree_flatten(new_st.m2)[0],
                    gn=float(stats["grad_norm"]), p_tree=p, g_tree=grads,
                    st=st)

    cpu, card = run("cpu"), run(dev)
    d_ce = abs(card["loss"] - cpu["loss"])
    g_rel = _rel_l2(torch, card["grads"], cpu["grads"])
    upd = lambda r: [a - b for a, b in zip(r["p"], r["p0"])]
    u_rel = _rel_l2(torch, upd(card), upd(cpu))
    flips, pays, u_sign = _update_split(torch, card, cpu)
    lim = TRAIN_LIMITS
    print(f"train card vs cpu A (gpt2-mini, float32 carrier, 4 x 128 tokens,"
          f" {TRAIN_POLICY}): ce {card['loss']:.6f} vs {cpu['loss']:.6f} "
          f"(|d| {d_ce:.3e}, limit {lim['ce']:.0e}), grad norm "
          f"{card['gn']:.6f} vs {cpu['gn']:.6f}, grads rel L2 {g_rel:.3e} "
          f"(limit {lim['grads']:.0e}), param updates rel L2 {u_rel:.3e} "
          f"(limit {lim['updates']:.0e})")
    print(f"train card vs cpu A, updates by element: gradient sign differs "
          f"on {flips:.3e} of them (limit {lim['sign_flips']:.0e}); updates "
          f"rel L2 where the sign agrees {u_sign:.3e} (limit "
          f"{lim['updates_sign']:.0e}), though an m1/m2 payload differs on "
          f"{pays:.3e} of the elements there")
    ok = (d_ce <= lim["ce"] and g_rel <= lim["grads"]
          and u_rel <= lim["updates"] and flips <= lim["sign_flips"]
          and u_sign <= lim["updates_sign"])

    control = run(dev)
    swapped = run(dev, swap=("int8_matmul_nt", "int8_matmul_tn"))
    same = lambda a, b: all(torch.equal(x, y) for x, y in
                            zip(a["grads"], b["grads"]))
    ctrl_same, swap_same = same(card, control), same(card, swapped)
    print(f"train card vs card B: grads with plain nt/tn in the kernels' "
          f"place {'bit-identical' if swap_same else 'DIFFER'} (control, "
          f"the card twice: {'bit-identical' if ctrl_same else 'DIFFER'}; "
          f"tol 0; grads rel L2 {_rel_l2(torch, swapped['grads'], card['grads']):.3e})")
    ok &= ctrl_same and swap_same

    # C: same gradients, fused kernel against the loop
    loop_p, loop_st, _ = adamw_update(card["p_tree"], card["g_tree"],
                                      card["st"], opt, policy, fused=False)
    lp, lm1, lm2 = (tree_flatten(t)[0] for t in (loop_p, loop_st.m1,
                                                 loop_st.m2))
    # params relative to each leaf's largest magnitude: elementwise, a value
    # where p - lr * update cancels would magnify an ulp of the update
    p_rel = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(card["p"], lp))
    dq, s_rel = 0, 0.0
    for fa, la in zip(card["m1"] + card["m2"], lm1 + lm2):
        if isinstance(fa, QState):
            dq = max(dq, (fa.q.int() - la.q.int()).abs().max().item())
            s_rel = max(s_rel, ((fa.scale - la.scale).abs()
                                / la.scale.abs().clamp_min(1e-30)).max().item())
    print(f"train card C: fused AdamW vs the loop on the card, same grads: "
          f"params max rel {p_rel:.2e} (limit 1e-6), payloads max "
          f"{dq} step (limit 1), scales max rel {s_rel:.2e} (limit 1e-6)")
    ok &= p_rel <= 1e-6 and dq <= 1 and s_rel <= 1e-6
    if not ok:
        fail("phase 8: train step card vs CPU / card vs card out of limits")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(built) or 'nothing (cached)'} "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    out_dir = REPO / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "ptxas.log", "w") as f:
        for name in _build.SOURCES:
            log = _build.lib_path(name).with_suffix(".log")
            if log.exists():
                f.write(f"== {name}\n{log.read_text()}\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    results = {}
    check_int8_matmul(torch, dev, gen, results)
    check_decode_attention(torch, dev, gen, results)
    check_decode_attention_paged(torch, dev, gen, results)
    check_flash_q8(torch, dev, gen, results)
    serve_counts, dense_tokens, dense_bytes, dense_stats = serve(
        torch, dev, args.seed)
    paged_counts = serve_paged(torch, dev, args.seed, dense_tokens,
                               dense_bytes, dense_stats)
    serve_paged_pressure(torch, dev, args.seed)
    card_vs_cpu(torch, dev, args.seed)
    check_int8_bwd(torch, dev, gen, results)
    check_fused_adamw(torch, dev, gen, results)
    train_counts = train(torch, dev, args.seed)
    train_card_vs_cpu(torch, dev, args.seed)

    # launches: each kernel's count on the main paths, dense serving (phase
    # 4), paged serving (phase 4b) and training (phase 7), each path's
    # counts read right after its run
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    kern = []
    for name in KERNEL_NAMES:
        by_path = {"serve": serve_counts[name],
                   "serve_paged": paged_counts[name],
                   "train": train_counts[name]}
        kern.append(dict(name=name, launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         **{k: results[name][k] for k in keys}))
    (out_dir / "kernels.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
