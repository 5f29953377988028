#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build the CUDA kernel libraries of ``_build.SOURCES`` (seven sources
   under ``src/repro_torch/csrc``, one nvcc each, all at once;
   ``decode_attn.cu`` holds the dense and the paged decode kernels,
   ``flash_attn.cu`` the fp flash forward and both backward kernels) and
   print the build time;
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
   ``train_card_vs_cpu`` for the checks and their limits);
9. the fake-quant gradient kernels ``qdq_row`` and ``qdq_scaled`` bit for
   bit against their plain versions at the gradients' shapes, timed beside
   their bound, plain version and a fake-quantize yardstick
   (``check_qdq``);
10. GPT-2 small at full width through the port's ``Trainer`` under the
    fake-quant recipes ``paper_wag8`` (10 steps: ms/step, tokens/s, peak
    memory, idle share), ``w8c,a8t,g8n`` and ``w8c,a8t,g8c``: 72 qdq
    launches a step and no other kernel (``train_fake``);
11. the guarded path at full width: the sentinel, async checkpoints under
    ``build/`` (removed after), ``nan_grad@5`` over 12 steps; the ladder
    equals ``LADDER_EXPECT`` and each primary and fallback step launches
    exactly its kernels (``train_guarded``); 11b. SIGTERM after a step,
    then resume: bit-identical to the uninterrupted run (``train_resume``);
12. one ``paper_wag8`` step on gpt2-mini, card against CPU, and with the
    plain qdq in the kernels' place; a bf16-carrier step, the control,
    must exceed every limit (``train_fake_card_vs_cpu``);
13. the fp flash kernels #7-#10 against their plain versions at the
    training shape (BH = 96, S = 1024, hd = 64) and ``FLASH_SWEEP`` (head
    dims 16-256, Sq != Skv, an odd length, non-causal, the prefill
    shape), float32 and bfloat16, on the same inputs, within ``FLASH_TOL``
    and, at bfloat16, ``FLASH_BF16`` with three controls outside it; #7
    equal to #8, repeats bit-identical, a planted NaN propagated; each
    timed beside its bound (each product at its operands' peak rate),
    plain version and SDPA (``check_flash``);
14. phase 7 with ``attention_impl="flash_pallas"``: 10 finite steps, each
    launching exactly 72 / 72 / 72 / 1 int8 and AdamW kernels and #8, #9,
    #10 12 times (``train(impl="flash_pallas")``); 14b. the dense engine
    with an fp KV cache and the flash setting: 8 of phase 4's prompts
    answered to length, #8 12 times per prefill launch, #9/#10 never
    (``serve_flash``);
15. the flash path at float32 under ``*=fp`` against the CPU, against
    ``_attend`` and against its plain versions on the card, within
    ``FLASH_LIMITS`` (``flash_card_vs_cpu``).

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
# tensor-core ops/s, bf16 tensor-core FLOP/s, fp32 FLOP/s outside the
# tensor cores
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
SERVE_KERNELS = ("int8_matmul", "flash_attention_fwd_q8", "decode_attention")
TRAIN_KERNELS = ("int8_matmul_nt", "int8_matmul_tn", "fused_adamw_blocks")
QDQ_KERNELS = ("qdq_row", "qdq_scaled")
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
KERNEL_NAMES = SERVE_KERNELS + TRAIN_KERNELS + ("decode_attention_paged",) \
    + QDQ_KERNELS + FLASH_KERNELS
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
#: phase 10: the fake-quant recipes whose G spec runs the qdq kernels
FAKE_RECIPES = ("paper_wag8", "w8c,a8t,g8n", "w8c,a8t,g8c")
#: phase 11: the guarded path -- the sentinel's settings, the checkpoint
#: period, the fault plan and the number of loop steps
LADDER_SENTINEL = dict(window=8, min_history=2, skip_limit=1,
                       fallback_steps=4, max_rollbacks=3)
LADDER_STEPS, LADDER_CKPT_EVERY, LADDER_FAULT = 12, 3, "nan_grad@5"
#: the ladder that plan walks: the verdict at each loop step in order (the
#: NaN step skips, the fault fires again at the next loop step because a
#: skipped step does not advance the optimizer's counter, and the second
#: spike rolls back to the checkpoint of step 3), the loop's and the
#: sentinel's counts, the history rows run in the fallback window and the
#: spike reasons.  tests/test_torch_train_system.py holds it equal to the
#: JAX Trainer's on the same plan and settings.
LADDER_EXPECT = {
    "verdicts": [[0, "ok"], [1, "ok"], [2, "ok"], [3, "ok"], [4, "ok"],
                 [5, "skip"], [6, "rollback"], [3, "ok"], [4, "ok"],
                 [5, "ok"], [6, "ok"], [7, "ok"], [8, "ok"], [9, "ok"],
                 [10, "ok"], [11, "ok"]],
    "counts": {"saves": 4, "restores": 1, "skipped_batches": 1,
               "rollback_failures": 0, "observed": 16, "spikes": 2,
               "skips": 1, "rollbacks": 1, "fallback_windows": 1,
               "fallback_steps_run": 7},
    "fallback_rows": [4, 5, 6, 7, 8, 9, 10],
    "spike_reasons": {"nonfinite-grad": 2},
}
#: phase 13: the flash kernels at the training shape (BH = 8 x 12 heads,
#: S = 1024, hd = 64, causal), then this sweep: (label, BH, Sq, Skv, hd,
#: causal, q_offset) -- every other head dim of the repo's configs, Sq !=
#: Skv at q_offset = Skv - Sq, an odd length, the non-causal case and the
#: fp-KV prefill's 300-token prompt against a 1024-row cache
FLASH_SWEEP = (("hd16", 16, 512, 512, 16, True, 0),
               ("hd32", 16, 512, 512, 32, True, 0),
               ("hd128", 16, 512, 512, 128, True, 0),
               ("hd160", 8, 512, 512, 160, True, 0),
               ("hd256", 8, 512, 512, 256, True, 0),
               ("offset", 16, 384, 1024, 64, True, 640),
               ("odd", 16, 1000, 1000, 64, True, 0),
               ("noncausal", 16, 512, 700, 64, False, 0),
               ("prefill", 12, 300, 1024, 64, True, 0))
#: phase 13's tolerances of the kernels against their plain versions on
#: the same unit-normal inputs (the backward's plain versions read the
#: kernels' lse and delta): o's max |error| by carrier and the LSE rows'
#: (the reference's own, tests/test_flash_attn.py), and at float32 the
#: gradients' relative L2 distance.  At bfloat16 the kernels and the plain
#: versions compute one fp32 function in another order and round it once,
#: so o, dq, dk and dv are held to FLASH_BF16: their relative L2 distance
#: and the share of elements more than one bf16 step from the plain
#: version.  The plain forward rounds p against the running max of the
#: kernel's key tiles, as the kernel does.  Three controls that move one
#: rounding of p must exceed both limits: the plain forward with p left
#: unrounded, the plain forward rounding p against the row's final max
#: (the reference's _ref_attend), and #9's dv with p rounded to bf16.
#: Readings on the H100 at every phase-13 shape (PERF.md): sound at most
#: 4.8e-5 and 1.3e-5 (the gradients bit for bit), controls at least
#: 9.3e-4 and 3.6e-2; each limit sits 4x or more from both sides.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_LSE_TOL = 2e-5
FLASH_GRAD_TOL = 1e-4
FLASH_BF16 = {"rel_l2": 2e-4, "over_ulp": 1e-3}
#: phase 14b: the flash prefill serves 8 of phase 4's prompts, 16 new
#: tokens each, from an fp KV cache (no kv_cache role)
FLASH_SERVE_POLICY = "*=w8c+a8t@int8_cuda"
FLASH_SERVE_REQUESTS, FLASH_SERVE_NEW = 8, 16
#: phase 15: limits of flash against flash (card vs CPU) and of flash
#: against _attend (the same function in another fp32 order), stated
#: before any reading: |d ce|, the gradients' relative L2 distance, max
#: |d logit|
FLASH_LIMITS = {"ce": 1e-5, "grads": 1e-4, "logits": 1e-4}
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


def ladder_record(summary, history, verdicts):
    """The parts of a guarded run that ``LADDER_EXPECT`` pins, from a
    Trainer's ``resilience_summary()``, its history and the sentinel's
    verdicts as (loop step, verdict value) pairs; the same for the port's
    Trainer and the JAX package's."""
    s = summary["sentinel"]
    counts = {k: summary[k] for k in ("saves", "restores", "skipped_batches",
                                      "rollback_failures")}
    counts.update({k: s[k] for k in ("observed", "spikes", "skips",
                                     "rollbacks", "fallback_windows",
                                     "fallback_steps_run")})
    return {"verdicts": [[int(st), str(v)] for st, v in verdicts],
            "counts": counts,
            "fallback_rows": [int(r["step"]) for r in history
                              if r.get("fallback")],
            "spike_reasons": dict(s["spike_reasons"])}


def bound_ms(nbytes: float, ops: float, rate: float, more=()):
    """Least time for the work: the larger of bytes over memory rate and
    operations over peak rate, plus each further (operations, rate) pair
    of ``more`` for work that mixes types; returns (ms, 'bytes' |
    'operations')."""
    t_mem = nbytes / HBM_BPS
    t_ops = ops / rate + sum(n / r for n, r in more)
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
    comparisons of phases 5, 8, 12 and 15.  Nothing in the port does
    this."""
    import repro_torch.kernels.flash_attn as flash_attn
    import repro_torch.kernels.ops as ops
    import repro_torch.kernels.opt_update as opt_update
    import repro_torch.models.attention as attention
    from repro_torch.kernels.decode_attn import decode_attention_plain
    from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
    from repro_torch.kernels.int8_matmul import (int8_matmul_nt_plain,
                                                 int8_matmul_plain,
                                                 int8_matmul_tn_plain)
    from repro_torch.kernels.qdq import qdq_row_plain, qdq_scaled_plain
    sites = {"int8_matmul": (ops, int8_matmul_plain),
             "qdq_row": (ops, qdq_row_plain),
             "qdq_scaled": (ops, qdq_scaled_plain),
             "flash_attention_fwd_q8": (attention,
                                        flash_attention_fwd_q8_plain),
             "decode_attention": (attention, decode_attention_plain),
             "int8_matmul_nt": (ops, int8_matmul_nt_plain),
             "int8_matmul_tn": (ops, int8_matmul_tn_plain),
             "fused_adamw_blocks": (opt_update,
                                    opt_update.fused_adamw_blocks_plain),
             **{n: (flash_attn, getattr(flash_attn, n + "_plain"))
                for n in FLASH_KERNELS}}
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


def train(torch, dev, seed, impl="xla"):
    """Phase 7 (``impl="xla"``, attention through ``_attend``) and phase 14
    (``"flash_pallas"``, through #8-#10): GPT-2 small's train step on the
    card; returns the launch counts of the main run."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import (init_train_state, make_train_step,
                                   train_path_summary)
    cfg = dataclasses.replace(get_config("gpt2-small"), attention_impl=impl)
    model = build_model(cfg)
    tag = "train" if impl == "xla" else "train_flash"
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
    print(f"{tag}: {cfg.name} {cfg.n_layers}L d={cfg.d_model} carrier "
          f"{cfg.dtype}, attention {impl}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"a step, policy {TRAIN_POLICY}, int moments; train-path: "
          f"{train_path_summary(TRAIN_POLICY, cfg.n_layers, opt, device=dev)}")
    linears = 6 * cfg.n_layers
    flash = {} if impl == "xla" else {k: cfg.n_layers for k in FLASH_KERNELS
                                      if k != "flash_attention_fwd"}
    want = _expect(int8_matmul=linears, int8_matmul_nt=linears,
                   int8_matmul_tn=linears, fused_adamw_blocks=1, **flash)
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
        print(f"{tag}: step {i + 1:2d} ce {ce:.4f} grad_norm {gn:.4f} "
              f"update_norm {float(met['update_norm']):.4f} "
              f"{step_ms[-1]:.1f} ms")
        if not (math.isfinite(ce) and math.isfinite(gn)):
            fail(f"{tag} step {i + 1}: ce {ce}, grad norm {gn}")
        if per != want:
            fail(f"{tag} step {i + 1}: launches {per}, expected {want}")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = step_ms[1:]
    mean = sum(steady) / len(steady)
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"{tag}: {TRAIN_STEPS} steps, step 1 {step_ms[0]:.1f} ms (loads "
          f"the libraries), steps 2-{TRAIN_STEPS} mean {mean:.1f} ms "
          f"(min {min(steady):.1f}, max {max(steady):.1f}), "
          f"{tok / mean * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB")
    print(f"{tag}: launch counts {counts}")
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


def one_train_step(torch, model, policy, params, toks, opt, device,
                   fused=None, swap=()):
    """One train step's forward, backward and AdamW update from ``params``
    (CPU tensors, copied to ``device``) and fresh moments, with the named
    kernels' plain versions in their place (``plain_versions``): loss,
    flat gradients, params before and after, new moments, grad norm."""
    from repro_torch.models.common import tree_flatten, tree_map
    from repro_torch.optim.adamw import adamw_update, init_adam_state
    from repro_torch.train.step import value_and_grad
    p = tree_map(lambda t: t.to(device), params)
    st = init_adam_state(p, policy, opt)
    with plain_versions(swap):
        loss, _, grads = value_and_grad(model, policy, p,
                                        {"tokens": toks.to(device)})
        new_p, new_st, stats = adamw_update(p, grads, st, opt, policy,
                                            fused=fused)
    return dict(loss=float(loss), grads=tree_flatten(grads)[0],
                p0=tree_flatten(p)[0], p=tree_flatten(new_p)[0],
                m1=tree_flatten(new_st.m1)[0], m2=tree_flatten(new_st.m2)[0],
                gn=float(stats["grad_norm"]), p_tree=p, g_tree=grads, st=st)


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
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import adamw_update
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
        return one_train_step(torch, model, policy, params, toks, opt,
                              device, fused=fused, swap=swap)

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


# ---------------------------------------------------------------------------
# phases 9-12: the fake-quant gradient kernels and the guarded training path
# ---------------------------------------------------------------------------

def time_cold_ms(fn, args_list, iters: int = 20, warmup: int = 3) -> float:
    """``time_ms`` cycling through argument tuples whose tensors together
    exceed the 50 MB L2, so each launch reads its input from device memory
    as the train step's gradient does (the matmul that made it has moved
    on to other tensors)."""
    import torch
    n = len(args_list)
    for i in range(warmup):
        fn(*args_list[i % n])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % n])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _qdq_input(torch, dev, gen, rows, f, bits, dtype):
    """A (rows, f) gradient-like tensor with the rounding cases planted: row
    0 reaches absmax qmax (a per-row scale of exactly 1) and holds exact x.5
    ties of both signs, row 1 is all zero, and rows 2-5 of column 2 hold
    x.5 values (ties under the per-channel scale of 1 phase 9 gives it)."""
    qmax = 2 ** (bits - 1) - 1
    x = torch.randn((rows, f), generator=gen, device=dev) * 0.02
    x[0, :8] = torch.tensor([qmax, 0.5, 1.5, 2.5, -2.5, -0.5, -3.5, 4.5],
                            device=dev)
    x[1] = 0.0
    x[2:6, 2] = torch.tensor([0.5, -1.5, 2.5, -4.5], device=dev)
    return x.to(dtype).contiguous()


def _yardstick_ms(torch, fn, x):
    """Time of a PyTorch fake-quantize call on ``x``, or on its float32
    copy where the call refuses bfloat16; (ms, dtype it ran at)."""
    try:
        fn(x)
        torch.cuda.synchronize()
        return time_ms(lambda: fn(x)), str(x.dtype).replace("torch.", "")
    except RuntimeError:
        xf = x.float()
        return time_ms(lambda: fn(xf)), "float32"


def check_qdq(torch, dev, gen, results):
    """Phase 9: ``qdq_row`` and ``qdq_scaled`` (per channel, (1, F), and per
    tensor, (1, 1)) bit for bit against their plain versions at the
    gradients' shapes, (8192, 768) and (8192, 3072), bfloat16 and float32,
    8 and 4 bits, with planted ties and an all-zero row; each timed beside
    its byte bound, its plain version and a PyTorch yardstick:
    ``torch.amax`` + ``fake_quantize_per_channel_affine`` (axis 0 for #1,
    axis 1 for the per-channel #2) and ``fake_quantize_per_tensor_affine``
    (per-tensor #2), which multiply by a reciprocal -- a time, not an
    oracle."""
    from repro_torch.core.quantizer import _div
    from repro_torch.kernels.qdq import (qdq_row, qdq_row_plain, qdq_scaled,
                                         qdq_scaled_plain)
    m = TRAIN_BATCH * TRAIN_SEQ
    rows = {"qdq_row": [], "qdq_scaled": []}
    for f in (768, 3072):
        for dtype in (torch.bfloat16, torch.float32):
            for bits in (8, 4):
                qmax = 2 ** (bits - 1) - 1
                x = _qdq_input(torch, dev, gen, m, f, bits, dtype)
                nbytes = 2 * x.numel() * x.element_size()
                copies = [(x,)] + [(x.clone(),) for _ in
                                   range(int(100e6 // nbytes) + 1)]
                dname = str(dtype).replace("torch.", "")
                zp_c = torch.zeros(f, dtype=torch.int32, device=dev)
                zp_r = torch.zeros(m, dtype=torch.int32, device=dev)
                xa = x.float().abs()
                s_chan = _div(xa.amax(dim=0, keepdim=True).clamp_min(1e-12),
                              float(qmax))
                s_chan[0, 2] = 1.0                # the planted ties
                s_tens = _div(xa.amax().clamp_min(1e-12),
                              float(qmax)).reshape(1, 1)
                cases = [
                    ("qdq_row", "per row", lambda a: qdq_row(a, bits),
                     lambda: qdq_row_plain(x, bits),
                     lambda t: torch.fake_quantize_per_channel_affine(
                         t, _div(t.float().abs().amax(dim=1).clamp_min(
                             1e-12), float(qmax)), zp_r, 0, -qmax - 1, qmax),
                     0),
                    ("qdq_scaled", "per channel",
                     lambda a: qdq_scaled(a, s_chan, bits),
                     lambda: qdq_scaled_plain(x, s_chan, bits),
                     lambda t: torch.fake_quantize_per_channel_affine(
                         t, s_chan.reshape(-1), zp_c, 1, -qmax - 1, qmax),
                     4 * f),
                    ("qdq_scaled", "per tensor",
                     lambda a: qdq_scaled(a, s_tens, bits),
                     lambda: qdq_scaled_plain(x, s_tens, bits),
                     lambda t: torch.fake_quantize_per_tensor_affine(
                         t, s_tens.reshape(()), zp_c[:1].reshape(()),
                         -qmax - 1, qmax),
                     4),
                ]
                for name, kind, kern, plain, lib_fn, extra in cases:
                    got, want = kern(x), plain()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    if not torch.equal(got, want):
                        fail(f"{name} {kind} ({m}, {f}) {dname} bits {bits} "
                             f"not bit-exact (max err {err})")
                    ms = time_cold_ms(kern, copies)
                    plain_ms = time_ms(plain, iters=5)
                    lib, lib_dtype = _yardstick_ms(torch, lib_fn, x)
                    b, by = bound_ms(nbytes + extra, 7.0 * x.numel(),
                                     FP32_FLOPS)
                    rows[name].append(dict(
                        shape=f"({m},{f}) {dname} bits={bits} {kind}",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b, bound_by=by, library_ms=lib,
                        library_dtype=lib_dtype))
                    print(f"{name} {kind:11s} ({m}, {f:4d}) {dname:8s} bits "
                          f"{bits}: bit-exact (tol 0), ms {ms:.4f}, plain_ms "
                          f"{plain_ms:.4f}, bound_ms {b:.5f} ({by}), "
                          f"library_ms(fake_quantize, {lib_dtype}) "
                          f"{lib:.4f}")
    # the JSON entry reports the shape with the most launches on the main
    # path: the bf16 gradients of q, k, v, o and down, F = 768 (60 of the
    # 72 a step), 8 bits; #2 per channel (g8c; g8n times alike)
    for name, line in (("qdq_row", 59), ("qdq_scaled", 79)):
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/qdq.cu",
            replaces=f"src/repro/kernels/qdq.py:{line}", tol=0.0,
            shapes=rows[name], **rows[name][0])


def _step_recorder(torch, fn, log, kind):
    """``fn`` (a train step) wrapped to log, per call, its kind, host
    milliseconds to a device sync, ce, grad norm and the launches of every
    kernel."""
    from repro_torch import kernels

    def step(state, batch):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        new, met = fn(state, batch)
        ce = float(met["ce"])
        torch.cuda.synchronize()
        log.append(dict(kind=kind, ms=(time.perf_counter() - t0) * 1e3,
                        ce=ce, gn=float(met["grad_norm"]),
                        launches={k: v - before[k] for k, v in
                                  kernels.launch_counts().items()}))
        return new, met
    return step


def _expect(**nonzero):
    return {k: nonzero.get(k, 0) for k in KERNEL_NAMES}


def train_fake(torch, dev, seed):
    """Phase 10: GPT-2 small at full width and depth, 8 x 1024 tokens a
    step, trained through the port's ``Trainer`` under the fake-quant
    recipes (the default ``fake_quant`` backend): ``paper_wag8`` (W8/A8/G8,
    the gradient per token through ``qdq_row``) for 10 steps -- ms per
    step, tokens/s, peak memory, and the idle share of one profiled step
    -- then one step each of ``w8c,a8t,g8n`` and ``w8c,a8t,g8c``
    (``qdq_scaled`` per tensor and per channel).  Every step must launch
    its qdq kernel exactly 72 times and no other kernel, with finite ce
    and grad norm.  Returns the launch counts of the three runs."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.qconfig import Granularity, get_recipe
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import (LoopConfig, Trainer, init_train_state,
                                   make_train_step, train_path_summary)
    cfg = get_config("gpt2-small")
    model = build_model(cfg)
    linears = 6 * cfg.n_layers
    kept = None
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i, name in enumerate(FAKE_RECIPES):
        recipe = get_recipe(name)
        steps = TRAIN_STEPS if i == 0 else 1
        opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=steps)
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed), recipe,
            opt, device=dev)
        step_fn = make_train_step(model, recipe, opt)
        log = []
        trainer = Trainer(_step_recorder(torch, step_fn, log, "primary"),
                          None, state,
                          Loader(SyntheticCorpus(cfg.vocab_size, seed=7),
                                 cfg, batch_size=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ),
                          loop_cfg=LoopConfig(total_steps=steps,
                                              ckpt_every=10 ** 9,
                                              log_every=1))
        torch.cuda.reset_peak_memory_stats()
        trainer.run()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kern = ("qdq_row" if recipe.grads.granularity is Granularity.PER_TOKEN
                else "qdq_scaled")
        want = _expect(**{kern: linears})
        print(f"train_fake: {name} ({recipe.describe()}), {cfg.n_layers}L "
              f"d={cfg.d_model}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; "
              f"train-path: {train_path_summary(recipe, cfg.n_layers, opt, device=dev)}")
        for j, r in enumerate(log):
            print(f"train_fake: {name} step {j + 1:2d} ce {r['ce']:.4f} "
                  f"grad_norm {r['gn']:.4f} {r['ms']:.1f} ms")
            if not (math.isfinite(r["ce"]) and math.isfinite(r["gn"])):
                fail(f"train_fake {name} step {j + 1}: ce {r['ce']}, grad "
                     f"norm {r['gn']}")
            if r["launches"] != want:
                fail(f"train_fake {name} step {j + 1}: launches "
                     f"{r['launches']}, expected {want}")
        if i == 0:
            steady = [r["ms"] for r in log[1:]]
            mean = sum(steady) / len(steady)
            tok = TRAIN_BATCH * TRAIN_SEQ
            print(f"train_fake: {name} {steps} steps, step 1 "
                  f"{log[0]['ms']:.1f} ms, steps 2-{steps} mean {mean:.1f} "
                  f"ms (min {min(steady):.1f}, max {max(steady):.1f}), "
                  f"{tok / mean * 1e3:.0f} tokens/s, peak memory "
                  f"{peak:.2f} GiB")
            kept = (step_fn, trainer.state)
    counts = kernels.launch_counts()
    print(f"train_fake: launch counts {counts}")
    batch = torch.from_numpy(Loader(SyntheticCorpus(cfg.vocab_size, seed=7),
                                    cfg, batch_size=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ).peek(TRAIN_STEPS)
                             ["tokens"]).to(dev)
    profile_train_step(torch, kept[0], kept[1], batch)
    return counts


def recording(sentinel, log):
    """``sentinel`` with its verdicts appended to ``log`` as (loop step,
    verdict value) pairs."""
    observe = sentinel.observe

    def wrapped(step, metrics):
        v = observe(step, metrics)
        log.append((step, v.value))
        return v
    sentinel.observe = wrapped
    return sentinel


def train_guarded(torch, dev, seed):
    """Phase 11: the guarded path at full width -- GPT-2 small, 8 x 1024
    tokens a step, ``TRAIN_POLICY`` on the int8 kernels under the stability
    sentinel (``LADDER_SENTINEL``), async checkpoints every 3 steps into
    ``build/chip_smoke_ckpt`` (keep 2; the directory is removed at the
    end), the fault plan ``nan_grad@5``, 12 steps.  The ladder must equal
    ``LADDER_EXPECT`` (pinned on the CPU against the JAX Trainer); primary
    steps launch int8_matmul / nt / tn / AdamW 72 / 72 / 72 / 1 times and
    no qdq kernel, fallback steps (``fallback_policy``: fake quant, G8 per
    token) ``qdq_row`` 72 times, AdamW once and no int8 kernel; the run
    ends at ``opt.step == 12`` with finite params.  Returns the launch
    counts of the run."""
    import shutil
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.qpolicy import fallback_policy
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig
    from repro_torch.train import (FaultPlan, LoopConfig, SentinelConfig,
                                   StabilitySentinel, Trainer,
                                   init_train_state, make_train_step)
    ckdir = REPO / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        cfg = get_config("gpt2-small")
        model = build_model(cfg)
        linears = 6 * cfg.n_layers
        opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=LADDER_STEPS,
                        state_storage="int")
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed),
            TRAIN_POLICY, opt, device=dev)
        faults = FaultPlan.parse(LADDER_FAULT)
        log, verdicts = [], []
        primary = _step_recorder(torch, make_train_step(
            model, TRAIN_POLICY, opt, faults=faults, health=True), log,
            "primary")
        fallback = _step_recorder(torch, make_train_step(
            model, fallback_policy(TRAIN_POLICY), opt, health=True), log,
            "fallback")
        mgr = CheckpointManager(str(ckdir), keep_n=2, async_write=True)
        trainer = Trainer(
            primary, None, state,
            Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                   batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ),
            ckpt=mgr,
            loop_cfg=LoopConfig(total_steps=LADDER_STEPS,
                                ckpt_every=LADDER_CKPT_EVERY, log_every=1),
            sentinel=recording(StabilitySentinel(SentinelConfig(
                **LADDER_SENTINEL)), verdicts),
            fallback_step=fallback, faults=faults)
        gc.collect()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        ck_bytes = sum(p.stat().st_size for p in ckdir.rglob("*")
                       if p.is_file())
        kept = mgr.all_steps()
        summary = trainer.resilience_summary()
        rec = ladder_record(summary, trainer.history, verdicts)
        for (st, v), r in zip(verdicts, log):
            print(f"train_guarded: loop step {st:2d} {r['kind']:8s} ce "
                  f"{r['ce']:.4f} grad_norm {r['gn']:.4f} {r['ms']:.1f} ms "
                  f"-> {v}")
        print(f"train_guarded: {len(log)} steps run in {wall:.1f} s "
              f"(checkpoints and rollback included); checkpoints kept "
              f"{kept}, {ck_bytes / 2 ** 30:.2f} GiB on disk; resilience "
              f"{summary}")
        print(f"train_guarded: ladder {json.dumps(rec)}")
        print(f"train_guarded: launch counts {counts}")
        if rec != LADDER_EXPECT:
            fail(f"phase 11 ladder {rec} != LADDER_EXPECT {LADDER_EXPECT}")
        want = {"primary": _expect(int8_matmul=linears, int8_matmul_nt=linears,
                                   int8_matmul_tn=linears,
                                   fused_adamw_blocks=1),
                "fallback": _expect(qdq_row=linears, fused_adamw_blocks=1)}
        for i, r in enumerate(log):
            if r["launches"] != want[r["kind"]]:
                fail(f"phase 11 call {i} ({r['kind']}): launches "
                     f"{r['launches']}, expected {want[r['kind']]}")
        if int(trainer.state.opt.step) != LADDER_STEPS:
            fail(f"phase 11 ended at opt.step {int(trainer.state.opt.step)}")
        if not all(bool(torch.isfinite(p).all())
                   for p in tree_flatten(trainer.state.params)[0]):
            fail("phase 11 ended with non-finite params")
        return counts
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        print(f"train_guarded: checkpoint directory removed: "
              f"{not ckdir.exists()}")


def train_resume(torch, dev, seed):
    """Phase 11b: preemption and resume at full width.  ``TRAIN_POLICY``,
    6 steps uninterrupted; then the same run with ``sigterm_run@2`` (the
    SIGTERM handler saves the checkpoint of step 3 and stops), and a third
    run from other weights that resumes from it.  The resumed ce of steps
    4-6, its params and its optimizer state (int8 moments, step) must be
    bit-identical to the uninterrupted run's."""
    import shutil
    import signal
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig
    from repro_torch.train import (FaultPlan, LoopConfig, Trainer,
                                   init_train_state, make_train_step)
    cfg = get_config("gpt2-small")
    model = build_model(cfg)
    total = 6
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=total,
                    state_storage="int")
    step_fn = make_train_step(model, TRAIN_POLICY, opt)
    lcfg = LoopConfig(total_steps=total, ckpt_every=10 ** 9, log_every=1)

    def trainer(s, **kw):
        return Trainer(step_fn, None, init_train_state(
            model, torch.Generator(device=dev).manual_seed(s), TRAIN_POLICY,
            opt, device=dev), Loader(SyntheticCorpus(cfg.vocab_size, seed=7),
                                     cfg, batch_size=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ), loop_cfg=lcfg, **kw)

    def leaves(st):
        return (tree_flatten(st.params)[0] + [st.opt.step]
                + [t for m in (st.opt.m1, st.opt.m2)
                   for leaf in tree_flatten(m)[0]
                   for t in (leaf if isinstance(leaf, tuple) else (leaf,))])

    ckdir = REPO / "build" / "chip_smoke_resume"
    shutil.rmtree(ckdir, ignore_errors=True)
    old = signal.getsignal(signal.SIGTERM)
    try:
        ref = trainer(seed)
        ref.run()
        mgr = CheckpointManager(str(ckdir), async_write=True)
        faults = FaultPlan.parse("sigterm_run@2")
        t1 = trainer(seed, ckpt=mgr, faults=faults)
        t1.install_preemption_handler()
        t1.run()
        saved = mgr.all_steps()
        t2 = trainer(seed + 1, ckpt=CheckpointManager(str(ckdir)))
        at = t2.maybe_resume()
        t2.run()
    finally:
        signal.signal(signal.SIGTERM, old)
        shutil.rmtree(ckdir, ignore_errors=True)
    ref_tail = [r["ce"] for r in ref.history if r["step"] > at]
    got_tail = [r["ce"] for r in t2.history if r["step"] > at]
    same = all(torch.equal(a, b) for a, b in zip(leaves(ref.state),
                                                 leaves(t2.state)))
    print(f"train_resume: preempted {t1._preempted} after loop step 2, "
          f"checkpoints {saved}, resumed at {at}; ce tail {got_tail} vs "
          f"uninterrupted {ref_tail}; params and optimizer state "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not (t1._preempted and saved == [3] and at == 3
            and got_tail == ref_tail and len(got_tail) == total - 3 and same):
        fail("phase 11b: the resumed run is not bit-identical to the "
             "uninterrupted one")


# phase 12: limits of the card against the CPU for one paper_wag8 step on
# gpt2-mini, named like TRAIN_LIMITS.  Each is the geometric mean, to two
# digits, of the sound runs' largest reading (A) and the smallest reading
# of a control that the comparison must tell apart (C: the card at the
# bf16 carrier), over seeds 0-2 as recorded in PERF.md: |d ce| 7.5e-5 /
# 2.0e-4, grads rel L2 3.8e-3 / 1.95e-2, gradient sign differs on 2.4e-3
# / 8.7e-3 of the elements, updates rel L2 9.1e-2 / 0.187 and 6.5e-3 /
# 1.59e-2 where the sign agrees.
FAKE_LIMITS = {"ce": 1.2e-4, "grads": 8.6e-3, "sign_flips": 4.5e-3,
               "updates_sign": 1.0e-2, "updates": 0.13}


def _step_distance(torch, got, ref):
    """How far one train step's result ``got`` lies from ``ref``, keyed
    like ``FAKE_LIMITS``: |d ce|, the gradients' relative L2 distance, the
    share of elements whose gradient sign differs, the updates' relative
    L2 distance over all elements and over those whose sign agrees."""
    upd = lambda r: [a - b for a, b in zip(r["p"], r["p0"])]
    flips, _, u_sign = _update_split(torch, got, ref)
    return {"ce": abs(got["loss"] - ref["loss"]),
            "grads": _rel_l2(torch, got["grads"], ref["grads"]),
            "sign_flips": flips, "updates_sign": u_sign,
            "updates": _rel_l2(torch, upd(got), upd(ref))}


def train_fake_card_vs_cpu(torch, dev, seed):
    """Phase 12: one ``paper_wag8`` train step of gpt2-mini (float32
    carrier, 4 x 128 tokens, fp moments) from ``true_fan_in`` weights
    (seed + 2), as phase 8 does for the int8 recipe.  A: the card (the qdq
    kernels) against the CPU (their plain versions), each distance of
    ``_step_distance`` within ``FAKE_LIMITS``.  B: the card again with
    ``qdq_row`` and ``qdq_scaled`` swapped for their plain versions: every
    gradient bit-identical (control: the card twice).  C: the control of
    A's limits, the same step on the card at the bf16 carrier against the
    same CPU step: every distance above its limit, so A would see a step
    that lost the float32 carrier's precision."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qconfig import get_recipe
    from repro_torch.core.qpolicy import as_policy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    cfg = dataclasses.replace(get_smoke_config("gpt2-small"), dtype="float32")
    model = build_model(cfg)
    params = true_fan_in(model.init_params(
        torch.Generator().manual_seed(seed + 2), device="cpu"), cfg)
    toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=4, seq_len=128))
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    policy = as_policy(get_recipe("paper_wag8"))

    def run(device, swap=(), m=model):
        return one_train_step(torch, m, policy, params, toks, opt,
                              device, swap=swap)

    lim = FAKE_LIMITS
    names = {"ce": "|d ce|", "grads": "grads rel L2",
             "sign_flips": "gradient sign differs on",
             "updates": "updates rel L2",
             "updates_sign": "updates rel L2 where the sign agrees"}
    show = lambda d: ", ".join(f"{names[k]} {d[k]:.3e} (limit {lim[k]:.1e})"
                               for k in names)
    cpu, card = run("cpu"), run(dev)
    dist = _step_distance(torch, card, cpu)
    print(f"train_fake card vs cpu A (gpt2-mini, float32 carrier, 4 x 128 "
          f"tokens, paper_wag8): ce {card['loss']:.6f} vs {cpu['loss']:.6f}, "
          f"{show(dist)}")
    ok = all(dist[k] <= lim[k] for k in lim)
    control = run(dev)
    swapped = run(dev, swap=QDQ_KERNELS)
    same = lambda a, b: all(torch.equal(x, y) for x, y in
                            zip(a["grads"], b["grads"]))
    ctrl_same, swap_same = same(card, control), same(card, swapped)
    print(f"train_fake card vs card B: grads with the plain qdq in the "
          f"kernels' place {'bit-identical' if swap_same else 'DIFFER'} "
          f"(control, the card twice: "
          f"{'bit-identical' if ctrl_same else 'DIFFER'}; tol 0)")
    low = run(dev, m=build_model(dataclasses.replace(cfg, dtype="bfloat16")))
    low_dist = _step_distance(torch, low, cpu)
    low_ok = all(low_dist[k] > lim[k] for k in lim)
    print(f"train_fake control C, the card at the bf16 carrier vs cpu: "
          f"ce {low['loss']:.6f}, {show(low_dist)}: every distance above its "
          f"limit {'yes' if low_ok else 'NO'}")
    if not (ok and ctrl_same and swap_same):
        fail("phase 12: paper_wag8 step card vs CPU / card vs card out of "
             "limits")
    if not low_ok:
        fail("phase 12: the bf16-carrier control lies within FAKE_LIMITS, "
             "so the limits cannot tell it from a sound step")


# ---------------------------------------------------------------------------
# phases 13-15: the fp flash kernels (#7-#10) and the flash_pallas paths
# ---------------------------------------------------------------------------

def _flash_all(fa, q, k, v, do, causal, off):
    """#8's (o, lse), then #9's (dk, dv) and #10's dq from them with delta =
    sum(dO * o); returns (o, lse, dq, dk, dv, delta)."""
    kw = dict(causal=causal, q_offset=off)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return o, lse, dq, dk, dv, delta


def _flash_plain(fa, q, k, v, do, lse, delta, causal, off):
    """The plain versions on the kernels' inputs: #8's on q, k, v, #9's and
    #10's on the lse and delta the kernels read; returns (o, lse, dq, dk,
    dv)."""
    kw = dict(causal=causal, q_offset=off)
    o, lse_p = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw)
    dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    return o, lse_p, dq, dk, dv


def _bf16_distance(torch, got, want):
    """(relative L2 distance, share of elements more than one bf16 step of
    ``want`` apart) of two bfloat16 tensors; a zero in ``want`` has the
    step of 0.5-1."""
    g, w = got.float(), want.float()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    over = ((g - w).abs() > step).float().mean().item()
    return _rel_l2(torch, [got], [want]), over


def _visible_pairs(sq, skv, causal, off):
    """(query, key) pairs the kernels compute: the causally visible ones."""
    if not causal:
        return sq * skv
    return sum(min(skv, off + i + 1) for i in range(sq))


def _flash_case(torch, fa, q, k, v, do, causal, off):
    """One phase-13 case: the kernels against their plain versions on the
    same inputs.  Returns the printed reading and whether it passed."""
    dname = str(q.dtype).replace("torch.", "")
    got = _flash_all(fa, q, k, v, do, causal, off)
    want = _flash_plain(fa, q, k, v, do, got[1], got[5], causal, off)
    again = _flash_all(fa, q, k, v, do, causal, off)
    o7 = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    diff = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got[:5], want)]
    same7 = torch.equal(o7, got[0])
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (diff[0] <= FLASH_TOL[dname] and diff[1] <= FLASH_LSE_TOL
          and same7 and repeat)
    if q.dtype == torch.float32:
        rel = [_rel_l2(torch, [g], [w]) for g, w in zip(got[2:5], want[2:])]
        ok &= max(rel) <= FLASH_GRAD_TOL
        text = (f"dq/dk/dv rel L2 {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e} "
                f"(tol {FLASH_GRAD_TOL:.0e})")
    else:
        # o, dq, dk, dv; then the controls, each one rounding of p moved:
        # the plain forward with p left unrounded, with p rounded against
        # the row's final max (the reference's _ref_attend, one tile), and
        # dv from p rounded to the carrier
        dist = [_bf16_distance(torch, g, w)
                for g, w in zip(got[:1] + got[2:5], want[:1] + want[2:])]
        kw = dict(causal=causal, q_offset=off)
        ctrl_o = fa.flash_attention_fwd_lse_plain(
            q.float(), k.float(), v.float(), **kw)[0].to(q.dtype)
        row_o = fa.flash_attention_fwd_lse_plain(q, k, v, block_k=k.shape[1],
                                                 **kw)[0]
        p, _ = fa._bwd_plain(q, k, v, do, got[1], got[5], causal, off)
        ctrl_dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(),
                               do.float()).to(q.dtype)
        del p
        ctrl = [_bf16_distance(torch, c, w) for c, w in
                ((ctrl_o, want[0]), (row_o, want[0]), (ctrl_dv, want[4]))]
        lim = FLASH_BF16
        within = lambda d: d[0] <= lim["rel_l2"] and d[1] <= lim["over_ulp"]
        outside = lambda d: d[0] > lim["rel_l2"] and d[1] > lim["over_ulp"]
        ok &= all(within(d) for d in dist) and all(outside(d) for d in ctrl)
        text = ("o/dq/dk/dv rel L2 " + "/".join(f"{d[0]:.2e}" for d in dist)
                + f" (limit {lim['rel_l2']:.0e}), over one bf16 step "
                + "/".join(f"{d[1]:.2e}" for d in dist)
                + f" (limit {lim['over_ulp']:.0e}); controls (rel L2, over "
                "one step) p unrounded "
                + ", ".join(f"{c[0]:.2e}, {c[1]:.2e}" for c in ctrl[:1])
                + ", p against the final max "
                + ", ".join(f"{c[0]:.2e}, {c[1]:.2e}" for c in ctrl[1:2])
                + ", dv with p rounded "
                + ", ".join(f"{c[0]:.2e}, {c[1]:.2e}" for c in ctrl[2:])
                + ": all above both limits "
                + ("yes" if all(outside(d) for d in ctrl) else "NO"))
    reading = (f"o max err {diff[0]:.2e} (tol {FLASH_TOL[dname]:.0e}), lse "
               f"{diff[1]:.2e} (tol {FLASH_LSE_TOL:.0e}), {text}; max abs "
               f"dq/dk/dv {diff[2]:.2e}/{diff[3]:.2e}/{diff[4]:.2e}; #7 == #8 "
               f"{'bit for bit' if same7 else 'DIFFERS'}, second launch "
               f"{'bit-identical' if repeat else 'DIFFERS'}")
    return reading, ok, diff


def check_flash(torch, dev, gen, results):
    """Phase 13: the fp flash kernels against their plain versions on the
    card, on the same inputs (``_flash_case``), at the training shape and
    at ``FLASH_SWEEP``, float32 and bfloat16, unit-normal inputs: #8's
    output and LSE, #9's dK/dV and #10's dQ within ``FLASH_TOL`` /
    ``FLASH_LSE_TOL`` / ``FLASH_GRAD_TOL`` (float32) / ``FLASH_BF16``
    (bfloat16, with its two controls outside); #7's output equal to #8's
    bit for bit; a second launch of each kernel equal to its first bit for
    bit; a NaN planted in q reaching o, the LSE and the gradients.  Each
    kernel timed at the training shape (bf16) beside its plain version,
    its bound and SDPA: its forward for #7/#8, its backward for #9 and #10
    together (a yardstick, unused by the port).  The bound counts each
    product at the rate of its operands' type: at hd = 64 and the bf16
    carrier q / 8, k, v, dO and the forward's rounded p are bf16 values,
    so the score products of all four kernels, the forward's P.V and the
    backward's dO.V are exact on the bf16 tensor cores; the backward's
    p^T dO, ds^T q and ds k take fp32 p or ds, at the fp32 CUDA-core
    rate."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    bh, s, hd = TRAIN_BATCH * 12, TRAIN_SEQ, 64
    cases = (("train", bh, s, s, hd, True, 0),) + FLASH_SWEEP
    errs = {}
    ok = True
    for label, b_, sq, skv, d, causal, off in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                           .to(dt) for shape in ((b_, sq, d), (b_, skv, d),
                                                 (b_, skv, d), (b_, sq, d)))
            reading, case_ok, diff = _flash_case(torch, fa, q, k, v, do,
                                                 causal, off)
            ok &= case_ok
            print(f"flash {label:9s} BH={b_:3d} Sq={sq:4d} Skv={skv:4d} "
                  f"hd={d:3d} {'causal' if causal else 'full':6s} "
                  f"q_offset={off:3d} {str(dt)[6:]:8s}: {reading}"
                  f"{'' if case_ok else '  <-- FAIL'}")
            if label == "train" and dt == torch.float32:
                errs = {"flash_attention_fwd": diff[0],
                        "flash_attention_fwd_lse": max(diff[0], diff[1]),
                        "flash_attention_bwd_dkdv": max(diff[3], diff[4]),
                        "flash_attention_bwd_dq": diff[2]}
            del q, k, v, do
    # a NaN in q row 70 of head 1 reaches its o and LSE rows, its dq row and
    # the dk / dv rows it attends to; head 0 stays finite
    q, k, v, do = (torch.randn((2, 256, 64), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    q[1, 70, 5] = float("nan")
    o, lse, dq, dk, dv, _ = _flash_all(fa, q, k, v, do, True, 0)
    nan_ok = (bool(o[1, 70].isnan().all()) and bool(lse[1, 70].isnan())
              and bool(dq[1, 70].isnan().all())
              and bool(dk[1, :71].isnan().all())
              and bool(dv[1, :71].isnan().all())
              and all(bool(t[0].isfinite().all()) for t in (o, dq, dk, dv)))
    print(f"flash NaN planted in q[1, 70]: o, lse, dq row and dk/dv rows "
          f"0-70 {'NaN, head 0 finite' if nan_ok else 'NOT as expected'}")
    ok &= nan_ok
    if not ok:
        fail("phase 13: a flash kernel disagrees with its plain version")

    # timing at the training shape, bf16
    q, k, v, do = (torch.randn((bh, s, hd), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    q4, k4, v4, do4 = (t.view(TRAIN_BATCH, 12, s, hd) for t in (q, k, v, do))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(o4, leaves, do4,
                                                   retain_graph=True))
    pairs = _visible_pairs(s, s, True, 0) * bh
    tens, rows = bh * s * hd * 2, bh * s * 4     # bf16 tensor, fp32 rows
    mm = 2 * hd * pairs                          # one product over the pairs
    plan = (   # name, site line, kernel, plain, bytes, bf16 / fp32 FLOPs
        ("flash_attention_fwd", 116, lambda: fa.flash_attention_fwd(q, k, v),
         lambda: fa.flash_attention_fwd_plain(q, k, v), 4 * tens,
         2 * mm, 0, sdpa_fwd, "SDPA forward"),
        ("flash_attention_fwd_lse", 275,
         lambda: fa.flash_attention_fwd_lse(q, k, v),
         lambda: fa.flash_attention_fwd_lse_plain(q, k, v), 4 * tens + rows,
         2 * mm, 0, sdpa_fwd, "SDPA forward"),
        ("flash_attention_bwd_dkdv", 344,
         lambda: fa.flash_attention_bwd_dkdv(*bwd),
         lambda: fa.flash_attention_bwd_dkdv_plain(*bwd),
         6 * tens + 2 * rows, 2 * mm, 2 * mm, sdpa_bwd,
         "SDPA backward, dq+dk+dv together"),
        ("flash_attention_bwd_dq", 369,
         lambda: fa.flash_attention_bwd_dq(*bwd),
         lambda: fa.flash_attention_bwd_dq_plain(*bwd),
         5 * tens + 2 * rows, 2 * mm, mm, sdpa_bwd,
         "SDPA backward, dq+dk+dv together"))
    for name, line, kern, plain, nbytes, f16, f32, lib, lib_what in plan:
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        bd, by = bound_ms(nbytes, f16, BF16_FLOPS, ((f32, FP32_FLOPS),))
        print(f"{name} BH={bh} S={s} hd={hd} causal bf16: ms {ms:.4f}, "
              f"plain_ms {plain_ms:.4f}, bound_ms {bd:.5f} ({by}; "
              f"{f16 / 1e9:.1f} GFLOP bf16-exact at 989 TFLOP/s + "
              f"{f32 / 1e9:.1f} GFLOP fp32 at 67, {nbytes / 1e6:.1f} MB), "
              f"{ms / bd:.1f}x the bound, library_ms({lib_what}) {lib:.4f}")
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/flash_attn.cu",
            replaces=f"src/repro/kernels/flash_attn.py:{line}",
            tol=FLASH_TOL["float32"], shape=f"BH={bh},S={s},hd={hd},causal",
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bd,
            bound_by=by, library_ms=lib)


def serve_flash(torch, dev, seed):
    """Phase 14b: the dense engine on GPT-2 small with
    ``attention_impl="flash_pallas"`` and an fp KV cache
    (``FLASH_SERVE_POLICY``: W8A8 linears, no ``kv_cache`` role): the first
    ``FLASH_SERVE_REQUESTS`` of phase 4's prompts, ``FLASH_SERVE_NEW`` new
    tokens each.  Every request answered to length; each prefill launch
    runs #8 once per layer, #9/#10 never; decode steps attend through
    ``_attend``.  Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.infer import Engine, Request
    from repro_torch.models import build_model
    cfg, _, params = serve_model(torch, dev, seed)
    cfg = dataclasses.replace(cfg, attention_impl="flash_pallas")
    model = build_model(cfg)
    eng = Engine(model, params, FLASH_SERVE_POLICY, max_slots=SERVE_SLOTS,
                 max_seq=SERVE_SEQ, device=dev, seed=seed)
    prompts = serve_prompts(cfg, seed)[:FLASH_SERVE_REQUESTS]
    ids = [eng.submit(Request(tokens=p, max_new_tokens=FLASH_SERVE_NEW))
           for p in prompts]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = eng.stats
    eng.scheduler.stop()
    if sorted(r.request_id for r in out) != sorted(ids):
        fail("phase 14b: the flash engine did not answer every request")
    for r in out:
        if (len(r.tokens) != FLASH_SERVE_NEW or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"phase 14b request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    want = _expect(int8_matmul=6 * cfg.n_layers * (st["prefill_calls"]
                                                   + st["decode_steps"]),
                   flash_attention_fwd_lse=cfg.n_layers * st["prefill_calls"])
    print(f"serve_flash: {eng.path_summary()}, attention flash_pallas, "
          f"{len(out)} requests (prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens), {FLASH_SERVE_NEW} new tokens "
          f"each, in {wall:.3f} s; prefill {st['prefill_calls']} launches "
          f"{st['prefill_s'] * 1e3:.1f} ms, decode {st['decode_steps']} steps "
          f"{st['decode_s'] * 1e3:.1f} ms; launch counts {counts}")
    if counts != want or not counts["flash_attention_fwd_lse"]:
        fail(f"phase 14b: launches {counts}, expected {want}")
    return counts


def flash_card_vs_cpu(torch, dev, seed):
    """Phase 15: the flash path on the card against the CPU and against
    ``_attend``, float32 carrier, ``*=fp``, weights of ``init_params``
    (seed + 4) at the true fan-in scale (``true_fan_in``).  On gpt2-mini
    (4 x 128 tokens from the synthetic corpus): the train loss and its
    gradients in float32 (``train_loss`` on the float32 params; the train
    step's bfloat16 cast of the master params would round the gradients
    to bf16) of the card's flash kernels against (A) the CPU's plain flash, (B) the card's
    ``_attend`` path and (D) the card with the plain flash versions in the
    kernels' place; (C) ``lm_prefill`` logits (2 x 64 prompt, 80 rows)
    under flash against ``_attend`` on the card.  On GPT-2 small (E): one
    loss and gradient, 2 x 512 tokens, flash against ``_attend`` on the
    card.  Each within ``FLASH_LIMITS``."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten
    lim = FLASH_LIMITS
    ok = True

    def grads(cfg, impl, params, toks, device, swap=()):
        model = build_model(dataclasses.replace(cfg, attention_impl=impl))
        leaves, struct = tree_flatten(params)
        leaves = [t.to(device).requires_grad_(True) for t in leaves]
        with plain_versions(swap):
            loss, _ = model.train_loss(tree_unflatten(struct, leaves),
                                       {"tokens": toks.to(device)},
                                       policy="*=fp")
            g = torch.autograd.grad(loss, leaves)
        return loss.item(), list(g)

    def report(label, a, b):
        d_ce, rel = abs(a[0] - b[0]), _rel_l2(torch, a[1], b[1])
        good = d_ce <= lim["ce"] and rel <= lim["grads"]
        print(f"flash card vs {label}: ce {a[0]:.7f} vs {b[0]:.7f} (|d| "
              f"{d_ce:.3e}, limit {lim['ce']:.0e}), grads rel L2 {rel:.3e} "
              f"(limit {lim['grads']:.0e}){'' if good else '  <-- FAIL'}")
        return good

    for name, cfg, shape in (
            ("gpt2-mini", get_smoke_config("gpt2-small"), (4, 128)),
            ("gpt2-small", get_config("gpt2-small"), (2, 512))):
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = true_fan_in(build_model(cfg).init_params(
            torch.Generator().manual_seed(seed + 4), device="cpu"), cfg)
        toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
            0, batch_size=shape[0], seq_len=shape[1]))
        card = grads(cfg, "flash_pallas", params, toks, dev)
        ok &= report(f"card _attend ({name}, B)",
                     card, grads(cfg, "xla", params, toks, dev))
        if name != "gpt2-mini":
            continue
        ok &= report(f"cpu plain flash ({name}, A)",
                     card, grads(cfg, "flash_pallas", params, toks, "cpu"))
        ok &= report(f"card plain flash ({name}, D)", card,
                     grads(cfg, "flash_pallas", params, toks, dev,
                           swap=FLASH_KERNELS))
        logits = []
        for impl in ("flash_pallas", "xla"):
            model = build_model(dataclasses.replace(cfg, attention_impl=impl))
            p = tree_map(lambda t: t.to(dev), params)
            lg, _ = model.prefill(p, toks[:2, :64].to(dev), policy="*=fp",
                                  max_seq=80)
            logits.append(lg[:, :cfg.vocab_size].float().cpu())
        err = (logits[0] - logits[1]).abs().max().item()
        good = err <= lim["logits"] and bool(torch.isfinite(logits[0]).all())
        print(f"flash card vs card _attend ({name}, C): lm_prefill logits "
              f"max |d| {err:.3e} (limit {lim['logits']:.0e})"
              f"{'' if good else '  <-- FAIL'}")
        ok &= good
    if not ok:
        fail("phase 15: the flash path out of FLASH_LIMITS")


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
    check_qdq(torch, dev, gen, results)
    fake_counts = train_fake(torch, dev, args.seed)
    guarded_counts = train_guarded(torch, dev, args.seed)
    train_resume(torch, dev, args.seed)
    train_fake_card_vs_cpu(torch, dev, args.seed)
    check_flash(torch, dev, gen, results)
    flash_counts = train(torch, dev, args.seed, impl="flash_pallas")
    serve_flash_counts = serve_flash(torch, dev, args.seed)
    flash_card_vs_cpu(torch, dev, args.seed)

    # launches: each kernel's count on the main paths, dense serving (phase
    # 4), paged serving (phase 4b), training on the int8 kernels (phase 7),
    # fake-quant training (phase 10), the guarded path (phase 11), flash
    # training (phase 14) and flash-prefill serving (phase 14b), each
    # path's counts read right after its run
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    kern = []
    for name in KERNEL_NAMES:
        by_path = {"serve": serve_counts[name],
                   "serve_paged": paged_counts[name],
                   "train": train_counts[name],
                   "train_fake": fake_counts[name],
                   "train_guarded": guarded_counts[name],
                   "train_flash": flash_counts[name],
                   "serve_flash": serve_flash_counts[name]}
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
