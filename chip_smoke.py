#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build the CUDA kernel libraries of ``_build.SOURCES`` (ten sources
   under ``src/repro_torch/csrc``, one nvcc each, all at once;
   ``int8_matmul.cu`` holds the forward's two routes -- the decode step's
   split-K weight stream reduced in a thread-block cluster (one kernel,
   also the fused entry that quantizes fp activations per token), its
   weight transpose and int8 tensor-core GEMM (``gemm_s8.cuh``, shared with
   the backward) -- and the first CUDA-core dp4a kernel; ``decode_attn.cu``
   the dense and the paged decode kernels; ``flash_attn.cu`` the float32 flash
   forward and both backward kernels; ``flash_fwd_sm90.cu`` and
   ``flash_bwd_sm90.cu`` the bf16 flash forward and backward on the tensor
   cores; ``flash_q8_sm90.cu`` the bf16 int8-KV prefill on the tensor
   cores, ``flash_attn_q8.cu`` its float32 instance; ``int8_matmul_bwd.cu``
   the int8 backward's quantize passes) and print the build time;
2. print the card's name and power limit (nvidia-smi);
3. hold each serving kernel against its plain PyTorch version on the card
   at the serving path's shapes, and time kernel, plain version and a
   library yardstick (``torch._int_mm``; SDPA on dequantized K/V) beside
   the bound computed from the inputs' bytes and operations:
   ``int8_matmul`` bit for bit on both its routes (the cluster route up
   to 16 rows, a repeat bit-identical) and the first dp4a kernel at M =
   16, 17, 32, 64, 2048 and 8192, bf16 and float32 output, each timed call
   by call and queued (``queued_ms``), at M = 16 also over the decode
   step's 72 weights with the L2 cold; the fused decode entry
   ``int8_quant_matmul`` bit for bit at M = 1, 7 and 16, both carriers,
   and on rows holding a NaN or an infinity, timed against quantize_int +
   ``int8_matmul``; the forward's GEMM kernels holding
   ``IGMMA``, the cluster kernels ``IMMA`` (``check_int8_matmul``);
   ``flash_attention_fwd_q8`` at the serving gate
   and the engine's shapes, bf16 within one bf16 step and its output
   before the cast within ``Q8_TOL``, float32 within ``Q8_TOL``, timed
   beside the CUDA-core kernel at bf16, the ``flash_q8_sm90`` kernels holding
   ``HGMMA`` (``check_flash_q8``); ``decode_attention`` at 16 slots of 1024
   rows with positions on its chunk edges, within 1e-3 at float32 (one bf16
   step at bf16), the written rows bit for bit, a second launch
   bit-identical, timed queued and call by call beside SDPA
   (``check_decode_attention``); 3b. the paged decode kernel the same way
   at pages of 16, 64 and 256 rows, and bit for bit against the dense
   decode kernel on the same logical cache
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
   at M = 8192 tokens (the three (K, N) at bf16, (768, 768) at fp32), a
   second launch bit-identical to the first -- and time each beside its
   bound, its plain version and a yardstick (``torch._int_mm`` on int8
   operands of the same contraction), with the card's queue full, and each
   of their stages (quantize pass, int8 GEMM, split reduction) timed alone;
   every GEMM kernel of ``int8_matmul_bwd.cu`` holds integer wgmma
   (``IGMMA``) in its SASS (``cuobjdump``), or the phase fails
   (``check_int8_bwd``); 6b. the fused AdamW kernel's two entries:
   ``fused_adamw_blocks`` on a bucket of GPT-2 small's size and
   ``fused_adamw_leaves`` on GPT-2 small's own leaves (two steps, the
   second reading the first's views), each bit for bit in params, payloads,
   scales and zero points, the update-norm sum within 1e-5 relative, a
   repeat bit-identical, timed queued beside the byte bound and the plain
   version (no PyTorch yardstick); the kernel holds bulk copies
   (``UBLKCP``) in its SASS, or the phase fails; then ``adamw_update``'s
   device time on GPT-2 small and its kernels by kind
   (``check_fused_adamw``);
7. train GPT-2 small at full width and depth (random weights from
   ``--seed``, bf16 carrier, 8 x 1024 tokens a step from the port's
   synthetic corpus, the paper's W8/A8/G8 recipe on the int8 kernels with
   blockwise 8-bit Adam moments) for 10 steps: ce, grad norm and ms per
   step, tokens/s, peak memory and, over one profiled step, the device's
   idle share; every ce and grad norm must be finite and each training
   kernel (nt, tn, the forward, ``fused_adamw_leaves``) must launch
   exactly 72 / 72 / 72 / 1 times a step (and the serving kernels and the
   bucket entry ``fused_adamw_blocks`` never);
8. one train step on gpt2-mini, card against CPU (see
   ``train_card_vs_cpu`` for the checks and their limits);
9. the fake-quant gradient kernels ``qdq_row`` and ``qdq_scaled`` bit for
   bit against their plain versions at the gradients' shapes, timed with
   the L2 cold, queued and call by call, beside their bound, plain version
   and a fake-quantize yardstick; ``qdq_row``'s streaming kernel holds bulk
   copies (``UBLKCP``) in its SASS, or the phase fails (``check_qdq``);
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
    and, at bfloat16, ``FLASH_BF16`` with five controls outside it; #7
    equal to #8, repeats bit-identical, a planted NaN propagated; each
    timed beside its bound (the least the tensor cores need), plain
    version and SDPA (the backward also with the card's queue full), and
    #8, #9 and #10 also at hd 128 (BH 16, S 512); the bf16 forward's and
    backward's kernels hold ``HGMMA`` instructions in their SASS
    (``cuobjdump``), or the phase fails (``check_flash``);
14. phase 7 with ``attention_impl="flash_pallas"``: 10 finite steps, each
    launching exactly 72 / 72 / 72 / 1 int8 and AdamW kernels and #8, #9,
    #10 12 times (``train(impl="flash_pallas")``); 14b. the dense engine
    with an fp KV cache and the flash setting: 8 of phase 4's prompts
    answered to length, #8 12 times per prefill launch, #9/#10 never
    (``serve_flash``);
15. the flash path at float32 under ``*=fp`` against the CPU, against
    ``_attend`` and against its plain versions on the card, within
    ``FLASH_LIMITS`` (``flash_card_vs_cpu``);
16. the llama family at Yi-6B's full width (``configs/yi_6b.py``: 32
    layers, d_model 4096, 32 query heads over 4 KV heads of 128, the gated
    MLP's 11,008, RoPE, RMSNorm, an untied head of 64,000): 16a. the four
    serving kernels at Yi's shapes with phase 3's gates -- ``int8_matmul``
    bit for bit at ``YI_INT8_KN`` x M = 16 and 2048, its fused decode entry
    at M = 16 on finite rows and on rows holding a NaN or an infinity, the
    weight transpose of its tensor-core route and an L2-cold round over the
    decode step's linears timed alone; ``flash_attention_fwd_q8`` at
    ``YI_Q8_SHAPE``; ``decode_attention`` and ``decode_attention_paged`` at
    ``YI_DECODE_SHAPE`` (pages of 16, 64, 256 bit for bit against the dense
    kernel), each timed beside its bound and SDPA on dequantized K/V with
    the KV heads expanded (``yi_kernels``); 16b. serve Yi-6B (random
    float32 weights from ``--seed``, freed once prepared; bf16 carrier,
    ``POLICY``) through the dense engine, 16 slots of 4096 rows, 32
    requests of 128-2048 prompt tokens, 64 new tokens each: every request
    to length, exactly 224 ``int8_matmul`` and 32 ``decode_attention`` a
    decode step and 224 and 32 ``flash_attention_fwd_q8`` a prefill launch;
    decode ms/step, tokens/s, prefill ms, peak memory, one profiled decode
    step and the untied head's share (``serve_yi``); 16c. the same requests
    through the paged engine (pages of 64 rows): 16b's tokens, 32
    ``decode_attention_paged`` a step, every page back
    (``serve_yi_paged``); 16d. phase 5's checks at Yi's width and 2 layers,
    its limits but B's, which is ``YI_B_LIMIT`` there (``yi_card_vs_cpu``);
17. the serving degradation ladder on GPT-2 small (phase 4's weights):
    17a. an engine whose rung 0 is dequantize-on-read (``DEQUANT_POLICY``,
    a per-tensor KV spec no kernel takes), dense and paged, 32 requests of
    one prefill bucket (``ladder_prompts``): ``kv=int8-dequant`` /
    ``kv=int8-paged-gather(p64)``, exactly 72 ``int8_matmul`` a decode
    step and a prefill launch and no other kernel, paged tokens bit-equal
    to dense for every request (``serve_dequant``); 17b. the
    dequant path card against CPU (phase 5's A limit), and an a8t model's
    dequant path against its fused path on the card within
    ``DEQUANT_FUSED_LIMIT``, a bf16-carrier control outside it
    (``dequant_card_vs_cpu``); 17c. ``SERVE_LADDER_PLAN`` on ``POLICY``
    dense and paged: the walk equals ``SERVE_LADDER_EXPECT``, two kernel
    errors, two ``numerics``, #12/#13 12 times a fused-rung step, #11 12
    times a prefill launch, paged tokens and finish reasons equal to
    dense for every request, each rung's decode ms/step (``serve_ladder``);
    17d.
    ``SERVE_OOM_PLAN`` on the paged engine: a preemption, never a
    ``CapacityError``, every request to length and every page back
    (``serve_oom``).  Every healthy serving phase (4, 4b,
    4c, 14b, 16b, 16c, 17a, 17d) fails unless it ends with no kernel error,
    no demotion and rung 0 (``healthy``);
18. llama pre-training at Yi-6B's published widths (random weights from
    ``--seed``, bf16 carrier, ``TRAIN_POLICY`` with int moments, the
    synthetic corpus), the loss recomputing as the reference's
    (``cfg.remat``: per-layer checkpoints that keep the attention context,
    checkpointed CE chunks, ``_attend`` in checkpointed q-chunks): 18a.
    ``YI_TRAIN_LAYERS`` of its 32 layers, 2 x 4096 tokens a step,
    ``flash_pallas``, 6 finite steps, each launching exactly
    ``train_launches`` (14 #3 a layer: each linear again in the
    recomputation; 2 #8 a layer), ms/step, tokens/s, peak memory, one
    profiled step (``train_yi``); 18b. at 4 layers, recomputation on
    against off: ce and every gradient bit-identical, the peak lower
    (``yi_remat``); 18c. ``_attend`` in q-chunks of 1024 rows against one
    block (the score budget lifted) at 4 layers x 1 x 4096 tokens within
    ``YI_CHUNK_LIMITS``, then 18a's shape under ``_attend`` (chunks of 512)
    for 2 finite steps (``yi_attend_chunks``); 18d. phase 8's checks at
    Yi's width and 2 layers within ``YI_TRAIN_LIMITS`` (C's asymmetric
    moments dequantized where their zero points differ), and phase 12's
    bf16-carrier control (``yi_train_card_vs_cpu``).

Phases 7, 10, 11 and 14 pin ``remat=False`` (``gpt2_train_cfg``), so
their launch gates (72 #3 a step) and their numbers keep their meaning;
their CE chunks are checkpointed, as in the reference.

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
TRAIN_KERNELS = ("int8_matmul_nt", "int8_matmul_tn", "fused_adamw_leaves")
QDQ_KERNELS = ("qdq_row", "qdq_scaled")
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
KERNEL_NAMES = SERVE_KERNELS + TRAIN_KERNELS + ("fused_adamw_blocks",) \
    + ("decode_attention_paged",) \
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
#: phase 17: the serving degradation ladder.  17a serves under a KV spec
#: no kernel takes (per tensor), so rung 0 is dequantize-on-read; 17c walks
#: the ladder of ``POLICY`` under ``SERVE_LADDER_PLAN`` with the monitor's
#: re-probe after ``SERVE_LADDER_REPROBE`` healthy steps, on the first
#: ``SERVE_LADDER_REQUESTS`` of 17a's prompts; 17d drains the paged pool
#: under ``SERVE_OOM_PLAN``.  17a's and 17c's prompts all lie in the
#: prefill bucket of ``LADDER_PROMPT_LENS`` (one page multiple), so a
#: request's prefill write block and its slot are the same in the dense and
#: the paged engine, and their tokens must be equal for every request
DEQUANT_POLICY = "kv_cache=a8n,*=w8c+a8t@int8_cuda"
SERVE_LADDER_PLAN = ("kernel_error@4;kernel_error@6;nan_logit@26:slot=0;"
                     "nan_logit@27:slot=1;slow_step@40:ms=20")
SERVE_LADDER_REPROBE = 8
SERVE_LADDER_REQUESTS = 16
LADDER_PROMPT_LENS = (257, 512)
SERVE_OOM_PLAN = "oom_pages@10:hold=2"
#: the walk that plan takes, (decode step, from rung, to rung) in step
#: order: the two kernel errors demote twice, 8 healthy steps promote
#: twice, the second quarantine inside the numeric window demotes once
#: more and 8 healthy steps promote again.
#: tests/test_torch_serve_ladder.py holds it equal to the JAX engine's walk
#: on the same plan and monitor settings.
SERVE_LADDER_EXPECT = [[4, "fused", "dequant"], [6, "dequant", "fp"],
                       [13, "fp", "dequant"], [21, "dequant", "fused"],
                       [27, "fused", "dequant"], [35, "dequant", "fused"]]
#: phase 17b: limit on max |d logit| of the dequantize-on-read rung against
#: the fused rung on the card (an a8t model, float32 carrier,
#: ``true_fan_in`` weights), set from readings at seeds 0-3
#: (``tools/dequant_readings.py``, PERF.md): 6.0e-4 to 2.07e-3, the
#: bf16-carrier control 2.91e-2 to 3.20e-2; the limit sits 3.9x above the
#: largest reading and 3.6x below the smallest control, which must exceed it
DEQUANT_FUSED_LIMIT = 8e-3


def serve_walk(summary):
    """A serving engine's ladder transitions from its
    ``resilience_summary()``, as ``SERVE_LADDER_EXPECT`` lists them; the
    same for the port's engine and the JAX package's."""
    moves = summary["demotions"] + summary["promotions"]
    return [[d["step"], d["from"], d["to"]]
            for d in sorted(moves, key=lambda d: d["step"])]


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
#: kernel's key tiles, as the kernel does, and sums each score in float64
#: before rounding it to fp32; the plain backward sums its five products
#: in float64, and delta (sum(dO * o), an input of both) is summed in
#: float64 too (_flash_all), so that nothing compared carries an fp32
#: summation order of its own (cuBLAS's fp32 order alone lies up to 1.6e-4
#: rel L2 and 4.8e-4 over one step from the forward's, PERF.md; with delta
#: summed in fp32, dq's row 0 under the causal mask is rounding noise).
#: Five controls that move one rounding of p or ds must exceed both
#: limits: the plain forward with p left unrounded, the plain forward
#: rounding p against the row's final max (the reference's _ref_attend),
#: #9's dv with p rounded to bf16, and #9's dk and #10's dq with ds rounded
#: to bf16.
#: Readings on the H100 at every phase-13 shape (PERF.md, call 3 of PR
#: 18): o from the tensor-core forward at most 1.35e-4 and 1.35e-4, dq, dk
#: and dv from the tensor-core backward at most 6.25e-5 and 3.24e-5 (the
#: plain backward with fp32 sums: 6.78e-5 and 3.43e-5), controls at least
#: 9.26e-4 and 3.42e-2; the rel L2 limit sits 1.5x above the largest sound
#: reading and 4.6x below the smallest control, the step limit 7.4x and
#: 34x.
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


def bound_ms(nbytes: float, ops: float, rate: float):
    """Least time for the work: the larger of bytes over memory rate and
    operations over peak rate; returns (ms, 'bytes' | 'operations')."""
    t_mem = nbytes / HBM_BPS
    t_ops = ops / rate
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


def healthy(eng, label: str) -> None:
    """A serving phase on the healthy path: no decode step failed, the
    ladder never moved and rung 0 ran to the end (the ladder must not hide
    a failing kernel)."""
    s = eng.resilience_summary()
    if s["kernel_errors"] or s["demotions"] or s["rung_index"]:
        fail(f"{label}: the healthy path degraded: kernel_errors "
             f"{s['kernel_errors']}, demotions {s['demotions']}, rung "
             f"{s['rung']} ({s['rung_index']})")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")


#: phase 3: the forward's shapes -- the decode step's 16 slots, M = 17, 32
#: and 64 past the cluster route's limit, a prefill of 2048 rows and the
#: training step's 8192 tokens -- at GPT-2 small's three (K, N), bf16
#: output; and float32 output at (768, 768)
INT8_FWD_ROWS = (16, 17, 32, 64, 2048, 8192)
INT8_FWD_KN = ((768, 768), (768, 3072), (3072, 768))
#: the decode step's 72 weights: per layer wq, wk, wv and wo (768, 768), w1
#: (768, 3072) and w2 (3072, 768) -- 85 MB, more than the 50 MB L2
DECODE_STEP_KN = ((768, 768),) * 4 + ((768, 3072), (3072, 768))
#: the fused decode entry's rows: one slot, a ragged count, all 16 slots
INT8_QUANT_ROWS = (1, 7, 16)


def _int8_case(torch, dev, gen, m, k, n):
    """int8 payloads x (m, k), w (k, n) and scales rs (m, 1), cs (1, n),
    every 7th row scale 0 (the guard maps it to 1)."""
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    rs = torch.rand((m, 1), generator=gen, device=dev) * 0.05
    cs = torch.rand((1, n), generator=gen, device=dev) * 0.01
    rs[::7] = 0.0
    return x, w, rs, cs


def check_int8_matmul(torch, dev, gen, results):
    """Phase 3, #3: the wrapper (its route by ``fwd_route``), both routes --
    the cluster's split-K weight stream (M <= ``FWD_GEMV_MAX_M``) and the
    tensor-core one (transpose pass + s8 wgmma GEMM) -- and the first dp4a
    kernel, bit for bit against the plain version at every shape and output
    dtype, the cluster route's repeat bit-identical; each timed call by call
    and with the card's queue full (``queued_ms``), every route at every M it
    takes, beside the bound, the plain version and ``torch._int_mm``
    (queued; it takes M > 16 only, so at M = 16 on x zero-padded to 17
    rows).  At M = 16: the cluster sizes 1-8 queued, and a round over the
    decode step's 72 distinct weights (``DECODE_STEP_KN``, the L2 cold) per
    call.  The fused entry ``int8_quant_matmul`` bit for bit against its
    plain version at ``INT8_QUANT_ROWS``, both carriers, an all-zero row
    included, and on rows holding a NaN or an infinity, timed against the
    unfused chain.  The forward's GEMM kernels hold ``IGMMA`` in their
    SASS, the cluster kernels ``IMMA``."""
    import importlib
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    from repro_torch.core.qconfig import Granularity, QuantSpec
    from repro_torch.core.quantizer import quantize_int
    rows = []
    cases = [(m, k, n, torch.bfloat16) for m in INT8_FWD_ROWS
             for k, n in INT8_FWD_KN]
    cases += [(m, 768, 768, torch.float32) for m in INT8_FWD_ROWS]
    for m, k, n, dt in cases:
        x, w, rs, cs = _int8_case(torch, dev, gen, m, k, n)
        want = im.int8_matmul_plain(x, w, rs, cs, out_dtype=dt)
        route = im.fwd_route(m, n, k)
        routes = {"wgmma": im.int8_matmul_wgmma, "dp4a": im.int8_matmul_dp4a}
        if m <= im.FWD_GEMV_MAX_M:
            routes["gemv"] = im.int8_matmul_gemv
        got = {"wrapper": im.int8_matmul(x, w, rs, cs, out_dtype=dt),
               **{r: f(x, w, rs, cs, dt) for r, f in routes.items()}}
        if "gemv" in routes:
            got["gemv repeat"] = im.int8_matmul_gemv(x, w, rs, cs, dt)
        torch.cuda.synchronize()
        err = max((g.float() - want.float()).abs().max().item()
                  for g in got.values())
        for name, g in got.items():
            if not torch.equal(g, want):
                fail(f"int8_matmul ({name}) M={m} K={k} N={n} {dt} not "
                     f"bit-exact (max err {err})")
        route_ms = {r: queued_ms(lambda f=f: f(x, w, rs, cs, dt))
                    for r, f in routes.items()}
        call_ms = {r: time_ms(lambda f=f: f(x, w, rs, cs, dt))
                   for r, f in routes.items()}
        plain = time_ms(lambda: im.int8_matmul_plain(x, w, rs, cs, dt),
                        iters=3)
        # torch._int_mm (int8 x int8 -> int32, no epilogue) takes M > 16:
        # at M <= 16 it runs on x zero-padded to 17 rows, padded here
        xl = (x if m > 16 else torch.nn.functional.pad(x, (0, 0, 0, 17 - m)))
        lib = queued_ms(lambda: torch._int_mm(xl, w))
        es = 2 if dt == torch.bfloat16 else 4
        b, by = bound_ms(m * k + k * n + 4 * (m + n) + es * m * n,
                         2.0 * m * n * k, INT8_OPS)
        row = dict(
            shape=f"M={m},K={k},N={n},{str(dt)[6:]}", fwd_route=route,
            max_abs_err=err, ms=route_ms[route], ms_call=call_ms[route],
            route_ms=route_ms, route_ms_call=call_ms,
            splits=im.gemm_splits(m, n, k), plain_ms=plain, bound_ms=b,
            bound_by=by, library_ms=lib,
            library="torch._int_mm" + ("" if m > 16 else
                                       " on x zero-padded to 17 rows"))
        if m == 16 and dt == torch.bfloat16:
            row["gemv_splits_ms"] = {
                s: queued_ms(lambda s=s: im.int8_matmul_gemv(
                    x, w, rs, cs, dt, splits=s))
                for s in (1, 2, 4, 8)}
        rows.append(row)
        line = "; ".join(f"{r} {route_ms[r]:.4f} / {call_ms[r]:.4f}"
                         for r in routes)
        print(f"int8_matmul M={m:5d} K={k:4d} N={n:4d} {str(dt)[6:]}: "
              f"bit-exact on every route (tol 0), route {route}; queued / "
              f"call by call ms: {line} ({im.gemm_splits(m, n, k)} GEMM "
              f"split(s)); plain_ms {plain:.4f}, bound_ms {b:.5f} ({by}), "
              f"library_ms ({row['library']}, queued) {lib:.4f}")
        if "gemv_splits_ms" in row:
            print(f"int8_matmul M=16 K={k} N={n}: cluster sizes, queued ms "
                  + ", ".join(f"{s}: {t:.4f}"
                              for s, t in row["gemv_splits_ms"].items()))
    cold = _int8_decode_round(torch, dev, gen, im)
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    fused = _int8_quant_check(torch, dev, gen, im, spec, quantize_int)
    host = _int8_host_us(torch, dev, gen, im, spec, quantize_int)
    counts = sass_counts("int8_matmul", "IGMMA")
    gemm = {fn: c for fn, c in counts.items() if "gemm_s8_kernel" in fn}
    print(f"int8_matmul SASS: {sum(gemm.values())} IGMMA instructions over "
          f"{len(gemm)} GEMM kernels (each "
          f"{min(gemm.values(), default=0)}-{max(gemm.values(), default=0)})")
    if not gemm or min(gemm.values()) == 0:
        fail(f"phase 3: a forward GEMM kernel has no IGMMA: {gemm}")
    gv = {fn: c for fn, c in sass_counts("int8_matmul", "IMMA").items()
          if "gemv_s8_kernel" in fn}
    print(f"int8_matmul SASS: {sum(gv.values())} IMMA instructions over "
          f"{len(gv)} cluster kernels (each "
          f"{min(gv.values(), default=0)}-{max(gv.values(), default=0)})")
    if not gv or min(gv.values()) == 0:
        fail(f"phase 3: a cluster kernel has no IMMA: {gv}")
    # the JSON entry reports the shape with the most launches on the main
    # path: the decode step's wq, wk, wv and wo at M = 16 slots (4 of every
    # 6 decode launches); kernels.json keeps every shape
    results["int8_matmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:84", tol=0.0,
        shapes=rows, l2_cold=cold, fused_entry=fused, host_us=host, **rows[0])


def _int8_decode_round(torch, dev, gen, im):
    """The decode step's 72 weights at M = 16, each its own buffer (85 MB
    together, so every call finds its weight out of the L2): ms per call
    over the round for the cluster route, the first dp4a kernel and the
    tensor-core route, back to back and queued, beside the round's bound."""
    args = []
    for _ in range(12):
        for k, n in DECODE_STEP_KN:
            x, w, rs, cs = _int8_case(torch, dev, gen, 16, k, n)
            args.append((x, w, rs, cs, torch.bfloat16))
    nbytes = sum(x.numel() + w.numel() + 4 * (16 + w.shape[1])
                 + 2 * 16 * w.shape[1] for x, w, *_ in args)
    out = {"weights": len(args), "weight_bytes": sum(a[1].numel()
                                                     for a in args),
           "bound_ms": nbytes / HBM_BPS * 1e3 / len(args)}
    for r, f in (("gemv", im.int8_matmul_gemv), ("dp4a", im.int8_matmul_dp4a),
                 ("wgmma", im.int8_matmul_wgmma)):
        out[r] = {"ms_call": time_cold_ms(f, args, 2 * len(args), len(args)),
                  "ms": time_cold_ms(f, args, 2 * len(args), len(args),
                                     queued=True)}
    print(f"int8_matmul L2 cold, a round over the decode step's "
          f"{len(args)} weights ({out['weight_bytes'] / 1e6:.1f} MB) at M = "
          f"16, ms per call queued / call by call: "
          + "; ".join(f"{r} {out[r]['ms']:.4f} / {out[r]['ms_call']:.4f}"
                      for r in ("gemv", "dp4a", "wgmma"))
          + f"; bound {out['bound_ms']:.5f} (bytes)")
    return out


def host_us(fn, iters: int = 500, warmup: int = 20) -> float:
    """Host microseconds per call: the host clock around ``iters`` calls,
    which the card keeps up with (each call's kernels are shorter than its
    dispatch), then one synchronize outside the window."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _int8_host_us(torch, dev, gen, im, spec, quantize_int):
    """Where a decode linear's host time goes, at M = 16, (768, 3072), bf16:
    the fused entry, the unfused chain and the cluster route's wrapper, and
    the stream lookup every wrapper makes (``_build.stream_of`` against a
    ``torch.cuda.Stream`` object's handle)."""
    from repro_torch.kernels import _build
    x, w, rs, cs = _int8_case(torch, dev, gen, 16, 768, 3072)
    xf = torch.randn((16, 768), generator=gen, device=dev).to(torch.bfloat16)
    dt = torch.bfloat16

    def chain():
        xq, sc, _ = quantize_int(xf, spec)
        return im.int8_matmul(xq, w, sc, cs, dt)
    out = {"int8_quant_matmul": host_us(
               lambda: im.int8_quant_matmul(xf, w, cs, spec, dt)),
           "quantize_int + int8_matmul": host_us(chain),
           "int8_matmul_gemv": host_us(
               lambda: im.int8_matmul_gemv(x, w, rs, cs, dt)),
           "_build.stream_of": host_us(lambda: _build.stream_of(x)),
           "torch.cuda.current_stream(dev).cuda_stream": host_us(
               lambda: torch.cuda.current_stream(dev).cuda_stream)}
    print("int8_matmul host us per call at M = 16, K = 768, N = 3072: "
          + "; ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def _int8_quant_check(torch, dev, gen, im, spec, quantize_int):
    """The fused decode entry at ``INT8_QUANT_ROWS`` x GPT-2's three (K, N)
    x both carriers, an all-zero row wherever M > 1: bit for bit against
    ``int8_quant_matmul_plain`` (quantize_int + the plain matmul), a
    repeat bit-identical; at M = 16 timed queued and call by call, and the
    unfused chain (quantize_int + int8_matmul) call by call.  Then at M = 16
    rows holding a NaN, +inf, -inf, or a NaN and an inf, against the plain
    version: NaN where it has NaN, the same bits elsewhere."""
    out = []
    for m in INT8_QUANT_ROWS:
        for k, n in INT8_FWD_KN:
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.randn((m, k), generator=gen, device=dev)
                     * 3).to(dt)
                if m > 1:
                    x[m // 2] = 0.0
                _, w, _, cs = _int8_case(torch, dev, gen, m, k, n)
                want = im.int8_quant_matmul_plain(x, w, cs, spec, dt)
                got = im.int8_quant_matmul(x, w, cs, spec, dt)
                again = im.int8_quant_matmul(x, w, cs, spec, dt)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(again, got)):
                    fail(f"int8_quant_matmul M={m} K={k} N={n} {dt}: not "
                         f"bit-exact or a repeat differs (max err "
                         f"{(got.float() - want.float()).abs().max().item()})")
                if m != 16:
                    continue

                def chain():
                    xq, sc, _ = quantize_int(x, spec)
                    return im.int8_matmul(xq, w, sc, cs, dt)
                fused = (lambda: im.int8_quant_matmul(x, w, cs, spec, dt))
                row = dict(shape=f"M={m},K={k},N={n},{str(dt)[6:]}",
                           ms=queued_ms(fused), ms_call=time_ms(fused),
                           chain_ms_call=time_ms(chain))
                out.append(row)
                print(f"int8_quant_matmul {row['shape']}: bit-exact (tol 0) "
                      f"at M = {', '.join(map(str, INT8_QUANT_ROWS))}, a "
                      f"repeat bit-identical; fused ms queued {row['ms']:.4f}"
                      f", call by call {row['ms_call']:.4f}; quantize_int + "
                      f"int8_matmul call by call {row['chain_ms_call']:.4f}")
    bad = {3: [(767, float("nan"))], 5: [(0, float("inf"))],
           9: [(384, float("-inf"))],
           11: [(1, float("nan")), (2, float("inf"))]}
    for k, n in INT8_FWD_KN:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((16, k), generator=gen, device=dev) * 3).to(dt)
            for r, cells in bad.items():
                for c, v in cells:
                    x[r, c * k // 768] = v
            _, w, _, cs = _int8_case(torch, dev, gen, 16, k, n)
            want = im.int8_quant_matmul_plain(x, w, cs, spec, dt)
            got = im.int8_quant_matmul(x, w, cs, spec, dt)
            same = (got == want) | (got.isnan() & want.isnan())
            if not (bool(same.all()) and bool(got[[3, 11]].isnan().all())):
                fail(f"int8_quant_matmul K={k} N={n} {dt}: rows holding a "
                     f"NaN or an infinity differ from the plain version")
    print("int8_quant_matmul: rows holding a NaN or an infinity match the "
          "plain version (NaN where it has NaN, the same bits elsewhere) at "
          "M = 16, GPT-2's three (K, N), both carriers")
    return out


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


def _decode_pos(torch, dev, gen, b, s):
    """Phase 3's ragged positions: pos 0 (slot 0), a full slot (pos == S,
    the clamped write), the kernel's chunk edges 1, C - 1, C, C + 1 and S -
    1, the rest drawn from [1, S)."""
    from repro_torch.kernels.decode_attn import DECODE_CHUNK as c
    pos = torch.randint(1, s, (b,), generator=gen, device=dev)
    edges = [0, s, 1, c - 1, c, c + 1, s - 1]
    pos[:len(edges)] = torch.tensor(edges, device=dev)
    return pos.to(torch.int32)


def _decode_times(torch, fn, plain, sdpa, nbytes, ops):
    """#12 / #13 timed queued and call by call, its plain version, SDPA
    queued and call by call, and the bound."""
    bd, by = bound_ms(nbytes, ops, FP32_FLOPS)
    return dict(ms=queued_ms(fn), ms_call=time_ms(fn),
                plain_ms=time_ms(plain, iters=5), bound_ms=bd, bound_by=by,
                library_ms=queued_ms(sdpa), library_ms_call=time_ms(sdpa))


def _decode_cost(q, nk, pos, kh, hd, g, extra=0):
    """Bytes (each live cache row's payloads and scales, q and ctx, the
    new rows read, the written row, pos; ``extra`` more) and fp32 FLOPs of
    one decode step."""
    b = q.shape[0]
    rows = pos.clamp(0, None).long()
    row_bytes = kh * (hd + 4)
    nbytes = (2 * int(rows.sum()) * row_bytes + 2 * q.numel() * 2
              + 2 * nk.numel() * 2 + 2 * b * row_bytes + 4 * b + extra)
    return nbytes, 4.0 * hd * g * kh * float((rows + 1).sum())


def _sdpa_yardstick(torch, dev, q, kq, ks, vq, vs, pos):
    """SDPA over K/V dequantized beforehand, the KV heads expanded to the
    query heads (neither timed), the decode step's valid rows unmasked."""
    import torch.nn.functional as F
    b, kh, g, hd = q.shape
    s = kq.shape[1]
    # the KV heads expanded to the query heads (KV-major groups)
    kd = _dequant(torch, kq, ks).bfloat16().permute(0, 2, 1, 3
                                                    ).repeat_interleave(g, 1)
    vd = _dequant(torch, vq, vs).bfloat16().permute(0, 2, 1, 3
                                                    ).repeat_interleave(g, 1)
    qs = q.reshape(b, kh * g, 1, hd)
    mask = (torch.arange(s, device=dev)[None, :] < pos[:, None].clamp(min=1)
            )[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)


def _time_line(t) -> str:
    return (f"queued ms {t['ms']:.4f} (call by call {t['ms_call']:.4f}), "
            f"plain_ms {t['plain_ms']:.4f}, bound_ms {t['bound_ms']:.5f} "
            f"({t['bound_by']}), library_ms(SDPA, queued) "
            f"{t['library_ms']:.4f} (call by call {t['library_ms_call']:.4f})")


#: #12 / #13's shapes (B, S, K, G, hd): GPT-2 small's decode step (phase
#: 3) and Yi-6B's (phase 16: 8 query heads of 128 a KV head)
DECODE_SHAPE = (16, 1024, 12, 1, 64)
YI_DECODE_SHAPE = (16, 4096, 4, 8, 128)


def _store(results, name, tag, entry):
    """A kernel's entry in ``results``: phase 3's the entry itself, a later
    phase's under its ``tag`` inside it (kernels.json keeps both)."""
    if tag:
        results[name][tag] = entry
    else:
        results[name] = entry


def check_decode_attention(torch, dev, gen, results, shape=DECODE_SHAPE,
                           tag=None):
    """Phase 3, #12 at GPT-2 small's decode widths (16 slots of 1024 rows,
    12 kv heads of 64; phase 16: ``YI_DECODE_SHAPE``) at ``_decode_pos``'s
    positions: ctx within 1e-3 of the plain version at float32 (within one
    bf16 step at bfloat16), the written rows bit for bit, a second launch
    on a clone of the same cache bit-identical in ctx and written rows;
    timed queued and call by call beside SDPA."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_plain)
    b, s, kh, g, hd = shape
    pos = _decode_pos(torch, dev, gen, b, s)
    cache = _int8_cache(torch, dev, gen, b, s, kh, hd, pos)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).bfloat16()
    nk = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    nv = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        kc = [t.clone() for t in cache]
        pc = [t.clone() for t in cache]
        rc = [t.clone() for t in cache]
        args = [t.to(dt) for t in (q, nk, nv)]
        got = decode_attention(args[0], *kc, *args[1:], pos)
        want = decode_attention_plain(args[0], *pc, *args[1:], pos)
        again = decode_attention(args[0], *rc, *args[1:], pos)
        errs[dt] = attention_err(torch, got, want)
        for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, pc):
            if not torch.equal(a, c):
                fail(f"decode_attention written cache {name} not bit-exact "
                     f"({dt})")
        if not (torch.equal(again, got)
                and all(torch.equal(a, c) for a, c in zip(rc, kc))):
            fail(f"decode_attention: a second launch gave other bits ({dt})")
    err, tol = errs[torch.float32], 1e-3
    if not err <= tol:
        fail(f"decode_attention: ctx max err {err} > {tol}")
    t = _decode_times(
        torch, lambda: decode_attention(q, *kc, nk, nv, pos),
        lambda: decode_attention_plain(q, *pc, nk, nv, pos),
        _sdpa_yardstick(torch, dev, q, *cache, pos),
        *_decode_cost(q, nk, pos, kh, hd, g))
    print(f"decode_attention B={b} S={s} K={kh} G={g} hd={hd} pos "
          f"{pos.tolist()}: ctx max err {err:.2e} (tol {tol}, fp32 "
          f"carrier, bf16-valued inputs), bf16 carrier within one bf16 "
          f"step (max err {errs[torch.bfloat16]:.2e}), written rows "
          f"bit-exact, a second launch bit-identical; {_time_line(t)}")
    _store(results, "decode_attention", tag, dict(
        route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:250", tol=tol,
        shape=f"B={b},S={s},K={kh},G={g},hd={hd}", max_abs_err=err, **t))


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


def check_decode_attention_paged(torch, dev, gen, results,
                                 shape=DECODE_SHAPE, tag=None):
    """Phase 3b: #13 at GPT-2 small's decode widths (16 slots, a logical
    cache of 1024 rows, 12 kv heads of 64; phase 16: ``YI_DECODE_SHAPE``)
    over shuffled pools of pages of
    16, 64 (the serving phases' page) and 256 rows, at ``_decode_pos``'s
    positions with a freed slot (pos 0, a table row of trash-page entries)
    and a full one (pos == maxp * page, the clamped write).  (a) Against
    its plain version at both carriers: ctx within 1e-3 at float32 (within
    one bf16 step at bfloat16), the written pools bit for bit outside the
    trash page, a second launch on a clone bit-identical.  (b) Against #12
    on the source dense cache: ctx and the written rows at their logical
    positions bit for bit.  Timed queued and call by call beside SDPA."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_paged,
                                                 decode_attention_paged_plain,
                                                 paged_logical_view)
    b, s, kh, g, hd = shape
    pos = _decode_pos(torch, dev, gen, b, s)
    dense = _int8_cache(torch, dev, gen, b, s, kh, hd, pos)
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev).bfloat16()
    nk = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    nv = torch.randn((b, kh, hd), generator=gen, device=dev).bfloat16()
    live = torch.arange(1, b, device=dev)            # slot 0: the trash page
    at = pos.clamp(0, s - 1).long()[1:]
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
            rc = [t.clone() for t in pools]
            got = decode_attention_paged(args[0], *kc, *args[1:], pos, table)
            want = decode_attention_paged_plain(args[0], *pc, *args[1:], pos,
                                                table)
            again = decode_attention_paged(args[0], *rc, *args[1:], pos,
                                           table)
            errs[dt] = attention_err(torch, got, want)
            for name, a, c in zip(("kq", "ks", "vq", "vs"), kc, pc):
                if not torch.equal(a[1:], c[1:]):
                    fail(f"decode_attention_paged page {page}: written pool "
                         f"{name} not bit-exact against the plain version "
                         f"({dt})")
            if not (torch.equal(again, got) and all(
                    torch.equal(a[1:], c[1:]) for a, c in zip(rc, kc))):
                fail(f"decode_attention_paged page {page}: a second launch "
                     f"gave other bits ({dt})")
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
        # the yardstick reads the gathered logical view (gather untimed)
        view = [paged_logical_view(t, table) for t in pools]
        t = _decode_times(
            torch, lambda: decode_attention_paged(q, *kc, nk, nv, pos, table),
            lambda: decode_attention_paged_plain(q, *pc, nk, nv, pos, table),
            _sdpa_yardstick(torch, dev, q, *view, pos),
            *_decode_cost(q, nk, pos, kh, hd, g, extra=4 * table.numel()))
        print(f"decode_attention_paged B={b} S={s} page={page} K={kh} G={g} "
              f"hd={hd} pos [0 (trash slot), {s}, chunk edges, ragged]: ctx "
              f"max err {err:.2e} (tol {tol}, fp32 carrier), bf16 carrier "
              f"within one bf16 step (max err {errs[torch.bfloat16]:.2e}), "
              f"written pools bit-exact outside page 0, a second launch "
              f"bit-identical; ctx and written rows bit-identical to "
              f"decode_attention on the dense cache (both carriers); "
              f"{_time_line(t)}")
        rows_out.append(dict(shape=f"B={b},S={s},page={page},K={kh},G={g},"
                             f"hd={hd}", max_abs_err=err, **t))
        del pools, kc, pc, rc, view
    # the JSON entry reports the serving phases' page of 64 rows
    _store(results, "decode_attention_paged", tag, dict(
        route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:374", tol=1e-3,
        shapes=rows_out, **rows_out[1]))


#: phase 3, #11: the serving gate (4 prompts of 256 over 1024-row
#: buffers) and the engine's extremes (16 slots at the 512 bucket, one
#: prompt at 32), GPT-2 small's heads
Q8_SHAPES = ((4, 256, 1024, 12, 12, 64), (16, 512, 1024, 12, 12, 64),
             (1, 32, 1024, 12, 12, 64))
#: #11's limit on max |kernel - plain| at float32: the CUDA-core kernel's
#: output, and the tensor-core kernel's output before its bf16 cast
Q8_TOL = 1e-3


def _q8_control(torch, q, kq, ks, vq, vs):
    """The plain version with p * g(vs) rounded to one bf16 term before the
    P.V product: what feeding the tensor cores one term, not three, gives."""
    from repro_torch.kernels.flash_attn import scale_guard
    b, sq, h, hd = q.shape
    skv, kh = kq.shape[1], kq.shape[2]
    g = h // kh
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kq.float())
    s = s * scale_guard(ks)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    qpos = torch.arange(sq, device=q.device)
    s = s.masked_fill(torch.arange(skv, device=q.device)[None, :]
                      > qpos[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    p = p * scale_guard(vs)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    ctx = torch.einsum("bkgqt,btkd->bqkgd", p.bfloat16().float(), vq.float())
    return ctx.reshape(b, sq, h, hd)


def check_flash_q8(torch, dev, gen, results, shapes=Q8_SHAPES, tag=None):
    """Phase 3, #11 at ``Q8_SHAPES``: the bf16 tensor-core kernel
    (``flash_q8_sm90.cu``) within one bf16 step of the plain version, its
    output before the cast within ``Q8_TOL`` of the plain version at
    float32 (rel L2 printed beside a control that rounds p * g(vs) to one
    bf16 term), a repeat bit-identical; the float32 carrier (the
    CUDA-core kernel) within ``Q8_TOL``; each timed call by call and
    queued beside the CUDA-core kernel at bf16 (the first port's), SDPA on
    dequantized K/V (queued), the plain version and the bound (bytes, or
    the bf16-exact products at 989 TFLOP/s, each fp32 operand counted as
    its terms); ``HGMMA`` in every ``flash_q8_sm90`` kernel's SASS.
    Phase 16 runs it at ``YI_Q8_SHAPE`` (``tag``), the SASS check left to
    phase 3."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    rows = []
    for b, sq, skv, h, kh, hd in shapes:
        kq, ks, vq, vs = _int8_cache(torch, dev, gen, b, skv, kh, hd,
                                     [sq] * b)
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev).bfloat16()
        got = fa.flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True)
        want = fa.flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=True)
        bf16_err = attention_err(torch, got, want)
        again = fa.flash_attention_fwd_q8(q, kq, ks, vq, vs, causal=True)
        f32 = fa.launch_q8("flash_q8_sm90", q, kq, ks, vq, vs, causal=True,
                           out_dtype=torch.float32)
        want32 = fa.flash_attention_fwd_q8_plain(q.float(), kq, ks, vq, vs,
                                                 causal=True)
        core = fa.flash_attention_fwd_q8(q.float(), kq, ks, vq, vs,
                                         causal=True)
        ctl = _q8_control(torch, q, kq, ks, vq, vs)
        torch.cuda.synchronize()
        err = (f32 - want32).abs().max().item()
        core_err = (core - want32).abs().max().item()
        rel = _rel_l2(torch, [f32], [want32])
        ctl_rel = _rel_l2(torch, [ctl], [want32])
        if not torch.equal(again, got):
            fail(f"flash_attention_fwd_q8 {b}x{sq}: a repeat gave other bits")
        if err > Q8_TOL or core_err > Q8_TOL:
            fail(f"flash_attention_fwd_q8 {b}x{sq}: max err {err} (bf16 "
                 f"kernel before its cast) / {core_err} (fp32 kernel) > "
                 f"{Q8_TOL}")
        ms = queued_ms(lambda: fa.flash_attention_fwd_q8(q, kq, ks, vq, vs))
        ms_call = time_ms(lambda: fa.flash_attention_fwd_q8(q, kq, ks, vq, vs))
        core_ms = queued_ms(lambda: fa.launch_q8("flash_attn_q8", q, kq, ks,
                                                vq, vs))
        plain = time_ms(lambda: fa.flash_attention_fwd_q8_plain(
            q, kq, ks, vq, vs), iters=3)
        # the KV heads expanded to the query heads (KV-major groups)
        kd = _dequant(torch, kq, ks).bfloat16().permute(0, 2, 1, 3
                                                        ).repeat_interleave(
                                                            h // kh, 1)
        vd = _dequant(torch, vq, vs).bfloat16().permute(0, 2, 1, 3
                                                        ).repeat_interleave(
                                                            h // kh, 1)
        qt = q.permute(0, 2, 1, 3)
        lib = queued_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, is_causal=True))
        lib_call = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, is_causal=True))
        # q read and out written once, the causally visible K/V rows and
        # their scales once; per visible pair q.k (one term at hd 64, three
        # elsewhere) and p.v (three terms), 2 * hd FLOPs each
        visible = min(skv, sq)
        nbytes = 2 * q.numel() * 2 + 2 * b * visible * kh * (hd + 4)
        q_terms = 1 if hd == 64 else 3
        ops = (q_terms + 3) * 2.0 * hd * b * h * (sq * (sq + 1) / 2)
        bd, by = bound_ms(nbytes, ops, BF16_FLOPS)
        rows.append(dict(shape=f"B={b},Sq={sq},Skv={skv},H={h},K={kh},"
                               f"hd={hd}",
                         max_abs_err=err, bf16_max_abs_err=bf16_err,
                         rel_l2=rel, control_rel_l2=ctl_rel,
                         fp32_max_abs_err=core_err, ms=ms, ms_call=ms_call,
                         cuda_core_ms=core_ms, plain_ms=plain, bound_ms=bd,
                         bound_by=by, library_ms=lib, library_ms_call=lib_call))
        print(f"flash_attention_fwd_q8 B={b} Sq={sq} Skv={skv} H={h} K={kh} "
              f"hd={hd} "
              f"causal, bf16 (flash_q8_sm90): within one bf16 step (max err "
              f"{bf16_err:.2e}), repeat bit-identical, before the cast max "
              f"err {err:.2e} (tol {Q8_TOL}) rel L2 {rel:.2e} (control, "
              f"p*g(vs) as one bf16 term: {ctl_rel:.2e}); fp32 carrier "
              f"(flash_attn_q8) max err {core_err:.2e}; queued ms {ms:.4f} "
              f"(call by call {ms_call:.4f}), the CUDA-core kernel at bf16 queued "
              f"{core_ms:.4f}, plain_ms {plain:.4f}, bound_ms {bd:.5f} ({by}),"
              f" library_ms(SDPA, queued) {lib:.4f} (call by call "
              f"{lib_call:.4f})")
        del kq, ks, vq, vs, q, got, want, again, f32, want32, core, ctl, kd, vd
    if tag:
        results["flash_attention_fwd_q8"][tag] = rows[0]
        return
    counts = sass_counts("flash_q8_sm90", "HGMMA")
    print(f"flash_q8_sm90 SASS: {sum(counts.values())} HGMMA instructions "
          f"over {len(counts)} kernels (each "
          f"{min(counts.values(), default=0)}-"
          f"{max(counts.values(), default=0)})")
    if not counts or min(counts.values()) == 0:
        fail(f"phase 3: a flash_q8_sm90 kernel has no HGMMA: {counts}")
    results["flash_attention_fwd_q8"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_q8_sm90.cu",
        replaces="src/repro/kernels/flash_attn.py:468", tol=Q8_TOL,
        shapes=rows, **rows[0])


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


def ladder_prompts(cfg, seed):
    """The 32 prompts of phases 17a and 17c: lengths in
    ``LADDER_PROMPT_LENS`` (one prefill bucket), drawn from ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed + 5)
    lo, hi = LADDER_PROMPT_LENS
    lens = rng.randint(lo, hi + 1, size=SERVE_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


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
    healthy(eng, "phase 4")
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
    attn = [k for k in kern if "decode_chunk_kernel" in k[0]
            or "decode_combine_kernel" in k[0]]
    print(f"profile: decode attention (decode_attn.cu's two kernels) "
          f"{sum(k[1] for k in attn) / 4e3:.3f} ms/step in "
          f"{sum(k[2] for k in attn) // 4} kernels/step")
    fwd = [k for k in kern if int8_kernel_side(k[0]) == "fwd"]
    print(f"profile: the int8 forward (int8_matmul, FWD_STAGES) "
          f"{sum(k[1] for k in fwd) / 4e3:.3f} ms/step in "
          f"{sum(k[2] for k in fwd) // 4} kernels/step")
    # the host's side: self CPU time of the traced torch ops (the profiler's
    # own cost included; Python between the ops is not traced)
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.self_cpu_time_total), key=lambda h: -h[1])
    print(f"profile: host, self CPU time of the traced ops "
          f"{sum(h[1] for h in host) / 4e3:.2f} ms/step; the largest: "
          + ", ".join(f"{name} {us / 4e3:.3f} ms ({n // 4}/step)"
                      for name, us, n in host[:8]))


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
    healthy(eng, "phase 4b")
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
    healthy(eng, "phase 4c (i)")

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
        healthy(eng, "phase 4c (ii)")
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


def _teacher_forced(torch, model, cfg, params, toks, policy, device,
                    kv_path=None):
    """Logits of a 64-token prefill and 8 teacher-forced decode steps,
    (9, B, vocab), on ``device``; the KV caches as the last step left them.
    ``kv_path`` picks how an int8 cache is read (phase 17b)."""
    from repro_torch.infer.prepare import prepare_params
    from repro_torch.models.common import tree_map
    p = prepare_params(cfg, tree_map(lambda t: t.to(device), params), policy)
    lg, st = model.prefill(p, toks[:, :64].to(device), policy=policy,
                           max_seq=80, kv_path=kv_path)
    out = [lg.cpu()]
    for i in range(8):
        pos = torch.full((toks.shape[0],), 64 + i, dtype=torch.int32,
                         device=device)
        lg, st = model.decode(p, st, toks[:, 64 + i:65 + i].to(device), pos,
                              policy=policy, kv_path=kv_path)
        out.append(lg.cpu())
    return torch.stack(out)[..., :cfg.vocab_size], st["caches"]


@contextlib.contextmanager
def plain_versions(names):
    """Inside, the model calls the named kernels' plain versions in their
    place, on whatever device its tensors are: the card-against-card
    comparisons of phases 5, 8, 12 and 15.  ``int8_matmul`` swaps both of
    its entries on the ``ops`` module: the int8 one and the fused decode
    entry ``int8_quant_matmul``.  Nothing in the port does this."""
    import repro_torch.kernels.flash_attn as flash_attn
    import repro_torch.kernels.ops as ops
    import repro_torch.kernels.opt_update as opt_update
    import repro_torch.models.attention as attention
    from repro_torch.kernels.decode_attn import decode_attention_plain
    from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
    from repro_torch.kernels.int8_matmul import (int8_matmul_nt_plain,
                                                 int8_matmul_plain,
                                                 int8_matmul_tn_plain,
                                                 int8_quant_matmul_plain)
    from repro_torch.kernels.qdq import qdq_row_plain, qdq_scaled_plain
    sites = {"int8_matmul": [(ops, "int8_matmul", int8_matmul_plain),
                             (ops, "int8_quant_matmul",
                              int8_quant_matmul_plain)],
             "qdq_row": [(ops, "qdq_row", qdq_row_plain)],
             "qdq_scaled": [(ops, "qdq_scaled", qdq_scaled_plain)],
             "flash_attention_fwd_q8": [(attention, "flash_attention_fwd_q8",
                                         flash_attention_fwd_q8_plain)],
             "decode_attention": [(attention, "decode_attention",
                                   decode_attention_plain)],
             "int8_matmul_nt": [(ops, "int8_matmul_nt", int8_matmul_nt_plain)],
             "int8_matmul_tn": [(ops, "int8_matmul_tn", int8_matmul_tn_plain)],
             "fused_adamw_blocks": [(opt_update, "fused_adamw_blocks",
                                     opt_update.fused_adamw_blocks_plain)],
             "fused_adamw_leaves": [(opt_update, "fused_adamw_leaves",
                                     opt_update.fused_adamw_leaves_plain)],
             **{n: [(flash_attn, n, getattr(flash_attn, n + "_plain"))]
                for n in FLASH_KERNELS}}
    swaps = [site for n in names for site in sites[n]]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    try:
        for mod, attr, plain in swaps:
            setattr(mod, attr, plain)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


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


def card_vs_cpu(torch, dev, seed, cfg=None, b_limit=B_LIMIT):
    """Phase 5: teacher-forced logits of the card against the CPU, float32
    carrier, the weights of ``init_params`` (seed + 1) at the true fan-in
    scale (``true_fan_in``), 2 prompts of 64 tokens + 8 decode steps, on
    GPT-2 small (phase 16d: ``cfg``, Yi-6B's width at 2 layers, and B
    held to ``b_limit``, ``YI_B_LIMIT`` there).  Each
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
       kernel's place (both entries, the decode linears' fused one too)
       every logit must be bit-identical -- every one of the forward's int8
       matmuls equals its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = cfg or dataclasses.replace(get_config("gpt2-small"),
                                     dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    params = true_fan_in(model.init_params(gen, device="cpu"), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64 + 8), generator=gen)

    def run(policy, device):
        return _teacher_forced(torch, model, cfg, params, toks, policy,
                               device)
    ok = True
    for label, policy, limit in (("A", "kv_cache=a8t,*=w8c", 1e-2),
                                 ("B", POLICY, b_limit)):
        cpu, cpu_kv = run(policy, "cpu")
        card, card_kv = run(policy, dev)
        with plain_versions(SERVE_KERNELS):
            card_plain, _ = run(policy, dev)
        err, n_agree, n_bad = _agreement(torch, card, cpu, limit)
        spread = (card_plain - cpu).abs().max().item()
        flips = [float((card_kv["k"][i].cpu() != cpu_kv["k"][i]).float()
                       .mean()) for i in range(cfg.n_layers)]
        print(f"card vs cpu {label} {cfg.name} {cfg.n_layers}L d="
              f"{cfg.d_model} {policy} (float32 carrier, 2 x 64 prompt "
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
            print(f"card vs card {label} {cfg.name}: plain int8_matmul in the "
                  f"kernel's "
                  f"place: logits {'bit-identical' if same else 'DIFFER'} "
                  f"(tol 0; max |dlogit| "
                  f"{(card_mm_plain - card).abs().max().item():.3e})")
            ok &= same
    if not ok:
        fail(f"card and CPU logits disagree ({cfg.name})")


def _grad_scale(torch, g, fold, dim):
    """absmax / 127 of g * fold over ``dim``: the wrappers' q_scale."""
    absmax = (g.float().abs() * fold).amax(dim=dim, keepdim=True)
    return absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call with the host out of the way: the
    card sleeps while ``iters`` calls are queued behind it, then CUDA events
    time them back to back (the training step keeps the card's queue full,
    so this is what a call costs it; ``time_ms`` of a call shorter than its
    host dispatch times the host)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: the kernels of one int8 backward call, by name, and the stage each is;
#: the GEMM and the reduction are shared with the forward
#: (``csrc/gemm_s8.cuh``), whose scale mode, 2, tells its kernels apart
BWD_STAGES = (("quant_rows_kernel", "quantize"), ("pack_tn_kernel", "quantize"),
              ("gemm_s8_kernel", "gemm"), ("split_reduce_kernel", "reduce"))
#: the kernels of one forward call (``csrc/int8_matmul.cu``): the cluster
#: route's one kernel, or the tensor-core route's transpose, GEMM and
#: reduction (and the first dp4a kernel, on no route)
FWD_STAGES = (("gemv_s8_kernel", "gemv"), ("int8_matmul_kernel", "dp4a"),
              ("transpose_kernel", "transpose"), ("gemm_s8_kernel", "gemm"),
              ("split_reduce_kernel", "reduce"))


def int8_kernel_side(name: str):
    """"fwd", "bwd" or None for a profiled kernel name: the forward's
    kernels (``FWD_STAGES``, the shared GEMM and reduction at scale mode 2,
    both scales) or the backward's (``BWD_STAGES``, modes 0 and 1)."""
    import re
    shared = ("gemm_s8_kernel" in name or "split_reduce_kernel" in name)
    if shared:
        both = re.search(r"_kernel<\s*(\(int\))?\s*2\s*,", name)
        return "fwd" if both else "bwd"
    if any(key in name for key, _ in FWD_STAGES):
        return "fwd"
    if any(key in name for key, _ in BWD_STAGES):
        return "bwd"
    return None


def bwd_stage_ms(torch, kind, g, other, fold, qs, k, n, dt) -> dict:
    """Each stage of one nt or tn call timed alone (``queued_ms``) through
    its stage wrapper: the quantize pass, the int8 GEMM (the split partials
    where the call splits) and the split reduction."""
    import importlib
    # the module (the package re-exports a function of its name)
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    m = g.shape[0]
    if kind == "nt":
        gq, wk = im.quant_rows_packed(g, fold, qs), im.kmajor_weight(other)
        return {"quantize": queued_ms(lambda: im.quant_rows_packed(g, fold,
                                                                    qs)),
                "gemm": queued_ms(lambda: im.int8_gemm_kmajor(
                    gq, wk, qs, n, True, dt, splits=1))}
    xt, gt = im.pack_tn(other, g, fold, qs)
    out = {"quantize": queued_ms(lambda: im.pack_tn(other, g, fold, qs))}
    splits = im.gemm_splits(k, n, m)
    if splits == 1:
        out["gemm"] = queued_ms(lambda: im.int8_gemm_kmajor(
            xt, gt, qs, m, False, dt, splits=1))
        return out
    ws = im.int8_gemm_partials(xt, gt, m, splits)
    out["gemm"] = queued_ms(lambda: im.int8_gemm_partials(xt, gt, m, splits))
    out["reduce"] = queued_ms(lambda: im.int8_split_reduce(ws, qs, False, dt))
    return out


def check_int8_bwd(torch, dev, gen, results):
    """Phase 6a: nt and tn at the training path's shapes (M = 8192 tokens,
    the three (K, N) of GPT-2 small's linears, bf16 gradient and output) and
    at fp32 (gradient and output, (768, 768)), bit for bit against their
    plain versions, a second launch bit-identical to the first; each timed
    with its stages (quantize pass, GEMM, split reduction) beside its bound,
    its plain version and ``torch._int_mm``, all with the card's queue
    full (``queued_ms``); every GEMM kernel of the library holds integer
    wgmma (``IGMMA``) in its SASS."""
    from repro_torch.kernels.int8_matmul import (
        _quant_grad, gemm_splits, int8_matmul_nt, int8_matmul_nt_plain,
        int8_matmul_tn, int8_matmul_tn_plain, scale_guard)
    m = TRAIN_BATCH * TRAIN_SEQ
    rows = {"int8_matmul_nt": [], "int8_matmul_tn": []}
    cases = [(768, 768, torch.bfloat16), (768, 3072, torch.bfloat16),
             (3072, 768, torch.bfloat16), (768, 768, torch.float32)]
    for k, n, dt in cases:
        g = (torch.randn((m, n), generator=gen, device=dev) * 0.02).to(dt)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        fw = torch.rand((1, n), generator=gen, device=dev) * 0.01 + 1e-4
        fx = torch.rand((m, 1), generator=gen, device=dev) * 0.05 + 1e-4
        qn = _grad_scale(torch, g, fw, 1)
        qt = _grad_scale(torch, g, fx, 0)
        es = g.element_size()
        kern_cases = {
            "int8_matmul_nt": (
                lambda: int8_matmul_nt(g, w, fw, qn, out_dtype=dt),
                lambda: int8_matmul_nt_plain(g, w, fw, qn, out_dtype=dt),
                # yardstick operands: the quantized gradient, w^T
                (_quant_grad(g, fw, scale_guard(qn)).to(torch.int8),
                 w.t()),
                m * n * es + k * n + 4 * (n + m) + m * k * es, 1,
                lambda: bwd_stage_ms(torch, "nt", g, w, fw, qn, k, n, dt)),
            "int8_matmul_tn": (
                lambda: int8_matmul_tn(x, g, fx, qt, out_dtype=dt),
                lambda: int8_matmul_tn_plain(x, g, fx, qt, out_dtype=dt),
                (x.t().contiguous(),
                 _quant_grad(g, fx, scale_guard(qt)).to(torch.int8)),
                m * k + m * n * es + 4 * (m + n) + k * n * es,
                gemm_splits(k, n, m),
                lambda: bwd_stage_ms(torch, "tn", g, x, fx, qt, k, n, dt)),
        }
        for name, (kern, plain, (la, lb), nbytes, splits,
                   stages) in kern_cases.items():
            got, want = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                fail(f"{name} M={m} K={k} N={n} {dt} not bit-exact (max err "
                     f"{err})")
            if not torch.equal(again, got):
                fail(f"{name} M={m} K={k} N={n} {dt}: a second launch gave "
                     f"other bits")
            ms = queued_ms(kern)
            split = stages()
            plain_ms = time_ms(plain, iters=3)
            lib = queued_ms(lambda: torch._int_mm(la, lb))
            b, by = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS)
            rows[name].append(dict(shape=f"M={m},K={k},N={n},{dt}",
                                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b, bound_by=by, library_ms=lib,
                                   stages_ms=split, splits=splits))
            print(f"{name} M={m} K={k:4d} N={n:4d} {str(dt)[6:]}: bit-exact "
                  f"(tol 0), repeat bit-identical, ms {ms:.4f} (stages alone: "
                  + ", ".join(f"{st} {v:.4f}" for st, v in split.items())
                  + f"; {splits} split{'s' if splits > 1 else ''}), plain_ms "
                  f"{plain_ms:.4f}, bound_ms {b:.5f} ({by}), "
                  f"library_ms(_int_mm) {lib:.4f}")
    # the JSON entry reports the shape with the most launches on the main
    # path: wq, wk, wv and wo at K = N = 768 (48 of the 72 a step)
    for name, line in (("int8_matmul_nt", 146), ("int8_matmul_tn", 205)):
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/int8_matmul_bwd.cu",
            replaces=f"src/repro/kernels/int8_matmul.py:{line}", tol=0.0,
            shapes=rows[name], **rows[name][0])
    counts = sass_counts("int8_matmul_bwd", "IGMMA")
    gemm = {fn: c for fn, c in counts.items() if "gemm_s8_kernel" in fn}
    print(f"int8_matmul_bwd SASS: {sum(gemm.values())} IGMMA instructions "
          f"over {len(gemm)} GEMM kernels (each "
          f"{min(gemm.values(), default=0)}-{max(gemm.values(), default=0)})")
    if not gemm or min(gemm.values()) == 0:
        fail(f"phase 6: an int8 backward GEMM kernel has no IGMMA: {gemm}")


#: phase 6b's bucket rows are padded to a multiple of this: the JAX
#: reference's tile (``repro/optim/adamw.py``), as the port padded its
#: bucket before it read the leaves where they lie
BUCKET_TILE_ROWS = 256


def gpt2_bucket_rows(torch, dev, cfg):
    """(rows, params) of the fused AdamW bucket for ``cfg`` under 128-wide
    blocks: every quantizable leaf's blocks, padded to the reference's
    tile, and the parameters they hold."""
    from repro_torch.core import qadam
    from repro_torch.core.qconfig import parse_spec
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    spec = parse_spec("8c-b128")
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = tree_flatten(params)[0]
    rows = sum(qadam.blockwise_state_shapes(p.shape, spec)[0][0]
               for p in leaves if qadam.quantizable(p))
    n_params = sum(p.numel() for p in leaves if qadam.quantizable(p))
    del params, leaves
    return rows + (-rows) % BUCKET_TILE_ROWS, n_params


def gpt2_leaves(torch, dev, gen, rec, seed=0):
    """GPT-2 small's quantizable leaves as the optimizer reads them: params
    from ``init_params`` (``seed``), random fp32 gradients, and both
    moments of random values quantized per leaf with ``rec``'s codecs (m2
    through its sqrt domain).  A dict of lists: g, p, m1, m2 (QStates)."""
    from repro_torch.configs import get_config
    from repro_torch.core import qadam
    from repro_torch.core.quantizer import quantize_int
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    params = build_model(get_config("gpt2-small")).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    p = [t for t in tree_flatten(params)[0] if qadam.quantizable(t)]
    del params

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return {"p": p, "g": [rand(t.shape, 1e-2) for t in p],
            "m1": [qadam.QState(*quantize_int(rand(t.shape, 1e-3),
                                              rec.adam_m1)) for t in p],
            "m2": [qadam.QState(*quantize_int(
                torch.rand(t.shape, generator=gen, device=dev).mul_(
                    1e-5).sqrt_(), rec.adam_m2)) for t in p]}


def _leaves_out(out):
    """The tensors of a ``fused_adamw_leaves`` result, in order."""
    p, m1, m2, _ = out
    return [*p, *(t for m in m1 for t in m), *(t for m in m2 for t in m)]


def _same(torch, got, want):
    """(bit for bit?, max |difference|) over two lists of tensors."""
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    return all(torch.equal(a, b) for a, b in zip(got, want)), err


def optimizer_device_time(torch, call, reps: int = 5):
    """Device time of one optimizer call with the card's queue full: the
    card sleeps while the host queues the whole call, then CUDA events
    time it (the median of ``reps``); and torch.profiler's device time of
    its kernels over one more call, by kind.  Returns (ms, {kind: ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        low = e.key.lower()
        kind = ("fused AdamW kernel" if "adamw" in low else
                "concatenation" if "cat" in low else
                "reductions" if "reduce" in low else "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    return sorted(times)[reps // 2], kinds


def check_fused_adamw(torch, dev, gen, results):
    """Phase 6b: the fused AdamW kernel's two entries on GPT-2 small.

    The bucket entry on a bucket of GPT-2 small's size (random gradient,
    params and moments; the slice's codecs) and the leaves entry on GPT-2
    small's own quantizable leaves (``gpt2_leaves``: params from
    ``init_params``, random fp32 gradients, moments quantized per leaf), a
    second step from the first one's outputs (views into its bucket), each
    bit for bit against its plain version in params, payloads, scales and
    zero points, the update-norm sum within 1e-5 relative (another
    summation order), and a repeat bit-identical (the sum too).  Both
    timed queued beside the byte bound; then ``adamw_update`` on GPT-2
    small's params and the train policy: its device time with the card's
    queue full and its kernels by kind (``optimizer_device_time``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qconfig import parse_recipe
    from repro_torch.core.quantizer import quantize_int
    from repro_torch.kernels.opt_update import (codec_of, fused_adamw_blocks,
                                                fused_adamw_blocks_plain,
                                                fused_adamw_leaves,
                                                fused_adamw_leaves_plain)
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

    def sum_rel(got, want):
        return abs(got.item() - want.item()) / want.item()
    ref = [t.clone() for t in bucket]
    again = [t.clone() for t in bucket]
    got = fused_adamw_blocks(*bucket, sc, **kw)
    want = fused_adamw_blocks_plain(*ref, sc, **kw)
    rep = fused_adamw_blocks(*again, sc, **kw)
    torch.cuda.synchronize()
    exact, err = _same(torch, bucket[1:], ref[1:])
    if not exact:
        fail(f"fused_adamw_blocks not bit-exact on {rows} x {bs} (max err "
             f"{err})")
    rel = sum_rel(got[3], want[3])
    if rel > 1e-5:
        fail(f"fused_adamw_blocks update-norm sum off by {rel:.2e} relative")
    if not (_same(torch, again[1:], bucket[1:])[0]
            and torch.equal(rep[3], got[3])):
        fail("fused_adamw_blocks: a repeat is not bit-identical")
    del ref, again
    ms = queued_ms(lambda: fused_adamw_blocks(*bucket, sc, **kw), iters=10)
    plain = time_ms(lambda: fused_adamw_blocks_plain(*bucket, sc, **kw),
                    iters=3)
    n = rows * bs
    # reads g, p (fp32) and both int8 payloads, writes p and both payloads;
    # scale and zero of both moments read and written once a row
    nbytes = n * (4 + 4 + 1 + 1 + 4 + 1 + 1) + rows * 4 * 4 * 2 + 8 * 4
    b, by = bound_ms(nbytes, 35.0 * n, FP32_FLOPS)
    print(f"fused_adamw_blocks {rows} x {bs} ({n_params} GPT-2 small params "
          f"in the bucket): bit-exact (tol 0; update-norm sum rel "
          f"{rel:.1e}, tol 1e-5), repeat bit-identical, queued ms "
          f"{ms:.4f}, plain_ms {plain:.4f}, bound_ms {b:.5f} ({by}), "
          f"library_ms none (no PyTorch call computes blockwise 8-bit AdamW)")
    results["fused_adamw_blocks"] = dict(
        route="cuda", source="src/repro_torch/csrc/opt_update.cu",
        replaces="src/repro/kernels/opt_update.py:160", tol=0.0,
        shape=f"rows={rows},bs={bs}", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None)
    del bucket, got, want, rep, g, p

    lv = gpt2_leaves(torch, dev, gen, rec)
    args = (lv["g"], lv["p"], lv["m1"], lv["m2"], sc)
    first = fused_adamw_leaves(*args, **kw)
    errs = []
    for step, (got, want) in enumerate((
            (first, fused_adamw_leaves_plain(*args, **kw)),
            # the optimizer's steady state: moments and params are views
            # into the previous step's bucket
            (fused_adamw_leaves(lv["g"], *first[:3], sc, **kw),
             fused_adamw_leaves_plain(lv["g"], *first[:3], sc, **kw)))):
        torch.cuda.synchronize()
        exact, e = _same(torch, _leaves_out(got), _leaves_out(want))
        errs.append(e)
        if not exact:
            fail(f"fused_adamw_leaves step {step + 1} not bit-exact on "
                 f"{len(lv['p'])} leaves (max err {e})")
        rel_l = sum_rel(got[3], want[3])
        if rel_l > 1e-5:
            fail(f"fused_adamw_leaves step {step + 1} update-norm sum off by "
                 f"{rel_l:.2e} relative")
    rep = fused_adamw_leaves(*args, **kw)
    if not (_same(torch, _leaves_out(rep), _leaves_out(first))[0]
            and torch.equal(rep[3], first[3])):
        fail("fused_adamw_leaves: a repeat is not bit-identical")
    del rep, got, want
    rows_l = sum(int(m.q.shape[0]) for m in lv["m1"])
    ms_l = queued_ms(lambda: fused_adamw_leaves(*args, **kw), iters=10)
    plain_l = time_ms(lambda: fused_adamw_leaves_plain(*args, **kw), iters=3)
    n_l = rows_l * bs
    b_l, by_l = bound_ms(n_l * 16 + rows_l * 32 + 32, 35.0 * n_l, FP32_FLOPS)
    print(f"fused_adamw_leaves {len(lv['p'])} GPT-2 small leaves ({rows_l} "
          f"rows of {bs}, none padded): two steps bit-exact (tol 0; "
          f"update-norm sum rel {rel_l:.1e}, tol 1e-5), repeat "
          f"bit-identical, queued ms {ms_l:.4f}, plain_ms {plain_l:.4f} "
          f"(concatenation included), bound_ms {b_l:.5f} ({by_l}), "
          f"library_ms none")
    results["fused_adamw_leaves"] = dict(
        route="cuda", source="src/repro_torch/csrc/opt_update.cu",
        replaces="src/repro/kernels/opt_update.py:160", tol=0.0,
        shape=f"leaves={len(lv['p'])},rows={rows_l},bs={bs}",
        max_abs_err=max(errs), ms=ms_l, plain_ms=plain_l, bound_ms=b_l,
        bound_by=by_l, library_ms=None)
    del lv, args, first
    bulk_sass_check(("opt_update", "adamw_stream_kernel"))
    adamw_update_time(torch, dev, gen)


def adamw_update_time(torch, dev, gen):
    """Phase 6b's last part: one ``adamw_update`` on GPT-2 small's params
    (``init_params``, seed 0), random fp32 gradients and fresh int8
    moments under ``TRAIN_POLICY``, the call phase 7's step makes: its
    device time with the card's queue full, its kernels by kind."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import adamw_update, init_adam_state
    from repro_torch.core.qpolicy import as_policy
    policy = as_policy(TRAIN_POLICY)
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=TRAIN_STEPS,
                    state_storage="int")
    params = build_model(get_config("gpt2-small")).init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=dev) * 1e-2, params)
    state = init_adam_state(params, policy, opt)
    ms, kinds = optimizer_device_time(
        torch, lambda: adamw_update(params, grads, state, opt, policy))
    print(f"adamw_update on GPT-2 small ({TRAIN_POLICY.split('@')[0]}): "
          f"device {ms:.4f} ms a call with the queue full; kernels by kind "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(kinds.items())))


def train_launches(cfg):
    """The launches of one train step on the int8 kernels: each block
    linear's forward (#3) once, and once more in the backward under
    ``cfg.remat`` (the layer's recomputation); its backward (#4, #5) once;
    one ``fused_adamw_leaves`` (#6); under ``flash_pallas`` the flash
    forward (#8) once a layer, again under ``remat``, and its backward
    (#9, #10) once a layer."""
    per_layer = 7 if cfg.mlp_kind == "gated" else 6
    linears, again = per_layer * cfg.n_layers, 2 if cfg.remat else 1
    flash = {}
    if cfg.attention_impl == "flash_pallas":
        flash = dict(flash_attention_fwd_lse=again * cfg.n_layers,
                     flash_attention_bwd_dkdv=cfg.n_layers,
                     flash_attention_bwd_dq=cfg.n_layers)
    return _expect(int8_matmul=again * linears, int8_matmul_nt=linears,
                   int8_matmul_tn=linears, fused_adamw_leaves=1, **flash)


def train(torch, dev, seed, impl="xla", cfg=None, batch=TRAIN_BATCH,
          seq=TRAIN_SEQ, steps=TRAIN_STEPS, tag=None, profile=True):
    """Phase 7 (``impl="xla"``, attention through ``_attend``) and phase 14
    (``"flash_pallas"``, through #8-#10): GPT-2 small's train step on the
    card (``gpt2_train_cfg``); phases 18a and 18c: ``cfg`` at (``batch``,
    ``seq``) for ``steps`` steps.  Every step's ce and grad norm finite and
    its launches exactly ``train_launches(cfg)``; ms per step (step 1,
    which loads the libraries, left out), tokens/s and peak memory, then
    with ``profile`` one profiled step.  Returns the launch counts of the
    main run."""
    from repro_torch import kernels
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import (init_train_state, make_train_step,
                                   train_path_summary)
    cfg = cfg or gpt2_train_cfg(attention_impl=impl)
    model = build_model(cfg)
    tag = tag or ("train" if impl == "xla" else "train_flash")
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=steps,
                    state_storage="int")
    # the serving phases stopped their schedulers (a running emit thread
    # holds its engine), but an engine and its scheduler refer to each
    # other: collect the cycles so the peak below is the train step's own
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(model,
                             torch.Generator(device=dev).manual_seed(seed),
                             TRAIN_POLICY, opt, device=dev)
    step_fn = make_train_step(model, TRAIN_POLICY, opt)
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=batch, seq_len=seq)
    batches = [torch.from_numpy(next(loader)["tokens"]).to(dev)
               for _ in range(steps + 1)]
    summary = train_path_summary(TRAIN_POLICY, cfg.n_layers, opt, device=dev,
                                 cfg=cfg, batch=batch, seq=seq)
    print(f"{tag}: {cfg.name} {cfg.n_layers}L d={cfg.d_model} carrier "
          f"{cfg.dtype}, attention {cfg.attention_impl}, {batch} x {seq} "
          f"tokens a step, policy {TRAIN_POLICY}, int moments; train-path: "
          f"{summary}")
    want = train_launches(cfg)
    print(f"{tag}: launches a step, as the design predicts: "
          f"{ {k: v for k, v in want.items() if v} }")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_ms = []
    for i in range(steps):
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
    tok = batch * seq
    print(f"{tag}: {steps} steps, step 1 {step_ms[0]:.1f} ms (loads "
          f"the libraries), steps 2-{steps} mean {mean:.1f} ms "
          f"(min {min(steady):.1f}, max {max(steady):.1f}), "
          f"{tok / mean * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB")
    print(f"{tag}: launch counts {counts}")
    if profile:
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
    # the twelve largest, and every flash kernel and every kernel of the
    # int8 forward and backward wherever it ranks
    side = {k[0]: int8_kernel_side(k[0]) for k in kern}
    for rank, (name, us, n) in enumerate(kern):
        if rank < 12 or "flash" in name or side[name]:
            print(f"profile:   {us / 1e3:8.3f} ms {n:5d} launches "
                  f"{name[:90]}")
    for key, what in (("fwd", "the int8 forward (int8_matmul)"),
                      ("bwd", "the int8 backward (nt and tn)")):
        ks = [k for k in kern if side[k[0]] == key]
        print(f"profile: {what} {sum(k[1] for k in ks) / 1e3:.3f} ms in "
              f"{sum(k[2] for k in ks)} launches")


def _rel_l2(torch, a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors, in float64 on the device of
    each tensor of ``a`` (the card's, where a card result meets a CPU one:
    Yi-6B's leaves are too many for the CPU's float64 passes)."""
    num = den = 0.0
    for x, y in zip(a, b):
        y = y.to(x.device).double()
        num += float((x.double() - y).square().sum())
        den += float(y.square().sum())
    return math.sqrt(num / max(den, 1e-300))


def _update_split(torch, card, cpu):
    """Where the parameter updates of the card and the CPU part: the share
    of elements whose gradient sign differs, the share whose sign agrees
    but whose m1 or m2 payload differs, and the updates' relative L2
    distance over the elements whose sign agrees (on ``card``'s device,
    in float64)."""
    from repro_torch.core.qadam import QState
    n_all = n_flip = n_pay = 0
    num_s = den_s = 0.0
    for i, (gc, gp) in enumerate(zip(card["grads"], cpu["grads"])):
        dev, n = gc.device, gp.numel()
        flip = (torch.sign(gc).reshape(-1)
                != torch.sign(gp.to(dev)).reshape(-1))
        pay = torch.zeros(n, dtype=torch.bool, device=dev)
        for key in ("m1", "m2"):
            a, b = card[key][i], cpu[key][i]
            if isinstance(b, QState):
                pay |= (a.q.reshape(-1)[:n] != b.q.to(dev).reshape(-1)[:n])
        uc = (card["p"][i] - card["p0"][i]).double().reshape(-1)
        up = (cpu["p"][i] - cpu["p0"][i]).to(dev).double().reshape(-1)
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


def train_card_vs_cpu(torch, dev, seed, cfg=None, batch=4, seq=128,
                      limits=TRAIN_LIMITS, label="phase 8", control=(),
                      zero_points=True, strict=True):
    """Phase 8: one train step of gpt2-mini (float32 carrier, batch 4 x 128
    from the synthetic corpus, the slice's policy, int moments), weights of
    ``init_params`` (seed + 2) at the true fan-in scale (``true_fan_in``,
    as phase 5), the same on both devices; phase 18d: ``cfg`` (Yi-6B's
    width at 2 layers, ``remat`` on) at (``batch``, ``seq``) with
    ``limits``.  Returns A's distances (``_step_distance``); ``strict=False``
    reports instead of failing (``tools/yi_train_readings.py``).

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
       float64, the kernel in float32, so moments can differ by an ulp).

    ``zero_points=False`` (phase 18d) holds C's payloads to one step only
    where the block's asymmetric zero points agree, and the dequantized
    moments to one step everywhere: the loop's 1 - b2 (Python float64)
    and the kernel's (float32) part by 1.3e-5 relative, and over Yi-6B's
    870 M moments a zero point flips by one while a payload flips the
    other way.

    With ``control`` (a tuple of A's distances), D: the same step on the
    card at the bf16 carrier against the same CPU step, each of those
    distances above its limit (as phase 12's control), so A would see a
    step that lost the float32 carrier's precision."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qadam import QState
    from repro_torch.core.qpolicy import as_policy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import adamw_update
    cfg = cfg or dataclasses.replace(get_smoke_config("gpt2-small"),
                                     dtype="float32")
    model = build_model(cfg)
    params = true_fan_in(model.init_params(
        torch.Generator().manual_seed(seed + 2), device="cpu"), cfg)
    toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=batch, seq_len=seq))
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                    state_storage="int")
    policy = as_policy(TRAIN_POLICY)
    what = (f"{cfg.name} {cfg.n_layers}L d={cfg.d_model}, float32 carrier, "
            f"{batch} x {seq} tokens, remat {cfg.remat}")

    def run(device, fused=True, swap=(), m=model):
        return one_train_step(torch, m, policy, params, toks, opt,
                              device, fused=fused, swap=swap)

    cpu, card = run("cpu"), run(dev)
    dist = _step_distance(torch, card, cpu)
    d_ce, g_rel, u_rel, flips, u_sign, pays = (dist[k] for k in (
        "ce", "grads", "updates", "sign_flips", "updates_sign", "payloads"))
    lim = limits
    print(f"{label} train card vs cpu A ({what}, {TRAIN_POLICY}): ce "
          f"{card['loss']:.6f} vs {cpu['loss']:.6f} "
          f"(|d| {d_ce:.3e}, limit {lim['ce']:.1e}), grad norm "
          f"{card['gn']:.6f} vs {cpu['gn']:.6f}, grads rel L2 {g_rel:.3e} "
          f"(limit {lim['grads']:.1e}), param updates rel L2 {u_rel:.3e} "
          f"(limit {lim['updates']:.1e})")
    print(f"{label} train card vs cpu A, updates by element: gradient sign "
          f"differs "
          f"on {flips:.3e} of them (limit {lim['sign_flips']:.1e}); updates "
          f"rel L2 where the sign agrees {u_sign:.3e} (limit "
          f"{lim['updates_sign']:.1e}), though an m1/m2 payload differs on "
          f"{pays:.3e} of the elements there")
    ok = (d_ce <= lim["ce"] and g_rel <= lim["grads"]
          and u_rel <= lim["updates"] and flips <= lim["sign_flips"]
          and u_sign <= lim["updates_sign"])

    same = lambda a, b: all(torch.equal(x, y) for x, y in
                            zip(a["grads"], b["grads"]))
    ctrl_same = same(card, run(dev))
    swapped = run(dev, swap=("int8_matmul_nt", "int8_matmul_tn"))
    swap_same = same(card, swapped)
    print(f"{label} train card vs card B: grads with plain nt/tn in the "
          f"kernels' place {'bit-identical' if swap_same else 'DIFFER'} "
          f"(control, the card twice: "
          f"{'bit-identical' if ctrl_same else 'DIFFER'}; tol 0; grads rel "
          f"L2 {_rel_l2(torch, swapped['grads'], card['grads']):.3e})")
    del swapped
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
    dq = dq_zero = n_two = n_two_zero = 0
    s_rel = steps = 0.0
    deq = lambda m: m.scale * (m.q.float() + m.zero)
    for fa, la in zip(card["m1"] + card["m2"], lm1 + lm2):
        if isinstance(fa, QState):
            d = (fa.q.int() - la.q.int()).abs()
            zero_same = (fa.zero == la.zero).expand_as(d)
            dq = max(dq, d.max().item())
            dq_zero = max(dq_zero, (d * zero_same).max().item())
            n_two += int((d >= 2).sum())
            n_two_zero += int(((d >= 2) & ~zero_same).sum())
            s_rel = max(s_rel, ((fa.scale - la.scale).abs()
                                / la.scale.abs().clamp_min(1e-30)).max().item())
            steps = max(steps, ((deq(fa) - deq(la)).abs()
                                / la.scale.clamp_min(1e-30)).max().item())
    print(f"{label} train card C: fused AdamW vs the loop on the card, same "
          f"grads: params max rel {p_rel:.2e} (limit 1e-6), payloads max "
          f"{dq} step (limit {'1' if zero_points else 'not set'}), where the "
          f"block's zero points agree {dq_zero} (limit 1); {n_two} payloads "
          f"2+ steps apart, {n_two_zero} of them where the zero points "
          f"differ; dequantized moments max {steps:.4f} of a step apart "
          f"(limit {'not set' if zero_points else '1.001'}); scales max rel "
          f"{s_rel:.2e} (limit 1e-6)")
    ok &= p_rel <= 1e-6 and dq_zero <= 1 and s_rel <= 1e-6
    ok &= dq <= 1 if zero_points else steps <= 1.001
    del loop_p, loop_st, lp, lm1, lm2
    bad = []
    if control:
        names = {"ce": "|d ce|", "grads": "grads rel L2",
                 "sign_flips": "sign flips", "updates": "updates rel L2",
                 "updates_sign": "updates rel L2 where the sign agrees"}
        low = run(dev, m=build_model(dataclasses.replace(cfg,
                                                         dtype="bfloat16")))
        low_dist = _step_distance(torch, low, cpu)
        low_ok = all(low_dist[k] > lim[k] for k in control)
        print(f"{label} train control D, the card at the bf16 carrier vs "
              f"cpu: ce {low['loss']:.6f}, "
              + ", ".join(f"{names[k]} {low_dist[k]:.3e} (limit "
                          f"{lim[k]:.1e})" for k in names)
              + f": {', '.join(control)} above their limits "
              f"{'yes' if low_ok else 'NO'}")
        if not low_ok:
            bad.append("the bf16-carrier control lies within the limits, so "
                       "they cannot tell it from a sound step")
    if not ok:
        bad.append("train step card vs CPU / card vs card out of limits")
    if bad and strict:
        fail(f"{label}: {'; '.join(bad)}")
    for msg in bad:
        print(f"chip_smoke: {label}: {msg}")
    return dist


# ---------------------------------------------------------------------------
# phases 9-12: the fake-quant gradient kernels and the guarded training path
# ---------------------------------------------------------------------------

def time_cold_ms(fn, args_list, iters: int = 20, warmup: int = 3,
                 queued: bool = False) -> float:
    """``time_ms`` (or, ``queued``, ``queued_ms``) cycling through argument
    tuples whose tensors together exceed the 50 MB L2, so each launch reads
    its input from device memory as the train step's gradient and the
    decode step's weights are read (the work that touched them last has
    moved on to other tensors)."""
    import torch
    n = len(args_list)
    for i in range(warmup):
        fn(*args_list[i % n])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
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
    8 and 4 bits, with planted ties and an all-zero row; each timed with
    the L2 cold, queued (the kernel's time: ``ms``) and call by call (its
    wrapper's host dispatch included), beside its byte bound, its plain
    version and a PyTorch yardstick:
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
                    ms = time_cold_ms(kern, copies, queued=True)
                    call_ms = time_cold_ms(kern, copies)
                    plain_ms = time_ms(plain, iters=5)
                    lib, lib_dtype = _yardstick_ms(torch, lib_fn, x)
                    b, by = bound_ms(nbytes + extra, 7.0 * x.numel(),
                                     FP32_FLOPS)
                    rows[name].append(dict(
                        shape=f"({m},{f}) {dname} bits={bits} {kind}",
                        max_abs_err=err, ms=ms, call_ms=call_ms,
                        plain_ms=plain_ms,
                        bound_ms=b, bound_by=by, library_ms=lib,
                        library_dtype=lib_dtype))
                    print(f"{name} {kind:11s} ({m}, {f:4d}) {dname:8s} bits "
                          f"{bits}: bit-exact (tol 0), queued ms {ms:.4f}, "
                          f"call by call {call_ms:.4f}, plain_ms "
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
    bulk_sass_check(("qdq", "qdq_row_stream_kernel"))


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


def gpt2_train_cfg(**kw):
    """GPT-2 small as phases 7, 10, 11 and 14 train it: ``remat=False``
    pinned, so their launch gates (72 #3 a step) and their series of
    numbers keep the meaning they had before the port recomputed; their CE
    chunks are checkpointed all the same, as in the reference."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gpt2-small"), remat=False, **kw)


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
    from repro_torch.core.qconfig import Granularity, get_recipe
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import (LoopConfig, Trainer, init_train_state,
                                   make_train_step, train_path_summary)
    cfg = gpt2_train_cfg()
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
        cfg = gpt2_train_cfg()
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
                                   fused_adamw_leaves=1),
                "fallback": _expect(qdq_row=linears, fused_adamw_leaves=1)}
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
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig
    from repro_torch.train import (FaultPlan, LoopConfig, Trainer,
                                   init_train_state, make_train_step)
    cfg = gpt2_train_cfg()
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
    flips, pays, u_sign = _update_split(torch, got, ref)
    return {"ce": abs(got["loss"] - ref["loss"]),
            "grads": _rel_l2(torch, got["grads"], ref["grads"]),
            "sign_flips": flips, "updates_sign": u_sign,
            "updates": _rel_l2(torch, upd(got), upd(ref)), "payloads": pays}


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
    sum(dO * o), summed in float64 and rounded to fp32; returns (o, lse, dq,
    dk, dv, delta).  Under the causal mask at q_offset 0 query row 0 sees
    key 0 alone, so o_0 = v_0 and dp_00 - delta_0 is zero in exact
    arithmetic: with delta summed in fp32, dq's row 0 would be the
    difference of two fp32 orders of the same 64 products (rounding noise,
    more than one bf16 step apart between any two orders); the float64 sum
    gives delta its exact value, as the plain backward's float64 sums give
    dp theirs."""
    kw = dict(causal=causal, q_offset=off)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    delta = (do.double() * o.double()).sum(-1).float()
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return o, lse, dq, dk, dv, delta


def _flash_plain(fa, q, k, v, do, lse, delta, causal, off, **sums):
    """The plain versions on the kernels' inputs: #8's on q, k, v, #9's and
    #10's on the lse and delta the kernels read, their products summed in
    float64 (their default) or ``sum_dtype=``; returns (o, lse, dq, dk,
    dv)."""
    kw = dict(causal=causal, q_offset=off)
    o, lse_p = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                               **kw, **sums)
    dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw,
                                         **sums)
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
        # o, dq, dk, dv; then the controls, each one rounding of p or ds
        # moved: the plain forward with p left unrounded, with p rounded
        # against the row's final max (the reference's _ref_attend, one
        # tile), dv from p rounded to the carrier, and dk and dq from ds
        # rounded to the carrier (the products summed in float64, as the
        # plain backward's)
        dist = [_bf16_distance(torch, g, w)
                for g, w in zip(got[:1] + got[2:5], want[:1] + want[2:])]
        kw = dict(causal=causal, q_offset=off)
        ctrl_o = fa.flash_attention_fwd_lse_plain(
            q.float(), k.float(), v.float(), **kw)[0].to(q.dtype)
        row_o = fa.flash_attention_fwd_lse_plain(q, k, v, block_k=k.shape[1],
                                                 **kw)[0]
        p, ds = fa._bwd_plain(q, k, v, do, got[1], got[5], causal, off)
        f64 = torch.float64
        ctrl_dv = fa._product("bqk,bqd->bkd", p.to(q.dtype), do,
                              f64).to(q.dtype)
        del p
        ds = ds.to(q.dtype)
        ctrl_dk = fa._product("bqk,bqd->bkd", ds, q, f64).to(q.dtype)
        ctrl_dq = fa._product("bqk,bkd->bqd", ds, k, f64).to(q.dtype)
        del ds
        ctrl = [_bf16_distance(torch, c, w) for c, w in
                ((ctrl_o, want[0]), (row_o, want[0]), (ctrl_dv, want[4]),
                 (ctrl_dk, want[3]), (ctrl_dq, want[2]))]
        # readings, not gates: the plain forward with its scores summed in
        # fp32 (PR 15's plain version), and the plain backward with its
        # products summed in fp32, against the float64-summed ones
        f32 = _bf16_distance(torch, fa.flash_attention_fwd_lse_plain(
            q, k, v, score_dtype=torch.float32, **kw)[0], want[0])
        bwd32 = _flash_plain(fa, q, k, v, do, got[1], got[5], causal, off,
                             sum_dtype=torch.float32)[2:]
        f32_bwd = [_bf16_distance(torch, g, w) for g, w in zip(bwd32,
                                                                want[2:])]
        del bwd32
        lim = FLASH_BF16
        within = lambda d: d[0] <= lim["rel_l2"] and d[1] <= lim["over_ulp"]
        outside = lambda d: d[0] > lim["rel_l2"] and d[1] > lim["over_ulp"]
        ok &= all(within(d) for d in dist) and all(outside(d) for d in ctrl)
        pair = lambda ds_: ", ".join(f"{c[0]:.2e}, {c[1]:.2e}" for c in ds_)
        text = ("o/dq/dk/dv rel L2 " + "/".join(f"{d[0]:.2e}" for d in dist)
                + f" (limit {lim['rel_l2']:.0e}), over one bf16 step "
                + "/".join(f"{d[1]:.2e}" for d in dist)
                + f" (limit {lim['over_ulp']:.0e}); controls (rel L2, over "
                f"one step) p unrounded {pair(ctrl[:1])}, p against the "
                f"final max {pair(ctrl[1:2])}, dv with p rounded "
                f"{pair(ctrl[2:3])}, dk / dq with ds rounded "
                f"{pair(ctrl[3:])}: all above both limits "
                + ("yes" if all(outside(d) for d in ctrl) else "NO")
                + f"; fp32-summed plain scores {f32[0]:.2e}, {f32[1]:.2e}, "
                f"fp32-summed plain dq/dk/dv {pair(f32_bwd)}")
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
    together (a yardstick, unused by the port); #9, #10 and SDPA's backward
    also with the card's queue full (``queued_ms``).  The bound counts the
    least the tensor cores need: at hd = 64 and the bf16 carrier q / 8, k,
    v, dO and the forward's rounded p are bf16 values, so the score
    products, the forward's P.V and the backward's dO.V are each one
    bf16-exact product; each product with an fp32 operand (p^T dO, ds^T q,
    ds k) is three bf16-exact products (the operand split into three bf16
    terms), all at 989 TFLOP/s.  Last, the SASS checks
    (``flash_sass_check``)."""
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
            # the forward's float32 errors, as recorded since PR 15; the
            # backward's at bf16, the carrier of the main path's new kernels
            if label == "train" and dt == torch.float32:
                errs.update({"flash_attention_fwd": diff[0],
                             "flash_attention_fwd_lse": max(diff[0],
                                                            diff[1])})
            if label == "train" and dt == torch.bfloat16:
                errs.update({"flash_attention_bwd_dkdv": max(diff[3],
                                                             diff[4]),
                             "flash_attention_bwd_dq": diff[2]})
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
    sdpa_call = lambda: torch.autograd.grad(o4, leaves, do4,
                                            retain_graph=True)
    sdpa_bwd, sdpa_bwd_q = time_ms(sdpa_call), queued_ms(sdpa_call)
    pairs = _visible_pairs(s, s, True, 0) * bh
    tens, rows = bh * s * hd * 2, bh * s * 4     # bf16 tensor, fp32 rows
    mm = 2 * hd * pairs                          # one product over the pairs
    plan = (   # name, site line, kernel, plain, bytes, bf16-exact FLOPs
        ("flash_attention_fwd", 116, lambda: fa.flash_attention_fwd(q, k, v),
         lambda: fa.flash_attention_fwd_plain(q, k, v), 4 * tens, 2 * mm,
         sdpa_fwd, None, "SDPA forward"),
        ("flash_attention_fwd_lse", 275,
         lambda: fa.flash_attention_fwd_lse(q, k, v),
         lambda: fa.flash_attention_fwd_lse_plain(q, k, v), 4 * tens + rows,
         2 * mm, sdpa_fwd, None, "SDPA forward"),
        # q.k, dO.v, and three terms each of p^T dO and ds^T q
        ("flash_attention_bwd_dkdv", 344,
         lambda: fa.flash_attention_bwd_dkdv(*bwd),
         lambda: fa.flash_attention_bwd_dkdv_plain(*bwd),
         6 * tens + 2 * rows, 8 * mm, sdpa_bwd, sdpa_bwd_q,
         "SDPA backward, dq+dk+dv together"),
        # q.k, dO.v, and three terms of ds k
        ("flash_attention_bwd_dq", 369,
         lambda: fa.flash_attention_bwd_dq(*bwd),
         lambda: fa.flash_attention_bwd_dq_plain(*bwd),
         5 * tens + 2 * rows, 5 * mm, sdpa_bwd, sdpa_bwd_q,
         "SDPA backward, dq+dk+dv together"))
    for name, line, kern, plain, nbytes, f16, lib, lib_q, lib_what in plan:
        ms = time_ms(kern)
        ms_q = queued_ms(kern) if lib_q is not None else None
        plain_ms = time_ms(plain, iters=3, warmup=1)
        bd, by = bound_ms(nbytes, f16, BF16_FLOPS)
        queued = ("" if ms_q is None else
                  f" (queued {ms_q:.4f}; library queued {lib_q:.4f})")
        print(f"{name} BH={bh} S={s} hd={hd} causal bf16: ms {ms:.4f}, "
              f"plain_ms {plain_ms:.4f}, bound_ms {bd:.5f} ({by}; "
              f"{f16 / 1e9:.1f} GFLOP bf16-exact at 989 TFLOP/s, "
              f"{nbytes / 1e6:.1f} MB), {ms / bd:.1f}x the bound, "
              f"library_ms({lib_what}) {lib:.4f}{queued}")
        fwd = name in ("flash_attention_fwd", "flash_attention_fwd_lse")
        results[name] = dict(
            route="cuda", source="src/repro_torch/csrc/"
            + ("flash_fwd_sm90.cu" if fwd else "flash_bwd_sm90.cu"),
            replaces=f"src/repro/kernels/flash_attn.py:{line}",
            tol=FLASH_TOL["float32" if fwd else "bfloat16"],
            shape=f"BH={bh},S={s},hd={hd},causal", max_abs_err=errs[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bd, bound_by=by,
            library_ms=lib)
        if ms_q is not None:
            results[name].update(queued_ms=ms_q, library_queued_ms=lib_q)
    del q, k, v, do, o, lse, delta, bwd, q4, k4, v4, do4, leaves, o4

    # #8, #9 and #10 at hd 128 (the llama slice's head dim), BH 16, S 512,
    # causal, bf16
    b2, s2, d2 = 16, 512, 128
    q, k, v, do = (torch.randn((b2, s2, d2), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    bwd = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
    q4, k4, v4, do4 = (t.view(1, b2, s2, d2) for t in (q, k, v, do))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True))
    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = queued_ms(lambda: torch.autograd.grad(o4, leaves, do4,
                                                     retain_graph=True))
    mm2 = 2 * d2 * _visible_pairs(s2, s2, True, 0) * b2
    tens2, rows2 = b2 * s2 * d2 * 2, b2 * s2 * 4
    for name, fn, nbytes, ops, lib, lib_what, timer in (
            ("flash_attention_fwd_lse",
             lambda: fa.flash_attention_fwd_lse(q, k, v), 4 * tens2 + rows2,
             2 * mm2, sdpa, "SDPA forward", time_ms),
            ("flash_attention_bwd_dkdv",
             lambda: fa.flash_attention_bwd_dkdv(*bwd),
             6 * tens2 + 2 * rows2, 8 * mm2, sdpa_bwd,
             "SDPA backward, queued", queued_ms),
            ("flash_attention_bwd_dq", lambda: fa.flash_attention_bwd_dq(*bwd),
             5 * tens2 + 2 * rows2, 5 * mm2, sdpa_bwd,
             "SDPA backward, queued", queued_ms)):
        ms = timer(fn)
        bd, by = bound_ms(nbytes, ops, BF16_FLOPS)
        print(f"{name} BH={b2} S={s2} hd={d2} causal bf16: ms {ms:.4f}"
              f"{' (queued)' if timer is queued_ms else ''}, bound_ms "
              f"{bd:.5f} ({by}), {ms / bd:.1f}x the bound, "
              f"library_ms({lib_what}) {lib:.4f}")
        results[name]["hd128"] = dict(
            shape=f"BH={b2},S={s2},hd={d2},causal", ms=ms, bound_ms=bd,
            bound_by=by, library_ms=lib)
    del q, k, v, do, o, lse, bwd, q4, k4, v4, do4, leaves, o4
    flash_sass_check()


def _cuobjdump() -> str:
    """The toolkit's cuobjdump beside nvcc, else the copy Triton ships."""
    import importlib.util
    from repro_torch.kernels import _build
    cand = Path(_build.nvcc_path()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cand = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                / "cuobjdump")
        if cand.exists():
            return str(cand)
    fail("no cuobjdump beside nvcc or in Triton's package (the SASS checks "
         "of phases 6 and 13)")


def sass_counts(lib: str, mnemonic: str) -> dict:
    """Instructions whose opcode starts with ``mnemonic`` in each kernel of
    the built library ``csrc/<lib>.cu`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and any(tok.startswith(mnemonic)
                                    for tok in line.split()):
            counts[fn] += 1
    return counts


#: the SASS opcode of a 1-D bulk copy (``cp.async.bulk``) on sm_90a
BULK_SASS = "UBLKCP"


def bulk_sass_check(*libs) -> None:
    """Phases 6b and 9: the streaming kernels read by 1-D bulk copies --
    for each (library, kernel name) the ``BULK_SASS`` instructions of every
    instance of the kernel in the built library's SASS; fail if one has
    none."""
    for lib, kern in libs:
        counts = {k: v for k, v in sass_counts(lib, BULK_SASS).items()
                  if kern in k}
        print(f"{lib} SASS: {sum(counts.values())} {BULK_SASS} instructions "
              f"over {len(counts)} {kern} instances: "
              f"{sorted(counts.values())}")
        if not counts or not all(counts.values()):
            fail(f"a {kern} instance of {lib} has no {BULK_SASS}: {counts}")


def flash_sass_check() -> None:
    """Phase 13: the bf16 flash kernels run on the tensor cores -- the
    forward's (``flash_fwd_sm90.cu``, every head-dim template with and
    without the LSE store) and the backward's (``flash_bwd_sm90.cu``, dK/dV
    and dQ at each head-dim template): count the ``HGMMA`` instructions of
    each in the built library's SASS, and fail if any kernel has none."""
    for lib in ("flash_fwd_sm90", "flash_bwd_sm90"):
        counts = sass_counts(lib, "HGMMA")
        print(f"{lib} SASS: {sum(counts.values())} HGMMA instructions over "
              f"{len(counts)} kernels (each "
              f"{min(counts.values(), default=0)}-"
              f"{max(counts.values(), default=0)})")
        if not counts or min(counts.values()) == 0:
            fail(f"phase 13: a bf16 flash kernel of {lib} has no HGMMA: "
                 f"{counts}")


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
    healthy(eng, "phase 14b")
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


# ---------------------------------------------------------------------------
# Phase 16: the llama family at Yi-6B's full width
# ---------------------------------------------------------------------------

#: phase 16a: #3's (K, N) pairs in a Yi-6B layer -- wq and wo (4096, 4096),
#: wk and wv (4096, 512), w_gate and w_up (4096, 11008), w_down (11008,
#: 4096) -- at the decode step's 16 slots and a 2048-row prefill
YI_INT8_KN = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096))
YI_INT8_ROWS = (16, 2048)
#: the decode step's seven linears of one layer, in call order
YI_DECODE_KN = ((4096, 4096), (4096, 512), (4096, 512), (4096, 4096),
                (4096, 11008), (4096, 11008), (11008, 4096))
#: #11 at Yi's prefill: 2 prompts of 2048 over 4096-row buffers, 32 heads
#: over 4 KV heads of 128 (B, Sq, Skv, H, K, hd)
YI_Q8_SHAPE = (2, 2048, 4096, 32, 4, 128)
#: phases 16b and 16c: 16 slots of 4096 rows, 32 requests of 128-2048
#: prompt tokens, 64 new tokens each; the paged engine's pages hold 64 rows
YI_REQUESTS, YI_NEW, YI_SLOTS, YI_SEQ = 32, 64, 16, 4096
YI_PROMPT = (128, 2048)
#: the block linears of a llama layer
YI_LINEARS = 7
#: phase 16d, policy B at Yi-6B's width and 2 layers: phase 5's B_LIMIT
#: (0.1) cannot hold there.  Readings at seeds 0-3 (``tools/yi_readings.py``,
#: PERF.md): the card against the CPU 0.095-0.188, and the kernels' plain
#: versions on the card against the CPU 0.089-0.216 -- PyTorch's own fp32
#: ops on the two devices, carried by the per-token int8 codec across
#: 4,096- and 11,008-wide rows (1.4-27% of layer 1's K payloads differ).
#: Set above every reading; what shows the kernels right at this width is
#: the card against the card with the plain int8_matmul in the kernel's
#: place, bit-identical at every seed.
YI_B_LIMIT = 0.3


def check_int8_yi(torch, dev, gen, results):
    """Phase 16a, #3 at ``YI_INT8_KN`` x ``YI_INT8_ROWS``, bf16 output: the
    wrapper (and at M = 16 the cluster route twice, a repeat bit-identical)
    bit for bit against the plain version, timed queued and call by call
    beside the bound, the plain version and ``torch._int_mm`` (queued; at M
    = 16 on x zero-padded to 17 rows); the fused decode entry
    ``int8_quant_matmul`` bit for bit at M = 16 on bf16 rows (an all-zero
    row among them), a repeat bit-identical, and on rows holding a NaN or
    an infinity; the weight transpose that the tensor-core route runs on
    every call, timed alone; and the decode step's seven linears of a layer
    through the fused entry over four layers' distinct weights (700 MB, the
    L2 cold), ms per call beside the round's byte bound."""
    import importlib
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    from repro_torch.core.qconfig import Granularity, QuantSpec
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    dt = torch.bfloat16
    rows = []
    for k, n in YI_INT8_KN:
        for m in YI_INT8_ROWS:
            x, w, rs, cs = _int8_case(torch, dev, gen, m, k, n)
            want = im.int8_matmul_plain(x, w, rs, cs, out_dtype=dt)
            got = {"wrapper": im.int8_matmul(x, w, rs, cs, out_dtype=dt)}
            if m <= im.FWD_GEMV_MAX_M:
                got["gemv"] = im.int8_matmul_gemv(x, w, rs, cs, dt)
                got["gemv repeat"] = im.int8_matmul_gemv(x, w, rs, cs, dt)
            torch.cuda.synchronize()
            for name, g in got.items():
                if not torch.equal(g, want):
                    fail(f"phase 16a int8_matmul ({name}) M={m} K={k} N={n}: "
                         f"not bit-exact (max err "
                         f"{(g.float() - want.float()).abs().max().item()})")
            fn = (lambda: im.int8_matmul(x, w, rs, cs, dt))
            xl = x if m > 16 else torch.nn.functional.pad(
                x, (0, 0, 0, 17 - m))
            b, by = bound_ms(m * k + k * n + 4 * (m + n) + 2 * m * n,
                             2.0 * m * n * k, INT8_OPS)
            row = dict(shape=f"M={m},K={k},N={n},bfloat16",
                       fwd_route=im.fwd_route(m, n, k), max_abs_err=0.0,
                       ms=queued_ms(fn), ms_call=time_ms(fn),
                       plain_ms=time_ms(lambda: im.int8_matmul_plain(
                           x, w, rs, cs, dt), iters=3),
                       bound_ms=b, bound_by=by,
                       library_ms=queued_ms(lambda: torch._int_mm(xl, w)))
            if m <= im.FWD_GEMV_MAX_M:
                xf = (torch.randn((m, k), generator=gen, device=dev)
                      * 3).to(dt)
                xf[m // 2] = 0.0
                fwant = im.int8_quant_matmul_plain(xf, w, cs, spec, dt)
                fgot = im.int8_quant_matmul(xf, w, cs, spec, dt)
                again = im.int8_quant_matmul(xf, w, cs, spec, dt)
                xb = xf.clone()
                xb[3, k - 1] = float("nan")
                xb[5, 0] = float("inf")
                xb[9, k // 2] = float("-inf")
                xb[11, 1], xb[11, 2] = float("nan"), float("inf")
                bwant = im.int8_quant_matmul_plain(xb, w, cs, spec, dt)
                bgot = im.int8_quant_matmul(xb, w, cs, spec, dt)
                torch.cuda.synchronize()
                same = (bgot == bwant) | (bgot.isnan() & bwant.isnan())
                if not (torch.equal(fgot, fwant) and torch.equal(again, fgot)
                        and bool(same.all())
                        and bool(bgot[[3, 11]].isnan().all())):
                    fail(f"phase 16a int8_quant_matmul M={m} K={k} N={n}: not "
                         f"bit-exact, a repeat differs, or rows holding a NaN "
                         f"or an infinity differ from the plain version")
                ffn = (lambda: im.int8_quant_matmul(xf, w, cs, spec, dt))
                row.update(fused_ms=queued_ms(ffn), fused_ms_call=time_ms(ffn))
            else:
                row["transpose_ms"] = queued_ms(lambda: im.transpose_packed(w))
            rows.append(row)
            extra = (f"; fused entry bit-exact (NaN and inf rows too), "
                     f"queued {row['fused_ms']:.4f} (call by call "
                     f"{row['fused_ms_call']:.4f})" if "fused_ms" in row else
                     f"; its weight transpose alone {row['transpose_ms']:.4f}")
            print(f"phase 16a int8_matmul M={m:5d} K={k:5d} N={n:5d} bf16: "
                  f"bit-exact (tol 0), route {row['fwd_route']}; queued ms "
                  f"{row['ms']:.4f} (call by call {row['ms_call']:.4f}), "
                  f"plain_ms {row['plain_ms']:.4f}, bound_ms "
                  f"{row['bound_ms']:.5f} ({by}), library_ms (torch._int_mm"
                  f"{'' if m > 16 else ' on 17 rows'}, queued) "
                  f"{row['library_ms']:.4f}{extra}")
            del x, w, rs, cs, want, got
    # the transposes a prefill launch runs: 32 layers x 7 linears
    per_layer = sum(next(r["transpose_ms"] for r in rows
                         if r["shape"].startswith(f"M=2048,K={k},N={n},"))
                    for k, n in YI_DECODE_KN)
    print(f"phase 16a int8_matmul: the tensor-core route's weight transposes "
          f"of one prefill launch (32 layers x {YI_LINEARS} linears, queued): "
          f"{32 * per_layer:.3f} ms")
    args = []
    for _ in range(4):
        for k, n in YI_DECODE_KN:
            _, w, _, cs = _int8_case(torch, dev, gen, 16, k, n)
            xf = torch.randn((16, k), generator=gen, device=dev).to(dt)
            args.append((xf, w, cs, spec, dt))
    nbytes = sum(a[0].numel() * 2 + a[1].numel() + 4 * a[1].shape[1]
                 + 2 * 16 * a[1].shape[1] for a in args)
    cold = dict(weights=len(args),
                weight_bytes=sum(a[1].numel() for a in args),
                bound_ms=nbytes / HBM_BPS * 1e3 / len(args),
                ms=time_cold_ms(im.int8_quant_matmul, args, 2 * len(args),
                                len(args), queued=True),
                ms_call=time_cold_ms(im.int8_quant_matmul, args,
                                     2 * len(args), len(args)))
    print(f"phase 16a int8_quant_matmul L2 cold, a round over a Yi layer's "
          f"7 linears x 4 ({cold['weight_bytes'] / 1e6:.1f} MB) at M = 16: "
          f"ms per call queued {cold['ms']:.4f}, call by call "
          f"{cold['ms_call']:.4f}; bound {cold['bound_ms']:.5f} (bytes); a "
          f"decode step's 224: {224 * cold['ms']:.3f} ms queued")
    del args
    results["int8_matmul"]["yi"] = dict(shapes=rows, l2_cold=cold)


def yi_kernels(torch, dev, gen, results):
    """Phase 16a: #3, #11, #12 and #13 at Yi-6B's shapes against their
    plain versions with phase 3's gates (#12 and #13 with the positions on
    the chunk edges, #13 at pages of 16, 64 and 256 bit for bit against
    #12 on the same logical cache)."""
    check_int8_yi(torch, dev, gen, results)
    check_flash_q8(torch, dev, gen, results, shapes=(YI_Q8_SHAPE,), tag="yi")
    check_decode_attention(torch, dev, gen, results, shape=YI_DECODE_SHAPE,
                           tag="yi")
    check_decode_attention_paged(torch, dev, gen, results,
                                 shape=YI_DECODE_SHAPE, tag="yi")


def yi_prompts(cfg, seed):
    """The 32 prompts of phases 16b and 16c (128-2048 tokens), drawn from
    ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(YI_PROMPT[0], YI_PROMPT[1] + 1, size=YI_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def _yi_serve_run(torch, eng, cfg, prompts, label):
    """Serve ``prompts`` to length through ``eng``'s queue with the counts
    and the peak memory reset before; checks every request's 64 tokens and
    the launch counts against the engine's own prefill and decode counts.
    Returns (counts, tokens by request in submit order, stats)."""
    from repro_torch import kernels
    from repro_torch.infer import Request
    ids = [eng.submit(Request(tokens=p, max_new_tokens=YI_NEW))
           for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = dict(eng.stats)
    if sorted(r.request_id for r in out) != sorted(ids):
        fail(f"{label}: not every request answered")
    for r in out:
        if (len(r.tokens) != YI_NEW or r.finish_reason != "length"
                or not all(0 <= t < cfg.vocab_size for t in r.tokens)):
            fail(f"{label}: request {r.request_id}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    gen_tok = sum(len(r.tokens) for r in out)
    lat = eng.scheduler.latency_stats()
    dec_ms = st["decode_s"] * 1e3 / max(st["decode_steps"], 1)
    print(f"{label}: {eng.path_summary()}, {cfg.name} {cfg.n_layers}L d="
          f"{cfg.d_model} H={cfg.n_heads} K={cfg.n_kv_heads} hd="
          f"{cfg.head_dim} carrier {cfg.dtype}, {YI_SLOTS} slots x {YI_SEQ} "
          f"rows, {len(out)} requests of {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} prompt tokens, {YI_NEW} new each: "
          f"{gen_tok} tokens in {wall:.3f} s ({gen_tok / wall:.1f} tok/s end "
          f"to end); prefill {st['prefill_calls']} launches "
          f"{st['prefill_s'] * 1e3:.1f} ms ({st['prefill_tokens']} prompt "
          f"tokens, {st['prefill_tokens'] / max(st['prefill_s'], 1e-9):.0f} "
          f"tok/s); decode {st['decode_steps']} steps "
          f"{st['decode_s'] * 1e3:.1f} ms ({dec_ms:.2f} ms/step, "
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tok/s); "
          f"latency p50 {lat['p50_s']:.3f} s p99 {lat['p99_s']:.3f} s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated at rest {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB)")
    print(f"{label}: launch counts {counts}")
    attn = "decode_attention_paged" if eng.paged else "decode_attention"
    want = {"int8_matmul": YI_LINEARS * cfg.n_layers
            * (st["prefill_calls"] + st["decode_steps"]),
            "flash_attention_fwd_q8": cfg.n_layers * st["prefill_calls"],
            attn: cfg.n_layers * st["decode_steps"]}
    for name, n in counts.items():
        if n != want.get(name, 0) or (name in want and n <= 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")
    tokens = {r.request_id: r.tokens for r in out}
    return counts, [tokens[i] for i in ids], st


def _head_ms(torch, eng, cfg):
    """Device ms of the decode step's untied head on 16 rows, queued: the
    whole ``logits_chunk``, and apart its fp32 upcast of the (d, V) head
    and the fp32 product."""
    from repro_torch.models.lm import logits_chunk
    h = torch.randn((YI_SLOTS, 1, cfg.d_model), device="cuda").bfloat16()
    head = eng.params["lm_head"]
    hf = head.to(torch.float32)
    return dict(head_ms=queued_ms(lambda: logits_chunk(eng.params, h, cfg,
                                                       eng.policy)),
                upcast_ms=queued_ms(lambda: head.to(torch.float32)),
                product_ms=queued_ms(lambda: torch.matmul(
                    h.to(torch.float32), hf)))


def serve_yi(torch, dev, seed):
    """Phase 16b: Yi-6B at full width and depth (``configs/yi_6b.py``),
    random float32 weights from ``seed`` on the card's generator, freed once
    the engine has prepared them: the dense engine under ``POLICY`` (bf16
    carrier, W8A8 prepared weights, int8 KV), 16 slots of 4096 rows, the 32
    requests of ``yi_prompts`` to 64 tokens each.  Each kernel launches as
    often as the engine's counts say (224 #3 and 32 #12 a decode step, 224
    #3 and 32 #11 a prefill launch); then one profiled decode step and the
    untied head's share.  Returns (counts, tokens, stats, the engine's
    prepared parameters for 16c)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.infer.prepare import params_nbytes
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("yi-6b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    fp32_bytes = params_nbytes(params)
    eng = Engine(model, params, POLICY, max_slots=YI_SLOTS, max_seq=YI_SEQ,
                 device=dev, seed=seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"phase 16b: {cfg.name} float32 weights {fp32_bytes / 1e9:.2f} GB "
          f"drawn and prepared in {time.perf_counter() - t0:.1f} s, freed; "
          f"the engine holds {params_nbytes(eng.params) / 1e9:.2f} GB of "
          f"parameters (int8 block weights, bf16 embedding and head) and "
          f"{eng.kv_cache_nbytes() / 1e9:.2f} GB of int8 KV cache")
    prompts = yi_prompts(cfg, seed)
    counts, tokens, st = _yi_serve_run(torch, eng, cfg, prompts,
                                       "phase 16b engine")
    healthy(eng, "phase 16b")
    profile_decode(torch, eng, cfg, np.random.RandomState(seed + 3))
    head = _head_ms(torch, eng, cfg)
    print(f"phase 16b: the untied head on 16 rows, queued: logits_chunk "
          f"{head['head_ms']:.4f} ms a decode step, of which its fp32 upcast "
          f"of the (4096, 64000) head alone {head['upcast_ms']:.4f} ms and "
          f"the fp32 product alone {head['product_ms']:.4f} ms")
    eng.scheduler.stop()
    return counts, tokens, st, eng.params


def serve_yi_paged(torch, dev, seed, params, dense_tokens, dense_stats):
    """Phase 16c: phase 16b's requests through the paged engine (pages of
    64 rows, the default pool) on the same prepared parameters: the tokens
    equal 16b's, 224 #3 and 32 #13 a decode step (no #12), every page back
    after the run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("yi-6b")
    eng = Engine(build_model(cfg), params, POLICY, max_slots=YI_SLOTS,
                 max_seq=YI_SEQ, device=dev, seed=seed, paged=True,
                 page_size=PAGE)
    counts, tokens, st = _yi_serve_run(torch, eng, cfg, yi_prompts(cfg, seed),
                                       "phase 16c paged engine")
    healthy(eng, "phase 16c")
    for i, (got, want) in enumerate(zip(tokens, dense_tokens)):
        if got != want:
            at = next(j for j, (a, c) in enumerate(zip(got, want)) if a != c)
            fail(f"phase 16c: request {i} differs from the dense engine's at "
                 f"token {at} ({got[at]} vs {want[at]})")
    if eng.pool.free_pages != eng.n_pages - 1 or eng.pool.live_pages:
        fail(f"phase 16c: pages kept after the run: {eng.pool.free_pages} "
             f"free of {eng.n_pages - 1}")
    dense_ms = dense_stats["decode_s"] * 1e3 / max(dense_stats["decode_steps"],
                                                   1)
    print(f"phase 16c: tokens equal to phase 16b's for all {len(tokens)}; "
          f"{eng.n_pages} pages of {PAGE} rows, every page back; peak live "
          f"KV {eng.scheduler.peak_live_bytes / 1e9:.3f} GB of the dense "
          f"cache's {eng.kv_cache_nbytes() / 1e9:.3f} GB pool; decode "
          f"{st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} ms/step "
          f"against the dense engine's {dense_ms:.2f}")
    profile_decode(torch, eng, cfg, np.random.RandomState(seed + 3))
    eng.scheduler.stop()
    return counts


def yi_card_vs_cpu(torch, dev, seed):
    """Phase 16d: phase 5 at Yi-6B's full width and 2 layers (float32
    carrier, ``true_fan_in`` weights, the gated leaves included), with
    phase 5's A check and limit, and its B check with ``YI_B_LIMIT``."""
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    card_vs_cpu(torch, dev, seed, cfg=dataclasses.replace(
        get_config("yi-6b"), n_layers=2, dtype="float32"),
        b_limit=YI_B_LIMIT)


def _serve_ladder_engine(dev, seed, model, params, policy, paged, **kw):
    from repro_torch.infer import Engine
    if paged:
        kw.update(paged=True, page_size=PAGE)
    return Engine(model, params, policy, max_slots=SERVE_SLOTS,
                  max_seq=SERVE_SEQ, device=dev, seed=seed, **kw)


def _serve_counted(torch, eng, prompts, label):
    """Serve ``prompts`` (64 new tokens each) through ``eng``'s queue with
    the launch counts reset before; -> (responses in submit order, counts,
    wall seconds)."""
    from repro_torch import kernels
    from repro_torch.infer import Request
    ids = [eng.submit(Request(tokens=p, max_new_tokens=SERVE_NEW))
           for p in prompts]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = {r.request_id: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    eng.scheduler.stop()
    if sorted(out) != sorted(ids):
        fail(f"{label}: not every request answered")
    return [out[i] for i in ids], counts, wall


def serve_dequant(torch, dev, seed):
    """Phase 17a: an engine whose rung 0 is dequantize-on-read
    (``DEQUANT_POLICY``: a per-tensor KV spec, which no kernel takes), dense
    and paged (pages of 64), on phase 4's weights and the 32 requests of
    ``ladder_prompts``.  Every request answered to length; ``path_summary``
    reads ``kv=int8-dequant`` and ``kv=int8-paged-gather(p64)``; exactly
    72 ``int8_matmul`` a decode step and a prefill launch and no other
    kernel; the healthy path never degrades; every page comes back; the
    paged tokens equal the dense ones bit for bit for every request.  (A
    per-tensor scale covers a prompt's whole prefill write block, pad rows
    included: the bucket in the dense engine, the launch's row in the
    paged one.  The prompts share one bucket, a whole number of pages, so
    the two blocks are the same; where they are not, the two engines
    differ in both packages, which
    ``tests/test_torch_serve_ladder.py::test_a8n_paged_differs_from_dense_where_blocks_differ``
    shows on the CPU.)  Returns the launch counts of the two runs."""
    cfg, model, params = serve_model(torch, dev, seed)
    prompts = ladder_prompts(cfg, seed)
    total, tokens = {}, {}
    for paged in (False, True):
        label = f"phase 17a {'paged' if paged else 'dense'}"
        eng = _serve_ladder_engine(dev, seed, model, params,
                                   DEQUANT_POLICY, paged)
        want_kv = "int8-paged-gather(p64)" if paged else "int8-dequant"
        if eng.path_summary().split(" kv=")[1] != want_kv:
            fail(f"{label}: {eng.path_summary()}, expected kv={want_kv}")
        if eng._rungs != ["dequant", "fp"]:
            fail(f"{label}: rungs {eng._rungs}")
        out, counts, wall = _serve_counted(torch, eng, prompts, label)
        st = eng.stats
        for r in out:
            if len(r.tokens) != SERVE_NEW or r.finish_reason != "length":
                fail(f"{label}: request {r.request_id}: {len(r.tokens)} "
                     f"tokens, {r.finish_reason}")
        want = _expect(int8_matmul=6 * cfg.n_layers * (st["prefill_calls"]
                                                       + st["decode_steps"]))
        healthy(eng, label)
        if paged and (eng.pool.free_pages != eng.n_pages - 1
                      or eng.pool.live_pages):
            fail(f"{label}: pages kept after the run: {eng.pool.free_pages} "
                 f"free of {eng.n_pages - 1}")
        print(f"{label}: {eng.path_summary()}, {len(out)} requests of "
              f"{SERVE_NEW} tokens in {wall:.3f} s; prefill "
              f"{st['prefill_calls']} launches {st['prefill_s'] * 1e3:.1f} "
              f"ms, decode {st['decode_steps']} steps "
              f"{st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.2f} "
              f"ms/step; launch counts {counts}")
        if counts != want or not counts["int8_matmul"]:
            fail(f"{label}: launches {counts}, expected {want}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        tokens[paged] = [r.tokens for r in out]
    bad = [i for i, (a, b) in enumerate(zip(tokens[True], tokens[False]))
           if a != b]
    if bad:
        fail(f"phase 17a: paged tokens differ from dense in requests {bad}")
    print(f"phase 17a: paged tokens bit-equal to dense for all "
          f"{len(prompts)} requests")
    return total


def dequant_card_vs_cpu(torch, dev, seed, quiet=False):
    """Phase 17b, teacher-forced as phase 5 (float32 carrier,
    ``true_fan_in`` weights of seed + 1, 2 prompts of 64 tokens + 8
    decode steps).  (i) ``kv_cache=a8n,*=w8c``, dequantize-on-read on the
    card against the CPU: max |d logit| within phase 5's A limit 1e-2,
    top-1 equal wherever the CPU's margin exceeds it.  (ii) an a8t model
    (``kv_cache=a8t,*=w8c``) on its dequant path against its fused path
    (#11, #12), both on the card: max |d logit| within
    ``DEQUANT_FUSED_LIMIT``; the same at the bfloat16 carrier, the control,
    must exceed it.  Returns the three readings."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("gpt2-small"), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    params = true_fan_in(model.init_params(gen, device="cpu"), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64 + 8), generator=gen)
    policy = "kv_cache=a8n,*=w8c"
    cpu, _ = _teacher_forced(torch, model, cfg, params, toks, policy, "cpu")
    card, _ = _teacher_forced(torch, model, cfg, params, toks, policy, dev)
    err, n_agree, n_bad = _agreement(torch, card, cpu, 1e-2)
    a8t = "kv_cache=a8t,*=w8c"
    rungs = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        m = build_model(c)
        for path in ("fused", "dequant"):
            rungs[dtype, path], _ = _teacher_forced(
                torch, m, c, params, toks, a8t, dev, kv_path=path)
    d32 = (rungs["float32", "dequant"] - rungs["float32", "fused"]
           ).abs().max().item()
    d16 = (rungs["bfloat16", "dequant"] - rungs["bfloat16", "fused"]
           ).abs().max().item()
    if quiet:
        return err, d32, d16
    limit = DEQUANT_FUSED_LIMIT
    print(f"phase 17b (i) {policy} card vs cpu (float32 carrier): max "
          f"|dlogit| {err:.3e} (limit 1.0e-02), top-1 agree {n_agree}/"
          f"{cpu.shape[0] * cpu.shape[1]} ({n_bad} disagreements where the "
          f"CPU's top-2 margin > limit)")
    print(f"phase 17b (ii) {a8t} on the card, the dequant rung against the "
          f"fused rung: max |dlogit| {d32:.3e} at float32 (limit "
          f"{limit:.1e}), the bfloat16-carrier control {d16:.3e} (must "
          f"exceed the limit)")
    if not (err <= 1e-2 and n_bad == 0 and bool(torch.isfinite(card).all())):
        fail("phase 17b: the dequant path's card and CPU logits disagree")
    if not d32 <= limit:
        fail(f"phase 17b: dequant rung vs fused rung {d32:.3e} > {limit:.1e}")
    if not d16 > limit:
        fail(f"phase 17b: the bf16 control {d16:.3e} lies within "
             f"{limit:.1e}")
    return err, d32, d16


def serve_ladder(torch, dev, seed):
    """Phase 17c: the walk.  ``POLICY`` dense and paged (pages of 64), the
    first ``SERVE_LADDER_REQUESTS`` of 17a's prompts, 64 new tokens each,
    ``MonitorConfig(reprobe_after=SERVE_LADDER_REPROBE)`` and
    ``SERVE_LADDER_PLAN``.  The transitions equal ``SERVE_LADDER_EXPECT``;
    two kernel errors; exactly two requests end ``numerics`` and the rest
    ``length``; #12 (dense) or #13 (paged) launches 12 times for each
    decode step the engine completed on the fused rung, #11 12 times a
    prefill launch, #3 72 times a decode step and a prefill launch; the
    paged tokens and finish reasons equal the dense ones for every request
    (the prompts share one bucket, so both engines seat request i in slot
    i and the slot-keyed NaN faults hit the same requests) and every page
    comes back.  Each rung's decode ms/step is printed (readings, not
    gates).  Returns the launch counts of the two runs."""
    from repro_torch.infer import MonitorConfig
    from repro_torch.train import FaultPlan
    cfg, model, params = serve_model(torch, dev, seed)
    prompts = ladder_prompts(cfg, seed)[:SERVE_LADDER_REQUESTS]
    total, tokens = {}, {}
    for paged in (False, True):
        label = f"phase 17c {'paged' if paged else 'dense'}"
        eng = _serve_ladder_engine(
            dev, seed, model, params, POLICY, paged,
            monitor=MonitorConfig(reprobe_after=SERVE_LADDER_REPROBE))
        plan = FaultPlan.parse(SERVE_LADDER_PLAN)
        eng.fault_hooks = plan.engine_hooks()
        out, counts, wall = _serve_counted(torch, eng, prompts, label)
        s = eng.resilience_summary()
        st = eng.stats
        walk = serve_walk(s)
        by_rung = st["rung_steps"]
        attn = "decode_attention_paged" if paged else "decode_attention"
        want = _expect(int8_matmul=6 * cfg.n_layers * (st["prefill_calls"]
                                                       + st["decode_steps"]),
                       flash_attention_fwd_q8=cfg.n_layers
                       * st["prefill_calls"],
                       **{attn: cfg.n_layers * by_rung["fused"]})
        reasons = sorted(r.finish_reason for r in out)
        quarantined = [r.request_id for r in out
                       if r.finish_reason == "numerics"]
        print(f"{label}: {len(out)} requests, plan {plan.describe()}, fired "
              f"{plan.fired}; walk {walk}; kernel_errors "
              f"{s['kernel_errors']}, quarantined requests {quarantined}, "
              f"finish reasons {reasons}; decode steps {s['decode_steps']} "
              f"(by rung {by_rung}); in {wall:.3f} s; launch counts "
              f"{counts}")
        print(f"{label}: decode ms/step by rung on {card_line()}: "
              + ", ".join(f"{r} {1e3 * st['rung_s'][r] / max(n, 1):.2f} "
                          f"({n} steps)" for r, n in by_rung.items()))
        if walk != SERVE_LADDER_EXPECT:
            fail(f"{label}: walk {walk} != SERVE_LADDER_EXPECT "
                 f"{SERVE_LADDER_EXPECT}")
        if s["kernel_errors"] != 2 or reasons != (
                ["length"] * (len(out) - 2) + ["numerics"] * 2):
            fail(f"{label}: kernel_errors {s['kernel_errors']}, finish "
                 f"reasons {reasons}")
        for r in out:
            if r.finish_reason == "length" and len(r.tokens) != SERVE_NEW:
                fail(f"{label}: request {r.request_id}: {len(r.tokens)} "
                     f"tokens")
        if sum(by_rung.values()) != s["decode_steps"] or not all(
                by_rung.values()):
            fail(f"{label}: decode steps by rung {by_rung} of "
                 f"{s['decode_steps']}")
        if counts != want or not counts["flash_attention_fwd_q8"]:
            fail(f"{label}: launches {counts}, expected {want}")
        if paged and (eng.pool.free_pages != eng.n_pages - 1
                      or eng.pool.live_pages):
            fail(f"{label}: pages kept after the run: {eng.pool.free_pages} "
                 f"free of {eng.n_pages - 1}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        tokens[paged] = [(r.finish_reason, r.tokens) for r in out]
    bad = [i for i, (a, b) in enumerate(zip(tokens[True], tokens[False]))
           if a != b]
    if bad:
        fail(f"phase 17c: paged tokens or finish reasons differ from dense "
             f"in requests {bad}")
    print(f"phase 17c: paged tokens and finish reasons equal to dense for "
          f"all {len(prompts)} requests")
    return total


def serve_oom(torch, dev, seed):
    """Phase 17d: ``SERVE_OOM_PLAN`` on the paged engine (``POLICY``,
    pages of 64, the default pool): 16 requests whose prompts of 246 and
    245 tokens need their fifth page at decode steps 10 and 11, while the
    plan holds every free page (steps 10-12).  At least one preemption,
    never a ``CapacityError``; every request to length, every page back."""
    import numpy as np
    from repro_torch.train import FaultPlan
    cfg, model, params = serve_model(torch, dev, seed)
    rng = np.random.RandomState(seed + 4)
    prompts = [rng.randint(0, cfg.vocab_size, 246 - i % 2).tolist()
               for i in range(16)]
    eng = _serve_ladder_engine(dev, seed, model, params, POLICY, True)
    plan = FaultPlan.parse(SERVE_OOM_PLAN)
    eng.fault_hooks = plan.engine_hooks()
    out, _, wall = _serve_counted(torch, eng, prompts, "phase 17d")
    bad = [(r.request_id, len(r.tokens), r.finish_reason) for r in out
           if len(r.tokens) != SERVE_NEW or r.finish_reason != "length"]
    print(f"phase 17d: {plan.describe()} on the paged engine, 16 requests "
          f"of 245-246 prompt tokens: {len(out)} served in {wall:.3f} s, "
          f"fired {plan.fired}, preemptions {eng.preemptions}, pages free "
          f"after {eng.pool.free_pages}/{eng.n_pages - 1}")
    if bad or plan.fired != [SERVE_OOM_PLAN]:
        fail(f"phase 17d: requests not served to length {bad}, fired "
             f"{plan.fired}")
    if eng.preemptions < 1:
        fail("phase 17d: the drained pool preempted nothing")
    if eng.pool.free_pages != eng.n_pages - 1 or eng.pool.live_pages:
        fail(f"phase 17d: pages kept after the run: {eng.pool.free_pages} "
             f"free of {eng.n_pages - 1}")
    healthy(eng, "phase 17d")


# ---------------------------------------------------------------------------
# phase 18: llama pre-training at Yi-6B's width, with recomputation
# ---------------------------------------------------------------------------

#: phase 18a: 16 of Yi-6B's 32 layers (the full depth needs more than one
#: 80 GB card: FSDP, ROADMAP section 1, item 8), 2 x 4096 tokens a step, 6
#: steps; 18b and 18c at 4 layers; 18c's second run 2 steps of 18a's shape
#: under ``_attend``; 18d card against CPU at 2 layers, 1 x 128 tokens
YI_TRAIN_LAYERS, YI_TRAIN_BATCH, YI_TRAIN_SEQ, YI_TRAIN_STEPS = 16, 2, 4096, 6
YI_REMAT_LAYERS, YI_XLA_STEPS = 4, 2
YI_CHECK_LAYERS, YI_CHECK_BATCH, YI_CHECK_SEQ = 2, 1, 128
#: phase 18c: ``_attend`` in q-chunks against one block at 4 layers x 1 x
#: 4096 tokens, ``TRAIN_POLICY``: limits on |d ce| and the gradients'
#: relative L2 distance, set from the readings at seeds 0-3 recorded in
#: PERF.md (``tools/yi_train_readings.py``).  The forward repeats its bits
#: (|d ce| read 0 at every seed), so ce is held bit for bit.  The backward
#: adds the chunks' dk and dv in bf16, one chunk at a time, where one
#: block rounds each sum once (the reference's scan does the same), and
#: the int8 gradient codecs carry those last bits into whole steps: the
#: gradients read 3.29e-2 to 3.86e-2, held to 6e-2.
YI_CHUNK_LIMITS = {"ce": 0.0, "grads": 6e-2}
#: phase 18d: the card against the CPU for one train step at Yi-6B's width
#: and 2 layers, set from the readings at seeds 0-3 recorded in PERF.md
#: (``tools/yi_train_readings.py``; not sized at run time).  Phase 8's
#: ``TRAIN_LIMITS`` hold but for two: |d ce| read 1.1e-4 to 5.1e-3 (its
#: limit 1e-3) and the updates where the sign agrees 1.57e-2 to 2.09e-2
#: (2e-2).  The bf16-carrier control read grads 6.34e-2 to 6.42e-2, sign
#: flips 1.104e-2 to 1.109e-2, updates 0.2313 to 0.2321 and updates where
#: the sign agrees 2.795e-2 to 2.843e-2, each above its limit below; its
#: |d ce| (4.0e-3 to 9.7e-3) lies among the sound readings, so ce cannot
#: tell the two apart at this width and is held to 1e-2, twice the largest
#: sound reading, and left out of the control's check.
YI_TRAIN_LIMITS = dict(TRAIN_LIMITS, ce=1e-2, updates_sign=2.4e-2)
YI_CONTROL = ("grads", "sign_flips", "updates_sign", "updates")


def yi_train_cfg(layers, impl="flash_pallas", **kw):
    """Yi-6B's published widths (``configs/yi_6b.py``) at ``layers``
    layers, ``remat`` on (the config's default) unless ``kw`` says
    otherwise."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("yi-6b"), n_layers=layers,
                               attention_impl=impl, **kw)


def _yi_tokens(torch, dev, cfg, batch, seq):
    from repro_torch.data import SyntheticCorpus
    return torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=batch, seq_len=seq)).to(dev)


def _loss_and_grads(torch, cfg, params, toks, policy=TRAIN_POLICY):
    """(ce, flat gradients, launch counts, peak bytes above the allocation
    before the step) of one forward and backward of ``policy``."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.train.step import value_and_grad
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss, _, grads = value_and_grad(build_model(cfg), policy, params,
                                    {"tokens": toks})
    torch.cuda.synchronize()
    return (loss, tree_flatten(grads)[0], kernels.launch_counts(),
            torch.cuda.max_memory_allocated() - base)


@contextlib.contextmanager
def one_block_attend(seq):
    """``_attend`` in one block up to ``seq`` query rows: the score budget
    lifted and ``MAX_DENSE_Q`` raised to ``seq`` (``_pick_chunk`` never
    takes more rows than that), both restored after."""
    from repro_torch.models import attention
    saved = attention.SCORE_BUDGET_BYTES, attention.MAX_DENSE_Q
    attention.SCORE_BUDGET_BYTES, attention.MAX_DENSE_Q = float("inf"), seq
    try:
        yield
    finally:
        attention.SCORE_BUDGET_BYTES, attention.MAX_DENSE_Q = saved


def _grads_distance(torch, a, b):
    """|d ce|, the gradients' relative L2 distance, and whether ce and
    every gradient are bit-identical, of two ``_loss_and_grads``."""
    same = torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    return abs(float(a[0]) - float(b[0])), _rel_l2(torch, a[1], b[1]), same


def train_yi(torch, dev, seed):
    """Phase 18a: Yi-6B pre-training on the card -- ``YI_TRAIN_LAYERS``
    layers at full width, ``YI_TRAIN_BATCH`` x ``YI_TRAIN_SEQ`` tokens a
    step, ``flash_pallas``, recomputation on, ``TRAIN_POLICY`` with int
    moments, random weights from ``seed``: phase 7's checks and numbers
    (``train``), the launches a step exactly ``train_launches``: 14 #3 a
    layer (each of the 7 linears again in the backward), 7 #4 and 7 #5 a
    layer, one #6, 2 #8 a layer (the forward, and again in the
    recomputation) and one #9 and #10.  Returns the launch counts."""
    return train(torch, dev, seed, cfg=yi_train_cfg(YI_TRAIN_LAYERS),
                 batch=YI_TRAIN_BATCH, seq=YI_TRAIN_SEQ,
                 steps=YI_TRAIN_STEPS, tag="phase 18a train_yi")


def yi_remat(torch, dev, seed):
    """Phase 18b: at ``YI_REMAT_LAYERS`` layers and 18a's tokens, one
    forward and backward with recomputation on and one with it off, from
    the same weights: ce and every gradient bit-identical, the peak
    (above the weights) lower with recomputation; the launches of each."""
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = yi_train_cfg(YI_REMAT_LAYERS)
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = _yi_tokens(torch, dev, cfg, YI_TRAIN_BATCH, YI_TRAIN_SEQ)
    on = _loss_and_grads(torch, cfg, params, toks)
    off = _loss_and_grads(torch, dataclasses.replace(cfg, remat=False),
                          params, toks)
    d_ce, g_rel, same = _grads_distance(torch, on, off)
    show = lambda c: {k: v for k, v in c.items() if v}
    print(f"phase 18b: {cfg.name} {cfg.n_layers}L, {YI_TRAIN_BATCH} x "
          f"{YI_TRAIN_SEQ} tokens, flash_pallas: ce {float(on[0]):.6f} "
          f"(remat on) vs {float(off[0]):.6f} (off); ce and all "
          f"{len(on[1])} gradients "
          f"{'bit-identical' if same else 'DIFFER'} (tol 0; |d ce| "
          f"{d_ce:.3e}, grads rel L2 {g_rel:.3e}); peak above the weights "
          f"{on[3] / 2 ** 30:.2f} GiB with recomputation, "
          f"{off[3] / 2 ** 30:.2f} GiB without; launches on {show(on[2])}, "
          f"off {show(off[2])}")
    want_on, want_off = (train_launches(c) for c in
                         (cfg, dataclasses.replace(cfg, remat=False)))
    for got, want in ((on[2], want_on), (off[2], want_off)):
        want = dict(want, fused_adamw_leaves=0)
        if got != want:
            fail(f"phase 18b: launches {show(got)}, expected {show(want)}")
    if not same:
        fail("phase 18b: recomputation changed ce or a gradient")
    if not on[3] < off[3]:
        fail("phase 18b: the peak is not lower with recomputation")


def yi_attend_chunks(torch, dev, seed):
    """Phase 18c: ``_attend`` in q-chunks on the card.  At
    ``YI_REMAT_LAYERS`` layers and 1 x 4096 tokens the fp32 score slab of
    one block is 2.1 GB, so ``_pick_chunk`` takes chunks of 1024 rows;
    the same step under ``one_block_attend`` runs one block.  ce and every
    gradient within ``YI_CHUNK_LIMITS``, and the same pair under ``*=fp``
    printed beside them.  Then 18a's shape under ``attention_impl="xla"`` for
    ``YI_XLA_STEPS`` finite steps (chunks of 512 rows at B = 2), phase 7's
    checks.  Returns that run's launch counts."""
    from repro_torch.models import build_model
    from repro_torch.train.step import recompute_desc
    gc.collect()
    torch.cuda.empty_cache()
    cfg = yi_train_cfg(YI_REMAT_LAYERS, impl="xla")
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = _yi_tokens(torch, dev, cfg, 1, YI_TRAIN_SEQ)
    chunked_desc = recompute_desc(cfg, 1, YI_TRAIN_SEQ)
    chunked = _loss_and_grads(torch, cfg, params, toks)
    with one_block_attend(YI_TRAIN_SEQ):
        block_desc = recompute_desc(cfg, 1, YI_TRAIN_SEQ)
        block = _loss_and_grads(torch, cfg, params, toks)
    d_ce, g_rel, same = _grads_distance(torch, chunked, block)
    lim = YI_CHUNK_LIMITS
    print(f"phase 18c: {cfg.name} {cfg.n_layers}L, 1 x {YI_TRAIN_SEQ} tokens, "
          f"xla: {chunked_desc} against {block_desc}: ce "
          f"{float(chunked[0]):.6f} vs {float(block[0]):.6f} (|d| "
          f"{d_ce:.3e}, limit {lim['ce']:.0e}), grads rel L2 {g_rel:.3e} "
          f"(limit {lim['grads']:.0e}), "
          f"{'bit-identical' if same else 'not bit-identical'}; peak above "
          f"the weights {chunked[3] / 2 ** 30:.2f} GiB chunked, "
          f"{block[3] / 2 ** 30:.2f} GiB in one block")
    if (chunked_desc, block_desc) != ("remat=layer+ce attend=q1024",
                                      "remat=layer+ce attend=dense"):
        fail(f"phase 18c: {chunked_desc} / {block_desc}")
    del chunked, block
    # where the distance comes from: the same pair under *=fp, whose
    # gradients carry the bf16 sums' last bits without int8 codecs
    fp = [_loss_and_grads(torch, cfg, params, toks, policy="*=fp")]
    with one_block_attend(YI_TRAIN_SEQ):
        fp.append(_loss_and_grads(torch, cfg, params, toks, policy="*=fp"))
    fp_ce, fp_rel, fp_same = _grads_distance(torch, *fp)
    print(f"phase 18c: the same pair under *=fp (no limit; where the "
          f"distance comes from): |d ce| {fp_ce:.3e}, grads rel L2 "
          f"{fp_rel:.3e}, {'bit-identical' if fp_same else 'not bit-identical'}")
    if not (d_ce <= lim["ce"] and g_rel <= lim["grads"]):
        fail("phase 18c: _attend in q-chunks out of limits")
    del params, fp
    return train(torch, dev, seed,
                 cfg=yi_train_cfg(YI_TRAIN_LAYERS, impl="xla"),
                 batch=YI_TRAIN_BATCH, seq=YI_TRAIN_SEQ, steps=YI_XLA_STEPS,
                 tag="phase 18c train_yi_xla", profile=False)


def yi_train_card_vs_cpu(torch, dev, seed, strict=True):
    """Phase 18d: phase 8's checks for one train step at Yi-6B's width and
    ``YI_CHECK_LAYERS`` layers (float32 carrier, recomputation on, 1 x 128
    tokens) within ``YI_TRAIN_LIMITS``, C's moments compared where the
    zero points agree and dequantized (``zero_points=False``), and D, the
    bf16-carrier control, above the limits of ``YI_CONTROL``."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = yi_train_cfg(YI_CHECK_LAYERS, dtype="float32")
    return train_card_vs_cpu(torch, dev, seed, cfg=cfg, batch=YI_CHECK_BATCH,
                             seq=YI_CHECK_SEQ, limits=YI_TRAIN_LIMITS,
                             label="phase 18d", control=YI_CONTROL,
                             zero_points=False, strict=strict)


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
    print(card_line())
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
    yi_kernels(torch, dev, gen, results)
    yi_counts, yi_tokens, yi_stats, yi_params = serve_yi(torch, dev,
                                                         args.seed)
    yi_paged_counts = serve_yi_paged(torch, dev, args.seed, yi_params,
                                     yi_tokens, yi_stats)
    del yi_params
    yi_card_vs_cpu(torch, dev, args.seed)
    dequant_counts = serve_dequant(torch, dev, args.seed)
    dequant_card_vs_cpu(torch, dev, args.seed)
    ladder_counts = serve_ladder(torch, dev, args.seed)
    serve_oom(torch, dev, args.seed)
    yi_train_counts = train_yi(torch, dev, args.seed)
    yi_remat(torch, dev, args.seed)
    yi_xla_counts = yi_attend_chunks(torch, dev, args.seed)
    yi_train_card_vs_cpu(torch, dev, args.seed)

    # launches: each kernel's count on the main paths, dense serving (phase
    # 4), paged serving (phase 4b), training on the int8 kernels (phase 7),
    # fake-quant training (phase 10), the guarded path (phase 11), flash
    # training (phase 14), flash-prefill serving (phase 14b), Yi-6B
    # served dense and paged (phases 16b and 16c), the dequantize-on-read
    # engines (phase 17a), the ladder's walk (phase 17c) and Yi-6B trained
    # under flash_pallas (phase 18a) and _attend (phase 18c), each path's
    # counts read right after its run
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
                   "serve_flash": serve_flash_counts[name],
                   "serve_yi": yi_counts[name],
                   "serve_yi_paged": yi_paged_counts[name],
                   "serve_dequant": dequant_counts[name],
                   "serve_ladder": ladder_counts[name],
                   "train_yi": yi_train_counts[name],
                   "train_yi_xla": yi_xla_counts[name]}
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
