#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build the three CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once) and print the build time;
2. print the card's name and power limit (nvidia-smi);
3. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes, and time kernel, plain version and a library
   yardstick (``torch._int_mm``; SDPA on dequantized K/V) beside the bound
   computed from the inputs' bytes and operations;
4. serve GPT-2 small (random weights from ``--seed``, bf16 carrier, W8A8
   prepared weights, int8 KV cache) through the continuous-batching engine:
   32 requests, prompts of 32-512 tokens, 64 new tokens each, 16 slots of
   1024 rows; every kernel must have launched, as often as the engine's
   prefill and decode counts say;
5. teacher-forced logits of the card against the CPU (plain versions) at
   the float32 carrier on the same weights, and of the card with the
   plain ``int8_matmul`` in the kernel's place (see ``card_vs_cpu`` for
   the policies, the weights and the limits).

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside it, it exits with 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
KERNEL_NAMES = ("int8_matmul", "flash_attention_fwd_q8", "decode_attention")
# phase 5, policy B: limit on max |d logit| of the card against the CPU, set
# from the readings recorded in PERF.md (not sized at run time)
B_LIMIT = 0.1


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


def serve(torch, dev, seed):
    """Phase 4: the engine on GPT-2 small; returns the launch counts."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.infer import Engine, Request
    from repro_torch.models import build_model
    cfg = get_config("gpt2-small")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    eng = Engine(model, params, POLICY, max_slots=16, max_seq=1024,
                 device=dev, seed=seed)
    rng = np.random.RandomState(seed)
    lens = rng.randint(32, 513, size=32)
    new = 64
    ids = [eng.submit(Request(tokens=rng.randint(0, cfg.vocab_size, n)
                              .tolist(), max_new_tokens=new)) for n in lens]
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
    profile_decode(torch, eng, cfg, rng)
    return counts


def profile_decode(torch, eng, cfg, rng) -> None:
    """Where a decode step's time goes: torch.profiler over 4 steps with
    every slot live (16 fresh 64-token requests, admitted outside the
    window); device time by kernel and the device's idle share of the
    steps' wall time.  Runs after the main path's launch counts are read."""
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
    print(f"profile: 4 decode steps x 16 slots, wall {wall_us / 4e3:.2f} ms/step, "
          f"device busy {busy / 4e3:.2f} ms/step, idle share "
          f"{1 - busy / wall_us:.3f}, {sum(k[2] for k in kern) / 4:.0f} "
          f"kernel launches/step")
    for name, us, n in kern[:8]:
        print(f"profile:   {us / 4e3:8.3f} ms/step {n // 4:5d} launches/step "
              f"{name[:90]}")


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
    place, on whatever device its tensors are: phase 5's card-against-card
    comparisons.  Nothing in the port does this."""
    import repro_torch.kernels.ops as ops
    import repro_torch.models.attention as attention
    from repro_torch.kernels.decode_attn import decode_attention_plain
    from repro_torch.kernels.flash_attn import flash_attention_fwd_q8_plain
    from repro_torch.kernels.int8_matmul import int8_matmul_plain
    sites = {"int8_matmul": (ops, int8_matmul_plain),
             "flash_attention_fwd_q8": (attention,
                                        flash_attention_fwd_q8_plain),
             "decode_attention": (attention, decode_attention_plain)}
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
        with plain_versions(KERNEL_NAMES):
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
    check_flash_q8(torch, dev, gen, results)
    counts = serve(torch, dev, args.seed)
    card_vs_cpu(torch, dev, args.seed)

    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    kern = [dict(name=name, launches=counts[name],
                 **{k: results[name][k] for k in keys})
            for name in KERNEL_NAMES]
    (out_dir / "kernels.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
