#!/usr/bin/env python3
"""Time the port's streaming kernels and the optimizer call on one card.

    python3 tools/time_streaming.py [--src DIR] [--tag NAME] [--out FILE]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so the same measurements can be taken of another tree, e.g. a ``git
archive`` of a parent commit unpacked under ``build/``; the timing code is
this file's and ``chip_smoke.py``'s either way.  Measures, seed 0:

* ``qdq_row`` and ``qdq_scaled`` (per channel and per tensor) at the
  fake-quant step's gradient shapes, (8192, 768) and (8192, 3072), bf16
  and fp32, 8 bits, with the L2 cold (a round over copies larger than the
  50 MB L2): queued (``chip_smoke.queued_ms``) and call by call;
* ``fused_adamw_blocks`` on phase 6b's GPT-2 small bucket (972,544 x 128
  rows), queued; and ``fused_adamw_leaves`` on GPT-2 small's own leaves
  where the tree has it;
* the optimizer call (``adamw_update``) of a GPT-2 small train step as
  phase 7 runs it (8 x 1024 tokens, the W8/A8/G8 policy, int moments):
  its device time with the card's queue full and its kernels by kind,
  beside the step itself: ms per step over six steps (host clock, each
  ending in a synchronize) and one profiled step's wall, device busy
  time and idle share.

Prints one line a measurement and writes them all as JSON to ``--out``.
Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
QDQ_SHAPES = ((8192, 768), (8192, 3072))


def qdq_times(torch, cs, dev, out):
    from repro_torch.core.quantizer import _div
    from repro_torch.kernels.qdq import (qdq_row, qdq_row_plain, qdq_scaled,
                                         qdq_scaled_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows, f in QDQ_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = cs._qdq_input(torch, dev, gen, rows, f, 8, dtype)
            nbytes = 2 * x.numel() * x.element_size()
            copies = [(x,)] + [(x.clone(),) for _ in
                               range(int(100e6 // nbytes) + 1)]
            xa = x.float().abs()
            s_chan = _div(xa.amax(dim=0, keepdim=True).clamp_min(1e-12),
                          127.0)
            s_tens = _div(xa.amax().clamp_min(1e-12), 127.0).reshape(1, 1)
            dname = str(dtype).replace("torch.", "")
            for name, kern, plain, extra in (
                    ("qdq_row", lambda a: qdq_row(a, 8),
                     lambda a: qdq_row_plain(a, 8), 0),
                    ("qdq_scaled per channel",
                     lambda a: qdq_scaled(a, s_chan, 8),
                     lambda a: qdq_scaled_plain(a, s_chan, 8), 4 * f),
                    ("qdq_scaled per tensor",
                     lambda a: qdq_scaled(a, s_tens, 8),
                     lambda a: qdq_scaled_plain(a, s_tens, 8), 4)):
                same = torch.equal(kern(x), plain(x))
                queued = cs.time_cold_ms(kern, copies, queued=True)
                by_call = cs.time_cold_ms(kern, copies)
                bound, _ = cs.bound_ms(nbytes + extra, 7.0 * x.numel(),
                                       cs.FP32_FLOPS)
                key = f"{name} ({rows}, {f}) {dname}"
                out[key] = dict(queued_ms=queued, call_ms=by_call,
                                bound_ms=bound, bit_exact=same)
                print(f"{key}: queued {queued:.4f} ms, call by call "
                      f"{by_call:.4f} ms, bound {bound:.5f} ms "
                      f"({bound / queued:.0%} of it queued), bit-exact "
                      f"{same}", flush=True)
            del copies


def adamw_times(torch, cs, dev, out):
    from repro_torch.configs import get_config
    from repro_torch.core.qconfig import parse_recipe
    from repro_torch.core.quantizer import quantize_int
    from repro_torch.kernels import opt_update as ok
    rec = parse_recipe("m1:8c-b128,m2:8c-asym-b128-sqrt")
    kw = dict(m1_codec=ok.codec_of(rec.adam_m1),
              m2_codec=ok.codec_of(rec.adam_m2), weight_decay=True)
    sc = torch.tensor([0.7, 6e-4, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
                       1 - 0.95 ** 3], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, n_params = cs.gpt2_bucket_rows(torch, dev, get_config("gpt2-small"))
    bs = 128
    n = rows * bs
    nbytes = n * 16 + rows * 32 + 32
    bound, _ = cs.bound_ms(nbytes, 35.0 * n, cs.FP32_FLOPS)
    g = torch.randn((rows, bs), generator=gen, device=dev) * 1e-2
    p = torch.randn((rows, bs), generator=gen, device=dev) * 0.05
    m1 = torch.randn((rows, bs), generator=gen, device=dev) * 1e-3
    m2 = torch.rand((rows, bs), generator=gen, device=dev) * 1e-5
    bucket = [g, p, *quantize_int(m1, rec.adam_m1),
              *quantize_int(m2.sqrt(), rec.adam_m2)]
    del m1, m2
    ms = cs.queued_ms(lambda: ok.fused_adamw_blocks(*bucket, sc, **kw),
                      iters=10)
    out["fused_adamw_blocks"] = dict(queued_ms=ms, bound_ms=bound,
                                     rows=rows, bs=bs)
    print(f"fused_adamw_blocks {rows} x {bs}: queued {ms:.4f} ms, bound "
          f"{bound:.5f} ms ({bound / ms:.0%} of it)", flush=True)
    del bucket, g, p
    if hasattr(ok, "fused_adamw_leaves"):
        lv = cs.gpt2_leaves(torch, dev, gen, rec)
        rows_l = sum(int(m.q.shape[0]) for m in lv["m1"])
        nb_l = (rows_l * bs * 16 + rows_l * 32 + 32)
        bound_l, _ = cs.bound_ms(nb_l, 35.0 * rows_l * bs, cs.FP32_FLOPS)
        ms = cs.queued_ms(lambda: ok.fused_adamw_leaves(
            lv["g"], lv["p"], lv["m1"], lv["m2"], sc, **kw), iters=10)
        out["fused_adamw_leaves"] = dict(queued_ms=ms, bound_ms=bound_l,
                                         rows=rows_l, bs=bs,
                                         leaves=len(lv["p"]))
        print(f"fused_adamw_leaves {len(lv['p'])} leaves, {rows_l} rows: "
              f"queued {ms:.4f} ms, bound {bound_l:.5f} ms "
              f"({bound_l / ms:.0%} of it)", flush=True)


def optimizer_profile(torch, cs, dev, out):
    """Phase 7's step and its optimizer call: four steps run, the last
    one's ``adamw_update`` arguments kept; six steps timed, one profiled
    (wall, device busy, idle share); then the kept call's device time
    with the card's queue full and its kernels by kind
    (``chip_smoke.optimizer_device_time``)."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import repro_torch.train.step as step_mod
    from repro_torch.configs import get_config
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("gpt2-small"), attention_impl="xla")
    model = build_model(cfg)
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=cs.TRAIN_STEPS,
                    state_storage="int")
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             cs.TRAIN_POLICY, opt, device=dev)
    inner, kept = step_mod.adamw_update, {}

    def keep(*a, **k):
        kept["call"] = (a, k)
        return inner(*a, **k)
    step_mod.adamw_update = keep
    step_fn = make_train_step(model, cs.TRAIN_POLICY, opt)
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ)
    batches = [torch.from_numpy(next(loader)["tokens"]).to(dev)
               for _ in range(11)]
    for b in batches[:4]:
        state, _ = step_fn(state, {"tokens": b})
    step_mod.adamw_update = inner
    a, k = kept.pop("call")
    step_ms = []
    for b in batches[4:10]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, {"tokens": b})
        float(met["ce"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, {"tokens": batches[10]})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    ms, kinds = cs.optimizer_device_time(torch, lambda: inner(*a, **k))
    out["adamw_update"] = dict(device_ms=ms, by_kind=kinds,
                               step_busy_ms=busy, step_ms=step_ms,
                               profiled_wall_ms=wall)
    print(f"phase 7's step, steps 5-10: {sum(step_ms) / len(step_ms):.1f} ms "
          f"mean (min {min(step_ms):.1f}, max {max(step_ms):.1f}); one "
          f"profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}", flush=True)
    print(f"adamw_update of phase 7's step 4: device {ms:.4f} ms with the "
          f"queue full ({ms / busy:.1%} of a step's {busy:.2f} ms device "
          f"busy); kernels by kind: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(kinds.items())),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_streaming: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[{args.tag}] repro_torch from {Path(repro_torch.__file__).parent}"
          f"; {smi}", flush=True)
    from repro_torch.kernels import _build
    _build.build()
    out = {"tag": args.tag, "card": smi}
    qdq_times(torch, cs, dev, out)
    adamw_times(torch, cs, dev, out)
    optimizer_profile(torch, cs, dev, out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
