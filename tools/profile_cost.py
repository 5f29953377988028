#!/usr/bin/env python3
"""What ``chip_smoke.profile_train_step``'s profiler pass costs, on one card.

    python3 tools/profile_cost.py

Builds Zamba2-2.7B at full width and depth as phase 26b trains it (2 x
4096 tokens a step, ``flash_pallas``, ``chip_smoke.TRAIN_POLICY`` with int
moments), runs two steps, then profiles one step with the host's and the
card's activity recorded and one with the card's alone, and prints for
each the step's wall time, the seconds the profiler takes to stop and to
build ``key_averages()``, and the kernels' busy time and launches; for the
card-only pass also the seconds to read the kernel records raw (what
``profile_train_step`` does) and whether that read names the same kernels.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_cost: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import Loader, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    cfg = cs.zamba_train_cfg(54)
    model = build_model(cfg)
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=6,
                    state_storage="int")
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             cs.TRAIN_POLICY, opt, device=dev)
    step = make_train_step(model, cs.TRAIN_POLICY, opt)
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=cs.ZAMBA_TRAIN_BATCH,
                    seq_len=cs.ZAMBA_TRAIN_SEQ)
    batch = {"tokens": torch.from_numpy(next(loader)["tokens"]).to(dev)}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    for acts in ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 [ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        t1 = time.perf_counter()
        kern = {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total}
        t2 = time.perf_counter()
        names = "+".join(a.name for a in acts)
        print(f"{names}: step wall {wall:.2f} s, profiler stop "
              f"{t1 - t0 - wall:.1f} s, key_averages {t2 - t1:.1f} s, "
              f"{len(kern)} kernels, busy "
              f"{sum(v[0] for v in kern.values()) / 1e3:.1f} ms, launches "
              f"{sum(v[1] for v in kern.values())}", flush=True)
        if ProfilerActivity.CPU in acts:
            continue
        t3 = time.perf_counter()
        raw = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                us, n = raw.get(e.name(), (0.0, 0))
                raw[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
        t4 = time.perf_counter()
        print(f"{names}, read raw: {t4 - t3:.1f} s, {len(raw)} kernels, busy "
              f"{sum(v[0] for v in raw.values()) / 1e3:.1f} ms, launches "
              f"{sum(v[1] for v in raw.values())}, the same kernels "
              f"{set(raw) == set(kern)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
