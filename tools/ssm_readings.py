#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-23c and phase-24d limits, on
one card.

    python3 tools/ssm_readings.py [--seeds 0 1 2 3]

At each of ``--seeds``, at Mamba2-130M's full width and 2 layers, float32
carrier:

* 23c, serving (``chip_smoke.cell_card_vs_cpu`` on ``chip_smoke.MAMBA``):
  each policy's max |d logit| of the card, of the plain versions on the
  card and of the bf16-carrier control against the CPU (a 64-token
  prefill and 8 teacher-forced decode steps);
* 24d, one train step (``chip_smoke.mamba_train_card_vs_cpu``): A, the
  card against the CPU; E, every kernel of the path in its plain version
  on the card; D, the bf16-carrier control.

Then summary lines: for serving, each policy's largest sound reading and
smallest control, between which ``MAMBA_B_LIMIT`` is set; for training,
each distance's largest sound reading (A and E), smallest control and
their ratio, which set ``MAMBA_TRAIN_LIMITS``.  Fails nothing; the exit
code is 0 once every reading was taken.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("ce", "grads", "sign_flips", "updates_sign", "updates")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssm_readings: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    by_policy = {}
    sound, control = {k: [] for k in KEYS}, {k: [] for k in KEYS}
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = cs.cell_card_vs_cpu(torch, dev, seed, cs.MAMBA, strict=False)
        for label, rd in r.items():
            by_policy.setdefault(label, []).append(rd)
        print(f"mamba2 seed {seed}: phase 23c {r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        extra = {}
        dist = cs.mamba_train_card_vs_cpu(torch, dev, seed, strict=False,
                                          extra=extra)
        for k in KEYS:
            sound[k] += [dist[k], extra["plain"][k]]
            control[k].append(extra["control"][k])
        for what, d in (("A card", dist), ("E plain versions", extra["plain"]),
                        ("D bf16 control", extra["control"])):
            print(f"mamba2 seed {seed}: phase 24d {what} vs cpu: "
                  + ", ".join(f"{k} {d[k]:.3e}" for k in KEYS), flush=True)
        print(f"mamba2 seed {seed}: phase 24d {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
    for label, rds in by_policy.items():
        print(f"mamba2 phase 23c policy {label} over seeds {args.seeds}: card "
              f"vs cpu max {max(x['err'] for x in rds):.3e}, plain versions "
              f"on the card vs cpu max {max(x['plain'] for x in rds):.3e}, "
              f"bf16 control min {min(x['control'] for x in rds):.3e}",
              flush=True)
    for k in KEYS:
        hi, lo = max(sound[k]), min(control[k])
        print(f"mamba2 phase 24d {k} over seeds {args.seeds}: sound readings "
              f"(A, E) max {hi:.3e}, bf16 control min {lo:.3e}, ratio "
              f"{lo / max(hi, 1e-300):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
