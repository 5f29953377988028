#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-21d limit, on one card.

    python3 tools/moe_readings.py [--seeds 0 1 2 3]

At each of ``--seeds``: Granite-3.0-MoE's card against the CPU at its
full width and 2 layers, float32 carrier (``chip_smoke.cell_card_vs_cpu``
on ``chip_smoke.GRANITE``), with the bf16-carrier control.  Prints each
policy's max |d logit| of the card, of the plain versions on the card and
of the control, against the CPU on the card's routes, and, each device
routing on its own, the share of (token, k) routing choices that differ
and the card's max |d logit| against the CPU; then a summary line per
policy:
the largest sound reading and the smallest control, between which
``GRANITE_B_LIMIT`` is set.  Fails nothing; the exit code is 0 once every
reading was taken.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("moe_readings: no CUDA device available", file=sys.stderr)
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
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = cs.cell_card_vs_cpu(torch, dev, seed, cs.GRANITE, strict=False)
        for label, rd in r.items():
            by_policy.setdefault(label, []).append(rd)
        print(f"granite seed {seed}: {r} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for label, rds in by_policy.items():
        print(f"granite policy {label} over seeds {args.seeds}: card vs cpu "
              f"max {max(x['err'] for x in rds):.3e}, plain versions on the "
              f"card vs cpu max {max(x['plain'] for x in rds):.3e}, bf16 "
              f"control min {min(x['control'] for x in rds):.3e}; each "
              f"routing on its own: routing choices that differ "
              f"{min(x['route_flips'] for x in rds):.3e}-"
              f"{max(x['route_flips'] for x in rds):.3e}, card vs cpu max "
              f"{max(x['free_err'] for x in rds):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
