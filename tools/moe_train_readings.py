#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-22d limits, on one card.

    python3 tools/moe_train_readings.py [--seeds 0 1 2 3]

At each of ``--seeds``: one train step at Granite-3.0-MoE's width and 2
layers (float32 carrier, recomputation on, ``flash_pallas``, 1 x 128
tokens, ``chip_smoke.TRAIN_POLICY`` with int moments), card against CPU on
the card's routes, as ``chip_smoke.granite_train_card_vs_cpu`` runs it
(reported, not failed): A, the card against the CPU; D, the same step on
the card at the bf16 carrier (the control, whose distances named in
``chip_smoke.GRANITE_CONTROL`` must lie above their limits); E, the step
on the card with every kernel of the path in its plain version (which must
lie within them).  Then a summary line: for each distance the largest
sound reading (A and E), the smallest control, and their ratio.  These
set ``chip_smoke.GRANITE_TRAIN_LIMITS``.  The exit code is 0 once every
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
KEYS = ("ce", "grads", "sign_flips", "updates_sign", "updates")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("moe_train_readings: no CUDA device available", file=sys.stderr)
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
    sound, control = {k: [] for k in KEYS}, {k: [] for k in KEYS}
    for seed in args.seeds:
        t0 = time.perf_counter()
        extra = {}
        dist = cs.granite_train_card_vs_cpu(torch, dev, seed, strict=False,
                                            extra=extra)
        for k in KEYS:
            sound[k] += [dist[k], extra["plain"][k]]
            control[k].append(extra["control"][k])
        for what, d in (("A card", dist), ("E plain versions", extra["plain"]),
                        ("D bf16 control", extra["control"])):
            print(f"seed {seed}: phase 22d {what} vs cpu: "
                  + ", ".join(f"{k} {d[k]:.3e}" for k in KEYS), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    for k in KEYS:
        hi, lo = max(sound[k]), min(control[k])
        print(f"phase 22d {k} over seeds {args.seeds}: sound readings (A, E) "
              f"max {hi:.3e}, bf16 control min {lo:.3e}, ratio "
              f"{lo / max(hi, 1e-300):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
