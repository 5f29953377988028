#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-22d limits, on one card.

    python3 tools/moe_train_readings.py [--seeds 0 1 2 3]

At each of ``--seeds``: one train step at Granite-3.0-MoE's width and 2
layers (float32 carrier, recomputation on, ``flash_pallas``,
``chip_smoke.GRANITE_CHECK_BATCH`` x ``GRANITE_CHECK_SEQ`` tokens,
``chip_smoke.TRAIN_POLICY`` with int moments), card against CPU on the
card's routes, as ``chip_smoke.granite_train_card_vs_cpu`` runs it
(reported, not failed): A, the card against the CPU; D, the same step on
the card at the bf16 carrier (the control, whose distances named in
``chip_smoke.GRANITE_CONTROL`` must lie above their limits); E, the step
on the card with every kernel of the path in its plain version (which
must lie within them).  Then a summary line: for each distance the largest
sound reading (A and E), the smallest control, their ratio and their
geometric mean.  These set ``chip_smoke.GRANITE_TRAIN_LIMITS``.  The exit
code is 0 once every reading was taken.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("ce", "grads", "sign_flips", "updates_sign", "updates")


def setup(tool: str):
    """(torch, chip_smoke, device) with the kernels built and the card's
    name and power limit printed; None without a card."""
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device available", file=sys.stderr)
        return None
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return torch, cs, torch.device("cuda")


def take(torch, dev, check, phase: str, seeds) -> None:
    """``check(torch, dev, seed, strict=False, extra=...)`` (a
    ``chip_smoke`` train card-vs-CPU phase) at each seed: its A, E and D
    distances, then per distance the largest sound reading (A, E), the
    smallest control, their ratio and geometric mean."""
    sound, control = {k: [] for k in KEYS}, {k: [] for k in KEYS}
    for seed in seeds:
        t0 = time.perf_counter()
        extra = {}
        dist = check(torch, dev, seed, strict=False, extra=extra)
        for k in KEYS:
            sound[k] += [dist[k], extra["plain"][k]]
            control[k].append(extra["control"][k])
        for what, d in (("A card", dist), ("E plain versions", extra["plain"]),
                        ("D bf16 control", extra["control"])):
            print(f"seed {seed}: phase {phase} {what} vs cpu: "
                  + ", ".join(f"{k} {d[k]:.3e}" for k in KEYS), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    for k in KEYS:
        hi, lo = max(sound[k]), min(control[k])
        print(f"phase {phase} {k} over seeds {list(seeds)}: sound readings "
              f"(A, E) max {hi:.3e}, bf16 control min {lo:.3e}, ratio "
              f"{lo / max(hi, 1e-300):.2f}, geometric mean "
              f"{math.sqrt(hi * lo):.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()
    got = setup("moe_train_readings")
    if got is None:
        return 2
    torch, cs, dev = got
    print(f"phase 22d at {cs.GRANITE_CHECK_BATCH} x {cs.GRANITE_CHECK_SEQ} "
          f"tokens", flush=True)
    take(torch, dev, cs.granite_train_card_vs_cpu, "22d", args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
