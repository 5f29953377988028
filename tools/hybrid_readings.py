#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-25c limit, on one card.

    python3 tools/hybrid_readings.py [--seeds 0 1 2 3]

At each of ``--seeds``, at Zamba2-2.7B's full width and 12 layers (two
groups of six Mamba2 layers, each followed by the shared attention + MLP
block), float32 carrier (``chip_smoke.cell_card_vs_cpu`` on
``chip_smoke.ZAMBA``, reported, not failed): each policy's max |d logit|
of the card, of the plain versions on the card and of the bf16-carrier
control against the CPU (a 64-token prefill and 8 teacher-forced decode
steps), and whether the card with the plain ``int8_matmul`` in the
kernel's place is bit-identical.  Then a summary line for each policy:
its largest sound reading (the card, the plain versions) and its smallest
control, between which ``ZAMBA_B_LIMIT`` is set.  Fails nothing; the exit
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hybrid_readings: no CUDA device available", file=sys.stderr)
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
        r = cs.cell_card_vs_cpu(torch, dev, seed, cs.ZAMBA, strict=False)
        for label, rd in r.items():
            by_policy.setdefault(label, []).append(rd)
        print(f"zamba2 seed {seed}: phase 25c {r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for label, rds in by_policy.items():
        sound = max(max(x["err"], x["plain"]) for x in rds)
        ctl = min(x["control"] for x in rds)
        same = all(x.get("mm_plain_same", True) for x in rds)
        print(f"zamba2 phase 25c policy {label} over seeds {args.seeds}: card "
              f"vs cpu max {max(x['err'] for x in rds):.3e}, plain versions "
              f"on the card vs cpu max {max(x['plain'] for x in rds):.3e}, "
              f"bf16 control min {ctl:.3e}, ratio "
              f"{ctl / max(sound, 1e-300):.2f}; card with the plain "
              f"int8_matmul bit-identical at every seed: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
