#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-19d and 20b limits, on one card.

    python3 tools/dense_readings.py [--seeds 0 1 2 3] [--arch gemma qwen3]

At each of ``--seeds`` and for each ``--arch``: the card against the CPU at
the model's full width and 2 layers, float32 carrier
(``chip_smoke.cell_card_vs_cpu`` on ``chip_smoke.GEMMA`` and
``chip_smoke.QWEN3``), with the bf16-carrier control.  Prints each
policy's max |d logit| of the card, of the plain versions on the card,
and of the control, against the CPU, and a summary line per policy: the
largest sound reading and the smallest control, between which
``GEMMA_B_LIMIT`` and ``QWEN3_B_LIMIT`` are set.  Fails nothing; the
exit code is 0 once every reading was taken.

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
    ap.add_argument("--arch", nargs="*", default=["gemma", "qwen3"],
                    choices=["gemma", "qwen3"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dense_readings: no CUDA device available", file=sys.stderr)
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
    cells = {"gemma": cs.GEMMA, "qwen3": cs.QWEN3}
    for arch in args.arch:
        by_policy = {}
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = cs.cell_card_vs_cpu(torch, dev, seed, cells[arch],
                                    strict=False)
            for label, rd in r.items():
                by_policy.setdefault(label, []).append(rd)
            print(f"{arch} seed {seed}: {r} ({time.perf_counter() - t0:.1f} "
                  f"s)", flush=True)
        for label, rds in by_policy.items():
            print(f"{arch} policy {label} over seeds {args.seeds}: card vs "
                  f"cpu max {max(x['err'] for x in rds):.3e}, plain versions "
                  f"on the card vs cpu max {max(x['plain'] for x in rds):.3e}"
                  f", bf16 control min {min(x['control'] for x in rds):.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
