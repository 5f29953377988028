#!/usr/bin/env python3
"""Readings behind ``chip_smoke.DEQUANT_FUSED_LIMIT`` (phase 17b), on one
card.

    python3 tools/dequant_readings.py [--seeds 0 1 2 3]

At each of ``--seeds``, phase 17b's three numbers
(``chip_smoke.dequant_card_vs_cpu``): the per-tensor int8-KV model on the
dequantize-on-read path, card against CPU; an a8t model on its dequant
path against its fused path on the card at the float32 carrier; and the
same at the bfloat16 carrier (the control).  Max |d logit| of each.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
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
        print("dequant_readings: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    print(cs.card_line(), flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        a8n, d32, d16 = cs.dequant_card_vs_cpu(torch, dev, seed, quiet=True)
        print(f"seed {seed}: a8n card vs cpu {a8n:.4e}; a8t dequant vs "
              f"fused on the card: float32 {d32:.4e}, bfloat16 control "
              f"{d16:.4e} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
