#!/usr/bin/env python3
"""Readings behind two of ``chip_smoke.py``'s phase-16 settings, on one card.

    python3 tools/yi_readings.py [--seeds 0 1 2 3] [--no-splits]

* Phase 16d at each of ``--seeds``: the card against the CPU at Yi-6B's
  width and 2 layers (``chip_smoke.yi_card_vs_cpu``), both policies'
  readings printed.  A seed out of its limits is reported and the next
  one run; the exit code is 1 if any seed failed.  These readings set
  ``chip_smoke.YI_B_LIMIT``.
* #3's cluster route at a Yi-6B layer's four (K, N) and the decode step's
  16 rows, by cluster size (1, 2, 4, 8 splits of the contraction), the
  int8 entry and the fused decode entry, queued
  (``chip_smoke.queued_ms``), beside ``quantize_int`` alone: what
  ``int8_matmul.gemv_splits``' choice costs at these widths.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def split_times(torch, cs, dev):
    from repro_torch.core.qconfig import Granularity, QuantSpec
    from repro_torch.core.quantizer import quantize_int
    # the module (the package re-exports a function of its name)
    im = importlib.import_module("repro_torch.kernels.int8_matmul")
    spec = QuantSpec(8, Granularity.PER_TOKEN)
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in cs.YI_INT8_KN:
        x, w, rs, csc = cs._int8_case(torch, dev, gen, 16, k, n)
        xf = (torch.randn((16, k), generator=gen, device=dev) * 3).bfloat16()
        line = []
        for s in (1, 2, 4, 8):
            a = cs.queued_ms(lambda: im.int8_matmul_gemv(
                x, w, rs, csc, torch.bfloat16, splits=s))
            b = cs.queued_ms(lambda: im._gemv(xf, w, None, csc,
                                              torch.bfloat16, s, 8))
            line.append(f"{s}: int8 {a:.4f} fused {b:.4f}")
        q = cs.queued_ms(lambda: quantize_int(xf, spec))
        print(f"#3 K={k} N={n} M=16 queued ms by cluster size (gemv_splits "
              f"takes {im.gemv_splits(k)}): " + "; ".join(line)
              + f"; quantize_int alone {q:.4f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--no-splits", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("yi_readings: no CUDA device available", file=sys.stderr)
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
    if not args.no_splits:
        split_times(torch, cs, dev)
    failed = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        try:
            cs.yi_card_vs_cpu(torch, dev, seed)
        except SystemExit as e:            # chip_smoke.fail: report, go on
            failed.append(seed)
            print(f"seed {seed}: {e}", flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"yi_readings: seeds {failed} out of phase 16d's limits")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
