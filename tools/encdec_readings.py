#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-27a and phase-28c limits, on
one card.

    python3 tools/encdec_readings.py [--seeds 0 1 ... 11]

At each of ``--seeds``, at seamless-m4t-medium's width and vocab and 2 + 2
layers (float32 carrier, ``flash_pallas``, ``true_fan_in`` weights), the
two card-vs-CPU checks as ``chip_smoke`` runs them (reported, not
failed):

* 27a (``chip_smoke.seamless_serve_card_vs_cpu``): ``greedy_generate`` on
  the card against the CPU, max |d logit| over the steps whose contexts
  agree; the same with every kernel in its plain version on the card; the
  bf16-carrier control.  A summary line: the largest sound reading (card
  and plain versions), the smallest control, their ratio and geometric
  mean, which sets ``chip_smoke.SEAMLESS_B_LIMIT``.
* 28c (``chip_smoke.seamless_train_card_vs_cpu``): one train step, A the
  card, E the plain versions, D the control, and per distance the summary
  line (``moe_train_readings.take``) that sets
  ``chip_smoke.SEAMLESS_TRAIN_LIMITS``.

The CPU sides run in ``chip_smoke``'s worker process while the card runs
the card sides.  The exit code is 0 once every reading was taken.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

from moe_train_readings import setup, take


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(12)))
    args = ap.parse_args()
    got = setup("encdec_readings")
    if got is None:
        return 2
    torch, cs, dev = got
    cfg = cs.seamless_cfg(cs.SEAMLESS_CHECK_LAYERS, dtype="float32")
    jobs = [("seamless_serve_half", (cfg, s)) for s in args.seeds]
    jobs += [("train_check_half", (cfg, s, cs.SEAMLESS_TRAIN_CHECK_BATCH,
                                   cs.SEAMLESS_TRAIN_CHECK_SEQ))
             for s in args.seeds]
    cs._HALVES = cs.CpuHalves(jobs, torch.get_num_threads())
    sound, control = [], []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = cs.seamless_serve_card_vs_cpu(torch, dev, seed, strict=False)
        sound += [r["err"], r["plain"]]
        control.append(r["control"])
        print(f"seed {seed}: phase 27a card {r['err']:.3e}, plain versions "
              f"{r['plain']:.3e}, bf16 control {r['control']:.3e}, rows "
              f"parted {r['parted']} ({r['decided']} decided), "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    hi, lo = max(sound), min(control)
    print(f"phase 27a max |dlogit| over seeds {args.seeds}: sound readings "
          f"(card, plain) max {hi:.3e}, bf16 control min {lo:.3e}, ratio "
          f"{lo / max(hi, 1e-300):.2f}, geometric mean "
          f"{math.sqrt(hi * lo):.3e}", flush=True)
    take(torch, dev, cs.seamless_train_card_vs_cpu, "28c", args.seeds)
    missing = cs._HALVES.close()
    if missing:
        print(f"encdec_readings: jobs never taken {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
