#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s phase-26e limits, on one card.

    python3 tools/hybrid_train_readings.py [--seeds 0 1 2 3 4 5 6 7]

At each of ``--seeds``: one train step at Zamba2-2.7B's width and 12
layers (two groups of six Mamba2 layers, each followed by the shared
attention + MLP block; float32 carrier, recomputation on,
``flash_pallas``, ``chip_smoke.ZAMBA_CHECK_BATCH`` x ``ZAMBA_CHECK_SEQ``
tokens, ``chip_smoke.TRAIN_POLICY`` with int moments), card against CPU
as ``chip_smoke.zamba_train_card_vs_cpu`` runs it (reported, not failed):
A, the card against the CPU; D, the bf16-carrier control; E, every kernel
of the path in its plain version on the card.  Then a summary line for
each distance: the largest sound reading (A and E), the smallest control,
their ratio and their geometric mean, which sets
``chip_smoke.ZAMBA_TRAIN_LIMITS``.  The exit code is 0 once every reading
was taken.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import sys

from moe_train_readings import setup, take


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(8)))
    args = ap.parse_args()
    got = setup("hybrid_train_readings")
    if got is None:
        return 2
    torch, cs, dev = got
    take(torch, dev, cs.zamba_train_card_vs_cpu, "26e", args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
