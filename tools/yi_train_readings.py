#!/usr/bin/env python3
"""Readings behind two of ``chip_smoke.py``'s phase-18 limits, on one card.

    python3 tools/yi_train_readings.py [--seeds 0 1 2 3]

* Phase 18c at each of ``--seeds``: ``_attend`` in q-chunks of 1024 rows
  against one block (``chip_smoke.one_block_attend``), Yi-6B's width at 4
  layers, 1 x 4096 tokens: |d ce| and the gradients' relative L2
  distance.  These set ``chip_smoke.YI_CHUNK_LIMITS``.
* Phase 18d at each of ``--seeds``: one train step at Yi-6B's width and 2
  layers, card against CPU (``chip_smoke.train_card_vs_cpu`` as
  ``yi_train_card_vs_cpu`` runs it, reported and not failed), with phase
  12's control: the same step at the bf16 carrier, whose distances named
  in ``chip_smoke.YI_CONTROL`` must lie above their limits.  These set
  ``chip_smoke.YI_TRAIN_LIMITS``.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def chunk_reading(torch, cs, dev, seed):
    """Phase 18c's comparison at ``seed``: (|d ce|, grads rel L2, bit for
    bit)."""
    from repro_torch.models import build_model
    cfg = cs.yi_train_cfg(cs.YI_REMAT_LAYERS, impl="xla")
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = cs._yi_tokens(torch, dev, cfg, 1, cs.YI_TRAIN_SEQ)
    chunked = cs._loss_and_grads(torch, cfg, params, toks)
    with cs.one_block_attend(cs.YI_TRAIN_SEQ):
        block = cs._loss_and_grads(torch, cfg, params, toks)
    return cs._grads_distance(torch, chunked, block)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("yi_train_readings: no CUDA device available", file=sys.stderr)
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
    for seed in args.seeds:
        t0 = time.perf_counter()
        d_ce, g_rel, same = chunk_reading(torch, cs, dev, seed)
        print(f"seed {seed}: phase 18c reading: |d ce| {d_ce:.3e}, grads "
              f"rel L2 {g_rel:.3e}, bit-identical {same} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    failed = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        try:
            cfg = cs.yi_train_cfg(cs.YI_CHECK_LAYERS, dtype="float32")
            dist = cs.train_card_vs_cpu(
                torch, dev, seed, cfg=cfg, batch=cs.YI_CHECK_BATCH,
                seq=cs.YI_CHECK_SEQ, limits=cs.YI_TRAIN_LIMITS,
                label=f"seed {seed} phase 18d", control=cs.YI_CONTROL,
                zero_points=False, strict=False)
            print(f"seed {seed}: phase 18d reading: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in dist.items()),
                  flush=True)
        except SystemExit as e:            # chip_smoke.fail: report, go on
            failed.append(seed)
            print(f"seed {seed}: {e}", flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
