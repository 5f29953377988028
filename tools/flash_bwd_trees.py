#!/usr/bin/env python3
"""Time the bf16 flash backward (#9 dK/dV, #10 dQ) of two checkouts of the
repository on one card, in turns, so that a change to the kernels is
compared with its parent inside one call.

    python3 tools/flash_bwd_trees.py --src build/parent/src --src src

Each ``--src`` is a tree's ``src`` directory; its kernels build into that
tree's ``build/repro_torch`` (``_build``).  Each round runs one worker
process a tree -- A, B, B, A -- that times #9 and #10 with the card's
queue full (``chip_smoke.queued_ms`` of the tree given) at phase 13's
shapes: BH 96, S 1024, hd 64 and BH 16, S 512, hd 128, causal, and, where
the tree takes them on the tensor cores, Zamba2-2.7B's (BH 64, S 4096, hd
160).  Prints the card's name and power limit.  Imports no JAX.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((96, 1024, 64), (16, 512, 128), (64, 4096, 160))


def worker(src: Path) -> int:
    """Time the tree under ``src`` and print one JSON line of ms."""
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(src.parent))
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_trees: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as fa
    _build.build(["flash_fwd_sm90", "flash_bwd_sm90", "flash_attn"]
                 + [n for n in _build.SOURCES if n == "flash_bwd_sm90_wide"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": cs.card_line()}
    for bh, s, d in SHAPES:
        if fa.bwd_library(torch.bfloat16, d) == "flash_attn":
            continue  # the CUDA-core body: not this comparison's
        q, k, v, do = (torch.randn((bh, s, d), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd_lse(q, k, v)
        args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
        out[f"hd{d}"] = [cs.queued_ms(lambda: fa.flash_attention_bwd_dkdv(
            *args)), cs.queued_ms(lambda: fa.flash_attention_bwd_dq(*args))]
        del q, k, v, do, o, lse, args
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (twice)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    srcs = [Path(s).resolve() for s in args.src]
    if args.worker:
        return worker(srcs[0])
    if len(srcs) != 2:
        ap.error("give --src twice")
    rows = []
    for i in (0, 1, 1, 0):
        r = subprocess.run([sys.executable, __file__, "--worker", "--src",
                            str(srcs[i])], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout + r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        rows.append((i, json.loads(r.stdout.strip().splitlines()[-1])))
    print(rows[0][1]["card"])
    for i, row in rows:
        print(f"{'AB'[i]} {srcs[i]}: " + "; ".join(
            f"{k} #9 {v[0]:.4f} ms, #10 {v[1]:.4f} ms"
            for k, v in row.items() if k != "card"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
