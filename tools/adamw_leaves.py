#!/usr/bin/env python3
"""#6's leaves entry on one model's quantizable leaves, on one card.

    python3 tools/adamw_leaves.py [--arch mamba2-130m]

The leaves of ``--arch`` at its published widths as the optimizer reads
them (``chip_smoke.gpt2_leaves``: params from ``init_params``, random fp32
gradients, both moments quantized per leaf with the train recipe's
blockwise codecs; leaves without blockwise moments -- Mamba2's A_log,
dt_bias and D -- are not the kernel's), through ``fused_adamw_leaves``:
bit for bit against its plain version, a repeat bit-identical, timed with
the card's queue full (``chip_smoke.queued_ms``) beside the bound phase 6b
gives GPT-2 small's leaves (bytes: each block's g and p read, p written,
both int8 moments read and written, 16 bytes an element, and 32 bytes of
scales and zero points a block), the plain version, and one
``adamw_update`` on the same model's params (its device time with the
queue full, ``chip_smoke.optimizer_device_time``).  Fails if a bit
differs.

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("adamw_leaves: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.qconfig import parse_recipe
    from repro_torch.core.qpolicy import as_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels.opt_update import (codec_of, fused_adamw_leaves,
                                                fused_adamw_leaves_plain)
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import adamw_update, init_adam_state
    dev = torch.device("cuda")
    _build.build(["opt_update"])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = parse_recipe("m1:8c-b128,m2:8c-asym-b128-sqrt")
    bs = 128
    lv = cs.gpt2_leaves(torch, dev, gen, rec, arch=args.arch)
    sc = torch.tensor([0.7, 6e-4, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
                       1 - 0.95 ** 3], dtype=torch.float32, device=dev)
    kw = dict(m1_codec=codec_of(rec.adam_m1), m2_codec=codec_of(rec.adam_m2),
              weight_decay=True)
    a = (lv["g"], lv["p"], lv["m1"], lv["m2"], sc)
    got = fused_adamw_leaves(*a, **kw)
    want = fused_adamw_leaves_plain(*a, **kw)
    again = fused_adamw_leaves(*a, **kw)
    torch.cuda.synchronize()
    exact = cs._same(torch, cs._leaves_out(got), cs._leaves_out(want))[0]
    repeat = cs._same(torch, cs._leaves_out(again), cs._leaves_out(got))[0]
    rows = sum(int(m.q.shape[0]) for m in lv["m1"])
    n = rows * bs
    ms = cs.queued_ms(lambda: fused_adamw_leaves(*a, **kw), iters=10)
    plain = cs.time_ms(lambda: fused_adamw_leaves_plain(*a, **kw), iters=3)
    b, by = cs.bound_ms(n * 16 + rows * 32 + 32, 35.0 * n, cs.FP32_FLOPS)
    print(f"fused_adamw_leaves {args.arch}: {len(lv['p'])} leaves, {rows} "
          f"rows of {bs} ({sum(t.numel() for t in lv['p'])} params): "
          f"bit-exact {exact}, repeat bit-identical {repeat}; queued ms "
          f"{ms:.4f}, plain_ms {plain:.4f}, bound_ms {b:.5f} ({by}), "
          f"library_ms none", flush=True)
    del lv, a, got, want, again
    policy = as_policy(cs.TRAIN_POLICY)
    opt = OptConfig(lr=6e-4, warmup_steps=5, total_steps=10,
                    state_storage="int")
    params = build_model(get_config(args.arch)).init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=dev) * 1e-2, params)
    state = init_adam_state(params, policy, opt)
    t, kinds = cs.optimizer_device_time(
        torch, lambda: adamw_update(params, grads, state, opt, policy))
    print(f"adamw_update on {args.arch}: device {t:.4f} ms a call with the "
          f"queue full; kernels by kind "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(kinds.items())),
          flush=True)
    return 0 if exact and repeat else 1


if __name__ == "__main__":
    sys.exit(main())
