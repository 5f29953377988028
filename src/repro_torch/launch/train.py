"""Training launcher of the port (counterpart of ``repro.launch.train``):
``--arch`` on one card, or on the CPU with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
        --smoke --steps 2 --device cpu                  # the paper recipe
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
        --steps 10 --batch 8 --seq 1024 --state-storage int \\
        --policy '*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda'

Prints the reference's ``arch=... policy=[...]`` and ``train-path:`` lines,
then ``step N ce=... ms/step`` for every step (the step time ends in a
device sync: reading ce).  Without ``--smoke`` the batch defaults to 8
sequences of the config's context length.  The reference's checkpoints,
sentinel, fault injection and model parallelism are not ported: their
flags raise.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.qconfig import get_recipe
from repro_torch.core.qpolicy import parse_policy
from repro_torch.data import Loader, SyntheticCorpus
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.train import (init_train_state, make_train_step,
                               train_path_summary)

#: flags of the reference launcher that this port does not have yet
_NOT_PORTED = {
    "ckpt": "checkpoints (ROADMAP section 1, item 5)",
    "sentinel": "the stability sentinel (ROADMAP section 1, item 5)",
    "fault": "fault injection (ROADMAP section 1, item 7)",
    "model_parallel": "model parallelism (ROADMAP section 1, item 8)",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + small batch (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--recipe", default="paper",
                    help="preset name or compact spec ('w8c,a8t,m1:4c')")
    ap.add_argument("--policy", default="",
                    help="per-layer-role policy rules, e.g. "
                         "'*=w8c+a8t+g8t@int8_cuda' (overrides --recipe)")
    ap.add_argument("--state-storage", default="fake",
                    choices=("fake", "int"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--sentinel", action="store_true")
    ap.add_argument("--fault", default="")
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        value = getattr(args, flag)
        if value and not (flag == "model_parallel" and value == 1):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported yet")

    dev = resolve_device(args.device)
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        batch, seq = args.batch or 8, args.seq or 64
    else:
        cfg = get_config(args.arch)
        batch, seq = args.batch or 8, args.seq or cfg.max_seq
    model = build_model(cfg)
    recipe = (parse_policy(args.policy) if args.policy
              else get_recipe(args.recipe))
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps, state_storage=args.state_storage)
    print(f"arch={cfg.name} devices=1 device={dev} "
          f"policy=[{recipe.describe()}] batch={batch} seq={seq}")
    summary = train_path_summary(recipe, cfg.n_layers, opt_cfg=opt,
                                 device=dev)
    print(f"train-path: {summary}")
    state = init_train_state(model, torch.Generator().manual_seed(0), recipe,
                             opt, device=dev)
    step_fn = make_train_step(model, recipe, opt, accum_steps=args.accum)
    loader = Loader(SyntheticCorpus(cfg.vocab_size, seed=7), cfg,
                    batch_size=batch, seq_len=seq)
    for i in range(1, args.steps + 1):
        tokens = torch.from_numpy(next(loader)["tokens"]).to(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        ce = float(metrics["ce"])
        ms = (time.perf_counter() - t0) * 1e3
        print(f"step {i:5d}  ce={ce:.4f}  {ms:.0f}ms/step", flush=True)


if __name__ == "__main__":
    main()
