"""Training launcher of the port (counterpart of ``repro.launch.train``):
``--arch`` on one card, or on the CPU with ``--device cpu``, through the
reference's production loop -- the ``Trainer`` with validation, periodic
and SIGTERM checkpoints, resume from the newest intact checkpoint, the
stability sentinel's recovery ladder and deterministic fault plans.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
        --smoke --steps 2 --device cpu                  # the paper recipe
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
        --steps 10 --batch 8 --seq 1024 --recipe paper_wag8
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
        --steps 60 --batch 8 --seq 1024 --state-storage int \\
        --policy '*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda' \\
        --sentinel --ckpt build/ckpt --fault nan_grad@52
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --layers 16 --steps 10 --batch 2 --seq 4096 --state-storage int \\
        --policy '*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda'
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --steps 10 --batch 2 --seq 4096 \\
        --state-storage int \\
        --policy '*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda'
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 10 --batch 4 --seq 2048 --state-storage int \\
        --policy '*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda'
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --steps 10 --batch 2 --seq 4096 --state-storage int \\
        --policy '*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda'
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-medium --steps 10 --batch 4 --seq 2048 \\
        --state-storage int \\
        --policy '*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_cuda'

Prints the reference's ``arch=... policy=[...]``, ``train-path:`` and
``fault-plan:`` lines, then ``step N ce=... ms/step`` rows (``valid=`` on
validation steps, ``[fallback]`` on steps of the fallback window) and, with
``--sentinel`` or a fault plan, ``resilience: {...}``.  The rows print when
the run ends, as the reference prints them; ``ms/step`` is the mean over
the steps run so far (replays included), each ending in a device sync.
As in the reference, a row is logged on the first step and every 10th,
checkpoints are written every ``max(steps // 3, 50)`` steps and
validation runs every ``max(steps // 5, 20)``.  Without ``--smoke`` the
batch defaults to 8 sequences of the config's context length.
``--layers N`` trains the config's width at N layers (a depth cut: Yi-6B's
32 layers need more than one 80 GB card, ROADMAP section 1, item 8; the
encoder-decoder at N encoder and N decoder layers); the
loss recomputes as the config's ``remat`` says (``models/lm.py``), and
the ``train-path:`` line names it (``remat=`` and ``attend=``).  Model
parallelism is not ported: its flag raises.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.qconfig import get_recipe
from repro_torch.core.qpolicy import fallback_policy, parse_policy
from repro_torch.data import Loader, SyntheticCorpus
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.train import (FaultPlan, LoopConfig, SentinelConfig,
                               StabilitySentinel, Trainer, check_trainable,
                               init_train_state, make_eval_step,
                               make_train_step, train_path_summary)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + small batch (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut: the config's width at this many layers "
                         "(0: the config's depth)")
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
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--sentinel", action="store_true",
                    help="guard every step with the stability sentinel "
                         "(skip-batch / rollback / fallback-window ladder)")
    ap.add_argument("--sentinel-window", type=int, default=32)
    ap.add_argument("--sentinel-sigma", type=float, default=6.0)
    ap.add_argument("--fallback-steps", type=int, default=16,
                    help="length of the fp/fake-quant window after a rollback")
    ap.add_argument("--fallback-mode", choices=("fake", "fp"), default="fake",
                    help="degraded policy during the fallback window: "
                         "'fake' keeps fake-quant (continual-QAT posture), "
                         "'fp' drops quantization entirely")
    ap.add_argument("--fault", default="",
                    help="deterministic fault-injection spec (overrides the "
                         "REPRO_FAULT env var), e.g. 'nan_grad@50'")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel: model parallelism (ROADMAP section 1, item 8) "
            "is not ported yet")

    dev = resolve_device(args.device)
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        batch, seq = args.batch or 8, args.seq or 64
    else:
        cfg = get_config(args.arch)
        batch, seq = args.batch or 8, args.seq or cfg.max_seq
    if args.layers:
        cfg = dataclasses.replace(
            cfg, n_layers=args.layers,
            enc_layers=args.layers if cfg.enc_layers else 0)
    check_trainable(cfg)
    model = build_model(cfg)
    recipe = (parse_policy(args.policy) if args.policy
              else get_recipe(args.recipe))
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps, state_storage=args.state_storage)
    print(f"arch={cfg.name} devices=1 device={dev} "
          f"policy=[{recipe.describe()}] batch={batch} seq={seq}")
    summary = train_path_summary(recipe, cfg.n_layers, opt_cfg=opt,
                                 device=dev, cfg=cfg,
                                 batch=batch // args.accum, seq=seq)
    print(f"train-path: {summary}")
    faults = FaultPlan.from_env(args.fault or None)
    if faults:
        print(f"fault-plan: {faults.describe()}")
    sentinel = fallback_step = None
    if args.sentinel:
        sentinel = StabilitySentinel(SentinelConfig(
            window=args.sentinel_window, spike_sigma=args.sentinel_sigma,
            fallback_steps=args.fallback_steps))
    state = init_train_state(model, torch.Generator().manual_seed(0), recipe,
                             opt, device=dev)
    step = make_train_step(model, recipe, opt, accum_steps=args.accum,
                           faults=faults if faults else None,
                           health=args.sentinel)
    if args.sentinel:
        # the degraded policy keeps the AdamState structure (m1/m2 specs
        # are kept), so the two steps hand the state back and forth
        fb_policy = fallback_policy(
            recipe, mode="fake_quant" if args.fallback_mode == "fake"
            else "fp")
        fallback_step = make_train_step(model, fb_policy, opt,
                                        accum_steps=args.accum, health=True)
    eval_step = make_eval_step(model, recipe)

    corpus = SyntheticCorpus(cfg.vocab_size, seed=7)
    loader = Loader(corpus, cfg, batch_size=batch, seq_len=seq)
    valid = Loader(corpus, cfg, batch_size=batch, seq_len=seq, split="valid")
    mgr = CheckpointManager(args.ckpt, async_write=True) if args.ckpt else None
    trainer = Trainer(step, eval_step, state, loader, ckpt=mgr,
                      valid_loader=valid,
                      loop_cfg=LoopConfig(
                          total_steps=args.steps,
                          ckpt_every=max(args.steps // 3, 50),
                          eval_every=max(args.steps // 5, 20),
                          log_every=10),
                      sentinel=sentinel, fallback_step=fallback_step,
                      faults=faults if faults else None)
    trainer.install_preemption_handler()
    trainer.maybe_resume()
    for rowd in trainer.run():
        extra = f"  valid={rowd['valid_ce']:.4f}" if "valid_ce" in rowd else ""
        if rowd.get("fallback"):
            extra += "  [fallback]"
        print(f"step {rowd['step']:5d}  ce={rowd['ce']:.4f}"
              f"  {rowd['sec_per_step']*1e3:.0f}ms/step{extra}", flush=True)
    if args.sentinel or faults:
        print(f"resilience: {trainer.resilience_summary()}")


if __name__ == "__main__":
    main()
