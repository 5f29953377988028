"""Deterministic fault injection for the guarded training path and the
serving engine (port of ``repro.train.faults``; the same grammar, so one
spec parses the same in both packages).

A :class:`FaultPlan` is parsed from a compact spec (the ``REPRO_FAULT``
environment variable, or passed explicitly) and injects one of the
failure modes the stability sentinel, the checkpoint manager and the
serving engine's degradation ladder must survive:

=====================  =====================================================
``nan_grad@K``         every gradient leaf becomes NaN on train step K
                       (a device-side multiplier keyed on
                       ``state.opt.step``: a multiply by 1.0, bit for bit a
                       no-op, on every other step)
``sat_grad@K``         gradients scaled by ``factor`` (default 1e6) on step K
``corrupt_ckpt@N``     the N-th (1-based) completed checkpoint write is
                       corrupted in place: ``mode=flip`` (default) flips a
                       payload byte (caught by the per-leaf CRC32),
                       ``mode=truncate`` truncates ``arrays.npz``,
                       ``mode=manifest`` garbles the manifest
``sigterm_save@N``     SIGTERM in the middle of the N-th checkpoint write
                       (payload on disk, commit marker not yet)
``sigterm_run@K``      SIGTERM right after train step K (preemption-resume)
``dead_sched@N``       the serving scheduler's step thread raises on its
                       N-th tick (``Scheduler.fault_hook``)
``nan_logit@N``        the serving engine's decode step N reports slot
                       ``slot`` (default 0) as non-finite: the engine
                       quarantines that request (finish reason
                       ``"numerics"``), not the batch
``oom_pages@N``        every free page is taken from the engine's pool just
                       before decode step N and held ``hold`` steps
                       (default 2): mid-decode preemption under a dry pool
``slow_step@N``        decode step N is delayed ``ms`` milliseconds
                       (default 50) on the host
``kernel_error@N``     the decode step raises just before dispatch on step
                       N, as a failing kernel would: the engine steps down
                       its fused -> dequant -> fp ladder and retries
=====================  =====================================================

Entries are ``;``-separated; key=val args follow the step after ``:`` and
are ``,``-separated, e.g. ``sat_grad@6:factor=1e7;corrupt_ckpt@1:mode=
truncate``.  Steps are the 0-based train-loop step for ``*_grad`` /
``sigterm_run`` (the value of ``state.opt.step`` entering the step),
1-based completed-save ordinals for the checkpoint faults, 0-based
scheduler ticks for ``dead_sched``, and 0-based engine decode steps for
the serving kinds (``Engine._decode_steps``; admissions and prefills do
not advance it).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_map

ENV_VAR = "REPRO_FAULT"

GRAD_KINDS = ("nan_grad", "sat_grad")
CKPT_KINDS = ("corrupt_ckpt", "sigterm_save")
ENGINE_KINDS = ("nan_logit", "oom_pages", "slow_step", "kernel_error")
KINDS = GRAD_KINDS + CKPT_KINDS + ("sigterm_run", "dead_sched") \
    + ENGINE_KINDS

_CORRUPT_MODES = ("flip", "truncate", "manifest")


class FaultInjected(RuntimeError):
    """Raised by host-side faults that simulate a hard crash.  The
    scheduler's dead step thread is not absorbed by any guard (the
    dead-loop watchdog must see it); ``kernel_error`` is raised inside the
    engine's guarded decode step, where the ladder absorbs it and retries
    one rung down."""


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    at: int                       # step / save ordinal / scheduler tick
    args: Dict[str, str] = dataclasses.field(default_factory=dict)

    def arg(self, key: str, default: str) -> str:
        return self.args.get(key, default)

    def describe(self) -> str:
        s = f"{self.kind}@{self.at}"
        if self.args:
            s += ":" + ",".join(f"{k}={v}"
                                for k, v in sorted(self.args.items()))
        return s


class FaultPlan:
    """A parsed, immutable set of faults plus the mutable injection state
    (how many saves have happened, which one-shot faults fired)."""

    def __init__(self, faults: Tuple[Fault, ...] = ()):
        self.faults = tuple(faults)
        self._saves_completed = 0
        self._fired: List[str] = []          # descriptions, in firing order

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultPlan":
        faults = []
        for entry in (spec or "").replace("\n", ";").split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if "@" not in entry:
                raise ValueError(
                    f"bad fault entry {entry!r} (want kind@step[:k=v,...])")
            kind, rest = entry.split("@", 1)
            kind = kind.strip()
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; kinds: {KINDS}")
            args: Dict[str, str] = {}
            if ":" in rest:
                at_s, arg_s = rest.split(":", 1)
                for kv in arg_s.split(","):
                    kv = kv.strip()
                    if not kv:
                        continue
                    if "=" not in kv:
                        raise ValueError(f"bad fault arg {kv!r} in {entry!r} "
                                         "(want key=val)")
                    k, v = kv.split("=", 1)
                    args[k.strip()] = v.strip()
            else:
                at_s = rest
            try:
                at = int(at_s.strip())
            except ValueError:
                raise ValueError(f"bad fault step {at_s!r} in {entry!r}") \
                    from None
            mode = args.get("mode")
            if kind == "corrupt_ckpt" and mode is not None \
                    and mode not in _CORRUPT_MODES:
                raise ValueError(f"unknown corrupt_ckpt mode {mode!r}; "
                                 f"modes: {_CORRUPT_MODES}")
            faults.append(Fault(kind, at, args))
        return cls(tuple(faults))

    @classmethod
    def from_env(cls, spec: Optional[str] = None) -> "FaultPlan":
        """Plan from an explicit spec when given (CLI flag), else from the
        ``REPRO_FAULT`` environment variable."""
        if spec is None:
            spec = os.environ.get(ENV_VAR)
        return cls.parse(spec)

    # -- introspection -----------------------------------------------------

    def __bool__(self) -> bool:
        return bool(self.faults)

    def describe(self) -> str:
        return ";".join(f.describe() for f in self.faults) or "none"

    @property
    def fired(self) -> List[str]:
        """Faults that injected, in order (grad faults as the loop noted
        them, see :meth:`note_step`)."""
        return list(self._fired)

    def _of(self, *kinds: str) -> List[Fault]:
        return [f for f in self.faults if f.kind in kinds]

    def _mark(self, fault: Fault) -> None:
        self._fired.append(fault.describe())

    # -- gradient faults ---------------------------------------------------

    def has_grad_faults(self) -> bool:
        return bool(self._of(*GRAD_KINDS))

    def apply_grads(self, step: torch.Tensor, grads):
        """Poison the gradient tree when the device step counter ``step``
        matches a planned grad fault: one scalar multiplier, chosen on the
        device with ``torch.where`` (no host sync), broadcast into every
        leaf in float32 -- 1.0 on every other step.  Firing is recorded on
        the host by :meth:`note_step`."""
        faults = self._of(*GRAD_KINDS)
        if not faults:
            return grads
        mult = torch.ones((), dtype=torch.float32, device=step.device)
        for f in faults:
            hit = (float("nan") if f.kind == "nan_grad"
                   else float(f.arg("factor", "1e6")))
            mult = torch.where(step == f.at, torch.full_like(mult, hit), mult)
        return tree_map(lambda g: (g.to(torch.float32) * mult).to(g.dtype),
                        grads)

    def grad_fault_steps(self) -> List[int]:
        return sorted(f.at for f in self._of(*GRAD_KINDS))

    def note_step(self, step: int) -> None:
        """Host-side bookkeeping after loop step ``step`` ran: record grad
        faults planned for that step, and deliver ``sigterm_run``."""
        for f in self._of(*GRAD_KINDS):
            if f.at == step:
                self._mark(f)
        for f in self._of("sigterm_run"):
            if f.at == step and f.describe() not in self._fired:
                self._mark(f)
                os.kill(os.getpid(), signal.SIGTERM)

    # -- checkpoint faults -------------------------------------------------

    def install(self, manager) -> None:
        """Bind the checkpoint faults to a ``CheckpointManager`` through its
        ``on_mid_write`` / ``on_after_write`` hooks."""
        if not self._of(*CKPT_KINDS):
            return
        manager.on_mid_write = self._mid_write
        manager.on_after_write = self._after_write

    def _mid_write(self, step: int) -> None:
        # after the array payload is on disk, before the manifest and the
        # commit marker: the window a preemption can land in
        ordinal = self._saves_completed + 1
        for f in self._of("sigterm_save"):
            if f.at == ordinal and f.describe() not in self._fired:
                self._mark(f)
                os.kill(os.getpid(), signal.SIGTERM)

    def _after_write(self, step: int, path: str) -> None:
        self._saves_completed += 1
        for f in self._of("corrupt_ckpt"):
            if f.at == self._saves_completed:
                self._mark(f)
                corrupt_checkpoint(path, f.arg("mode", "flip"))

    # -- scheduler faults --------------------------------------------------

    def scheduler_hook(self) -> Optional[Callable[[int], None]]:
        """Hook for ``infer.scheduler.Scheduler.fault_hook``: raises
        :class:`FaultInjected` on the planned tick (a crashed background
        step thread)."""
        faults = self._of("dead_sched")
        if not faults:
            return None

        def hook(tick: int) -> None:
            for f in faults:
                if f.at == tick and f.describe() not in self._fired:
                    self._mark(f)
                    raise FaultInjected(
                        f"injected scheduler-thread death at tick {tick}")
        return hook

    # -- serving (engine) faults -------------------------------------------

    def engine_hooks(self) -> Optional["EngineFaultHooks"]:
        """Hooks for ``Engine.fault_hooks``: deliver the serving fault kinds
        at the engine's decode-step hook points.  None when the plan carries
        no serving faults (the healthy path stays hook-free)."""
        faults = self._of(*ENGINE_KINDS)
        if not faults:
            return None
        return EngineFaultHooks(self, faults)


class EngineFaultHooks:
    """Serving faults keyed on the engine's 0-based decode-step counter,
    each one-shot (marked in the plan's ``fired`` list the step it lands).
    Hook points, in the order ``Engine._step`` calls them:

    * :meth:`pre_step` -- before the dispatch: ``slow_step`` sleeps ``ms``
      on the host; ``oom_pages`` takes every free page from the pool (held
      ``hold`` steps), so the next page a slot needs forces a preemption;
    * :meth:`kernel` -- inside the guarded dispatch: ``kernel_error``
      raises :class:`FaultInjected` where a failing kernel would;
    * :meth:`mangle_finite` -- on the step's per-slot finite flags on the
      host: ``nan_logit`` marks slot ``slot`` (default 0) non-finite, in a
      copy;
    * :meth:`post_step` -- after the bookkeeping: releases held pages whose
      hold ran out.
    """

    def __init__(self, plan: FaultPlan, faults: List[Fault]):
        self._plan = plan
        self._faults = list(faults)
        self._held: List[Tuple[int, List[int]]] = []   # (release_step, pids)

    def _due(self, kind: str, step: int) -> List[Fault]:
        return [f for f in self._faults
                if f.kind == kind and f.at == step
                and f.describe() not in self._plan._fired]

    def pre_step(self, engine, step: int) -> None:
        for f in self._due("slow_step", step):
            self._plan._mark(f)
            time.sleep(float(f.arg("ms", "50")) / 1e3)
        for f in self._due("oom_pages", step):
            self._plan._mark(f)
            if engine.pool is not None and engine.pool.free_pages > 0:
                pids = engine.pool.alloc(engine.pool.free_pages)
                self._held.append((step + int(f.arg("hold", "2")), pids))

    def kernel(self, step: int) -> None:
        for f in self._due("kernel_error", step):
            self._plan._mark(f)
            raise FaultInjected(
                f"injected fused-kernel failure at decode step {step}")

    def mangle_finite(self, step: int, finite: np.ndarray) -> np.ndarray:
        for f in self._due("nan_logit", step):
            self._plan._mark(f)
            finite = np.array(finite, copy=True)
            finite[int(f.arg("slot", "0")) % len(finite)] = False
        return finite

    def post_step(self, engine, step: int) -> None:
        keep = []
        for rel, pids in self._held:
            if step >= rel and engine.pool is not None:
                engine.pool.release(pids)
            else:
                keep.append((rel, pids))
        self._held = keep


def corrupt_checkpoint(path: str, mode: str = "flip") -> str:
    """Corrupt one on-disk checkpoint directory in place (test utility and
    the ``corrupt_ckpt`` fault body).  Returns the damaged file's path."""
    arrays = os.path.join(path, "arrays.npz")
    manifest = os.path.join(path, "manifest.json")
    if mode == "flip":
        with open(arrays, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            # a byte well inside the payload (past the zip local-file
            # headers), so np.load still parses the container
            f.seek(max(size // 2, 0))
            b = f.read(1)
            f.seek(max(size // 2, 0))
            f.write(bytes([b[0] ^ 0xFF]))
        return arrays
    if mode == "truncate":
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return arrays
    if mode == "manifest":
        with open(manifest, "w") as f:
            f.write('{"step": -1, "leaves": {}')      # invalid json
        return manifest
    raise ValueError(f"unknown corrupt mode {mode!r}; modes: {_CORRUPT_MODES}")
