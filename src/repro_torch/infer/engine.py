"""Policy-driven quantized inference engine with continuous batching (port
of the dense, non-paged, single-card path of ``repro/infer/engine.py``).

``Engine(model, params, policy)`` owns ``max_slots`` decode slots -- rows of
one batched KV cache.  Requests are admitted into free slots as they open
(a finished sequence's slot is reused on the next tick), prompts are
right-padded to doubling buckets for prefill (causal masking hides the pad
tail; the first token is sampled from the logits at the prompt's last
position), and every slot decodes in lock-step through one batched step
with per-slot (B,) positions -- freed slots included, their rows
discarded.

The quantization story is the policy's:

* **prepared weights** -- every block weight the policy quantizes is
  encoded once into an int8 payload + fp32 scales (``infer.prepare``);
  under ``...@int8_cuda`` (alias ``int8_pallas``) with the W8A8 recipe the
  block linears run the int8 matmul kernel;
* **int8 KV cache** -- a ``kv_cache=a8t`` rule stores K/V as int8 payloads
  with per-(position, head) scales; prefill attends through the int8-KV
  flash kernel and decode through the fused decode kernel, which writes
  the step's row in place.

The tensors' device decides kernel or plain version; :meth:`path_summary`
reports which path runs.  Paging, meshes, AOT compilation, the degradation
ladder, shedding and timeouts are not ported yet (see ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.qadam import QState
from repro_torch.core.qpolicy import (INT8_BACKEND, as_policy,
                                      int8_backend_supported)
from repro_torch.infer.prepare import prepare_params
from repro_torch.infer.sampling import SamplingParams, sample
from repro_torch.infer.scheduler import Scheduler
from repro_torch.models.common import cast_params, tree_map
from repro_torch.models.lm import carrier_dtype

#: shortest prefill length; prompts are padded to doubling buckets from it
PREFILL_BUCKET = 16

@dataclasses.dataclass
class Request:
    """One generation request.  ``eos_id`` stops the sequence when sampled
    (the eos token is not included in the response's tokens)."""
    tokens: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    request_id: Optional[int] = None         # assigned by submit()


@dataclasses.dataclass
class Response:
    """``finish_reason``: ``"eos"`` or ``"length"``."""
    request_id: int
    prompt: List[int]
    tokens: List[int]                        # generated, eos excluded
    finish_reason: str


@dataclasses.dataclass
class _Running:
    req: Request
    slot: int
    tokens: List[int] = dataclasses.field(default_factory=list)


def _to_device(x, device):
    if isinstance(x, QState):
        return QState(*(t.to(device) for t in x))
    return x.to(device)


class Engine:
    """See module docstring.  ``submit`` enqueues, ``run`` drains the queue
    and returns the finished :class:`Response` list; ``generate`` is the
    batch-array convenience."""

    def __init__(self, model, params, policy=None, *,
                 max_slots: int = 8, max_seq: int = 256,
                 sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, device="cuda"):
        cfg = model.cfg
        if max_seq > cfg.max_seq:
            raise ValueError(f"max_seq {max_seq} exceeds the learned-position "
                             f"table ({cfg.max_seq})")
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = as_policy(policy)
        self.sampling = sampling
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self._dtype = carrier_dtype(cfg)
        kv_path = self.policy.decode_attn_backend()[0]
        if kv_path not in ("fp", INT8_BACKEND):
            raise NotImplementedError(
                f"KV cache path {kv_path!r} (dequantize-on-read) is not "
                "ported; use a per-token int8 kv_cache spec (a8t) or fp")
        self._kv_int8 = kv_path == INT8_BACKEND
        params = cast_params(tree_map(lambda x: _to_device(x, self.device),
                                      params), self._dtype)
        self.params = prepare_params(cfg, params, self.policy)
        self._state = model.init_decode_state(
            self.max_slots, self.max_seq, self._dtype, policy=self.policy,
            device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._queue: deque = deque()
        self._free: List[int] = list(range(self.max_slots))
        self._running: Dict[int, _Running] = {}
        self._done: List[Response] = []
        self._pos = np.zeros((self.max_slots,), np.int32)
        self._last_tok = np.zeros((self.max_slots,), np.int64)
        self._next_id = 0
        #: host-clock seconds and counts of the prefill and decode launches
        #: (each ends in a device -> host copy of the sampled tokens, so the
        #: clock covers the device work)
        self.stats = {"prefill_s": 0.0, "prefill_calls": 0,
                      "prefill_tokens": 0, "decode_s": 0.0,
                      "decode_steps": 0, "decode_tokens": 0}
        self.scheduler = Scheduler(self)

    # -- public API --------------------------------------------------------

    def submit(self, req: Request) -> int:
        toks = [int(t) for t in req.tokens]
        if not toks:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(toks) > self.max_seq - 1:
            raise ValueError(f"prompt length {len(toks)} needs at least one "
                             f"decode row in max_seq={self.max_seq}")
        req = dataclasses.replace(req, tokens=toks, request_id=self._next_id)
        self._next_id += 1
        self.scheduler.enqueue(req)
        return req.request_id

    def run(self) -> List[Response]:
        """Drain the queue; responses in request_id order."""
        return self.scheduler.run()

    def generate(self, prompts, max_new_tokens: int,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Uniform-batch convenience: (B, max_new_tokens) int32, eos-padded
        after the stop."""
        prompts = np.asarray(prompts)
        ids = [self.submit(Request(tokens=row.tolist(),
                                   max_new_tokens=max_new_tokens,
                                   eos_id=eos_id))
               for row in prompts]
        by_id = {r.request_id: r for r in self.run()}
        pad = eos_id if eos_id is not None else 0
        out = np.full((len(ids), max_new_tokens), pad, np.int32)
        for i, rid in enumerate(ids):
            t = by_id[rid].tokens
            if eos_id is None and len(t) < max_new_tokens:
                raise ValueError(
                    f"request {rid} truncated at {len(t)}/{max_new_tokens} "
                    f"tokens (cache rows exhausted: max_seq={self.max_seq}); "
                    "grow max_seq or pass eos_id")
            out[i, :len(t)] = t
        return out

    def path_summary(self) -> str:
        """Which path serving runs: ``weights=prepared-int8(<route>)`` with
        route ``cuda`` (the int8 matmul kernel), ``plain`` (its plain version,
        CPU tensors) or ``dequant`` (dequant-read matmul), or
        ``weights=raw``; ``kv=int8-fused`` (int8-KV kernels) or ``kv=fp``."""
        prepared = any(isinstance(v, QState)
                       for sub in self.params["blocks"].values()
                       for v in sub.values())
        if prepared:
            res = self.policy.resolve("attn_qkv", 0, self.cfg.n_layers)
            if res.backend == INT8_BACKEND and int8_backend_supported(res.recipe):
                route = "cuda" if self.device.type == "cuda" else "plain"
            else:
                route = "dequant"
            weights = f"prepared-int8({route})"
        else:
            weights = "raw"
        kv = "int8-fused" if self._kv_int8 else "fp"
        return f"weights={weights} kv={kv}"

    # -- scheduler internals -----------------------------------------------

    def _drain_done(self) -> List[Response]:
        done, self._done = self._done, []
        return done

    def _bucket_len(self, n: int) -> int:
        b = PREFILL_BUCKET
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _admit(self) -> None:
        """Admit queued requests (FIFO) into free slots, one bucketed
        prefill launch per prompt-length bucket."""
        if not self._queue or not self._free:
            return
        selected = []
        while self._queue and len(selected) < len(self._free):
            selected.append(self._queue.popleft())
        groups: Dict[int, List[Request]] = {}
        for r in selected:
            groups.setdefault(self._bucket_len(len(r.tokens)), []).append(r)
        for lb, group in groups.items():
            self._admit_group(lb, group)

    def _admit_group(self, lb: int, group: List[Request]) -> None:
        n = len(group)
        slots = [self._free.pop(0) for _ in range(n)]
        toks = np.zeros((n, lb), np.int64)
        last = np.zeros((n,), np.int64)
        for i, r in enumerate(group):
            toks[i, :len(r.tokens)] = r.tokens
            last[i] = len(r.tokens) - 1
        t0 = time.perf_counter()
        logits, new_state = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device),
            policy=self.policy, max_seq=self.max_seq,
            last_pos=torch.from_numpy(last).to(self.device))
        # each prefill row's whole max_seq strip lands in its slot
        idx = torch.tensor(slots, device=self.device)
        for name, buf in self._state["caches"].items():
            buf.index_copy_(1, idx, new_state["caches"][name])
        first = sample(logits, self.sampling, self._generator).cpu().numpy()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += int(sum(len(r.tokens) for r in group))
        for i, r in enumerate(group):
            st = _Running(req=r, slot=slots[i])
            self._running[slots[i]] = st
            self._pos[slots[i]] = len(r.tokens)
            self._last_tok[slots[i]] = int(first[i])
            # the first sampled token goes through the same eos / length
            # bookkeeping as every later one
            self._record(st, int(first[i]))

    def _step(self) -> None:
        t0 = time.perf_counter()
        tok = torch.from_numpy(self._last_tok[:, None].copy()).to(self.device)
        pos = torch.from_numpy(self._pos.copy()).to(self.device)
        logits, self._state = self.model.decode(self.params, self._state, tok,
                                                pos, policy=self.policy)
        nxt = sample(logits, self.sampling, self._generator).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(self._running)
        for slot in list(self._running):
            st = self._running[slot]
            self._pos[slot] += 1
            self._last_tok[slot] = int(nxt[slot])
            self._record(st, int(nxt[slot]))
            if slot in self._running and self._pos[slot] >= self.max_seq:
                self._finish(st, "length")       # cache rows exhausted

    def _record(self, st: _Running, tok: int) -> None:
        if st.req.eos_id is not None and tok == st.req.eos_id:
            self._finish(st, "eos")
            return
        st.tokens.append(tok)
        if len(st.tokens) >= st.req.max_new_tokens:
            self._finish(st, "length")

    def _finish(self, st: _Running, reason: str) -> None:
        del self._running[st.slot]
        self._free.append(st.slot)
        self._done.append(Response(request_id=st.req.request_id,
                                   prompt=list(st.req.tokens),
                                   tokens=list(st.tokens),
                                   finish_reason=reason))
