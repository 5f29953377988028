"""Policy-driven quantized inference engine with continuous batching (port
of the single-card path of ``repro/infer/engine.py``).

``Engine(model, params, policy)`` owns ``max_slots`` decode slots.
Requests are admitted into free slots as they open (a finished sequence's
slot is reused on the next tick), prompts are right-padded to doubling
buckets for prefill (causal masking hides the pad tail; the first token is
sampled from the logits at the prompt's last position), and every slot
decodes in lock-step through one batched step with per-slot (B,) positions
-- freed slots included, their rows discarded.  The host loop around it
(submit queue, deadlines, shedding, the background thread) is
:class:`~repro_torch.infer.scheduler.Scheduler`'s.

The quantization story is the policy's:

* **prepared weights** -- every block weight the policy quantizes is
  encoded once into an int8 payload + fp32 scales (``infer.prepare``);
  under ``...@int8_cuda`` (alias ``int8_pallas``) with the W8A8 recipe the
  block linears run the int8 matmul kernel;
* **int8 KV cache** -- a ``kv_cache`` rule stores K/V as int8 payloads
  with fp32 scales.  Where the kernels take the spec (``a8t``: per
  position x head) prefill attends through the int8-KV flash kernel and
  decode through the fused decode kernel, which writes the step's row in
  place; any other int8 spec (``a8n`` per tensor, ``a4t`` 4-bit) is read
  by dequantize-on-read (``models/attention.py``).

**Dense mode** (the default) keeps one ``max_seq``-row cache strip per
slot.  **Paged mode** (``paged=True``) keeps K/V in a pool of fixed-size
pages (``infer/pages.py``) indexed through per-slot page tables, so decode
memory scales with live tokens:

* decode runs the paged twin of the fused kernel (``decode_attention_paged``)
  on int8 pools, or scatters and gathers the pools (the dequantize-on-read
  and fp paths);
* one prefill launch takes every admitted prompt; where the KV codec is
  row-local (fp, or one scale per position x head) and the prefill is not
  the int8-KV flash kernel (causal-only), short prompts pack into shared
  rows (segment masks keep them apart), otherwise each prompt has its own
  row; each prompt's rows are then *paged in* from the prefill buffer to
  fresh pages;
* admission is by free-page count, head-of-line fair with a starvation
  bound (``_admit``); a slot that needs a page when the pool is dry
  preempts the youngest running request, whose prompt + generated tokens
  re-enter the queue;
* a shared prompt prefix can be cached once (:meth:`cache_prefix`) and
  aliased into any number of page tables (refcounted, no copy);
* a freed slot gets position 0 and a table row of trash-page entries, so
  its discarded row never lands in a page another slot now owns.

Every decode step also reduces a per-slot "logits finite" flag on the
device; a request whose row is not finite is quarantined (finish reason
``"numerics"``) and the rest of the batch goes on.

**The degradation ladder** (the reference's): rung 0 is the configured
path; the rungs are ``["fused", "dequant", "fp"]`` for a spec the kernels
take, ``["dequant", "fp"]`` for any other int8 spec and ``["fp"]`` for an
fp cache.  A decode step that raises :class:`FaultInjected` (the
``kernel_error`` fault, or a failure injected inside the step) is
absorbed: the engine steps one rung down and retries the step
(``_absorb_step_failure``); on the bottom rung it propagates.  Any other
exception from the step propagates at once, so a kernel that fails to
launch is never served around by the plain path.  ``numeric_limit`` quarantines within
``numeric_window`` steps also demote; ``reprobe_after`` healthy steps
promote one rung (``infer/resilience.py``).  Stepping onto the fp rung
dequantizes the live caches, leaving it requantizes them (per position x
head); fused <-> dequant changes only the path that reads the same
buffers.  Prefill always runs rung 0's path; on the fp rung its int8
caches are dequantized before they are copied in.  ``fault_hooks``
(``FaultPlan.engine_hooks()``) injects the serving faults at the step's
hook points.  On a card the constructor loads (building if needed) every
kernel library rung 0 launches, so a build or load failure raises there
and is never absorbed as a step failure.

The dense and MoE families serve alike (the reference's
``ENGINE_FAMILIES`` and ``PAGED_FAMILIES``): the experts' capacity is
taken by every routed row, a decode step's empty slots and a prefill's
pad rows included, so which rows share a launch is part of a token's
route, as in the reference.

The SSM family (mamba2) serves in dense mode only, as in the reference
(paged mode raises: pages hold KV rows, and an SSM carries a state): the
engine state holds ``"ssm"`` -- per-layer SSM states (L, slots, H, N, P)
fp32 and conv tails (L, slots, W - 1, C) -- beside ``"caches": None``;
admission copies each admitted prompt's states into its slot, and a
decode step's new states replace the live ones only once the step has
returned.  With no KV cache the ladder has the one rung ``"none"`` (the
reference's), so a failing step re-raises.  Prefill runs the whole padded
bucket, so a prompt's pad tokens enter its state, as in the reference
(ROADMAP section 3).

The hybrid family (zamba2) serves in dense mode only too, as in the
reference: its state holds both parts, the SSM and conv states (L, slots,
...) and one KV cache strip a shared-block invocation (G, slots, max_seq,
K, hd).  Admission writes both slot by slot; a decode step commits its new
SSM states only when it returns, and writes its KV row in place as the
attention families do.  Its ladder is theirs (``fused / dequant / fp``):
demotion and promotion convert the KV part and leave the SSM part as it
is, and a retried step starts from the SSM states the failed attempt
started from.

The tensors' device decides kernel or plain version; :meth:`path_summary`
reports which path runs.  Meshes and AOT compilation are not ported (see
ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.qadam import QState
from repro_torch.core.qconfig import Granularity
from repro_torch.core.qpolicy import (INT8_BACKEND, as_policy,
                                      int8_backend_supported)
from repro_torch.core.quantizer import _div, storage_dtype
from repro_torch.infer.pages import (CapacityError, PagePool,
                                     init_paged_caches, page_nbytes,
                                     pages_for)
from repro_torch.infer.prepare import prepare_params
from repro_torch.infer.resilience import EngineMonitor, MonitorConfig
from repro_torch.infer.sampling import SamplingParams, sample
from repro_torch.infer.scheduler import Scheduler
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import (decode_kv_read_bytes,
                                             effective_block_k)
from repro_torch.kernels.flash_attn import q8_library
from repro_torch.kernels.int8_matmul import scale_guard
from repro_torch.models.attention import dequant_kv
from repro_torch.models.common import cast_params, tree_map
from repro_torch.models.lm import carrier_dtype
from repro_torch.train.faults import FaultInjected

#: shortest prefill length; prompts are padded to doubling buckets from it
PREFILL_BUCKET = 16

#: the families paged mode serves: their decode state is KV rows alone
#: the families the engine serves (the reference's): the encoder-decoder
#: serves through ``train.serve.greedy_generate``
ENGINE_FAMILIES = ("dense", "moe", "ssm", "hybrid")
PAGED_FAMILIES = ("dense", "moe")

#: a queued request skipped this many admission passes (each time because
#: its page need exceeded the free pool while smaller requests went ahead)
#: becomes a barrier: nothing younger is admitted past it until it fits
STARVATION_LIMIT = 8


@dataclasses.dataclass
class Request:
    """One generation request.  ``eos_id`` stops the sequence when sampled
    (the eos token is not included in the response's tokens).
    ``timeout_s`` bounds the wall clock from submit: past it the scheduler
    cancels the request, queued or decoding (finish reason ``"timeout"``,
    tokens so far kept, slot and pages freed)."""
    tokens: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    timeout_s: Optional[float] = None
    request_id: Optional[int] = None         # assigned by submit()


@dataclasses.dataclass
class Response:
    """``finish_reason``: ``"eos"`` / ``"length"`` (served), ``"timeout"``
    (deadline sweep), ``"shed"`` (rejected under overload;
    ``retry_after_s`` is a back-off hint) or ``"numerics"`` (the request's
    logits row went non-finite; tokens before it are kept)."""
    request_id: int
    prompt: List[int]
    tokens: List[int]                        # generated, eos excluded
    finish_reason: str
    text: Optional[str] = None               # from the engine's detokenizer
    retry_after_s: Optional[float] = None    # set on "shed" responses


@dataclasses.dataclass
class _Running:
    req: Request
    slot: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    order: int = 0                           # admission sequence number


def _to_device(x, device):
    if isinstance(x, QState):
        return QState(*(t.to(device) for t in x))
    return x.to(device)


class Engine:
    """See module docstring.  ``submit`` enqueues, ``run`` drains the queue
    and returns the finished :class:`Response` list; ``generate`` is the
    batch-array convenience; ``scheduler.start()`` serves in the
    background."""

    def __init__(self, model, params, policy=None, *,
                 max_slots: int = 8, max_seq: int = 256,
                 sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, device="cuda",
                 paged: bool = False, page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 max_queue: Optional[int] = None, detokenizer=None,
                 monitor: Optional[MonitorConfig] = None):
        cfg = model.cfg
        if cfg.family not in ENGINE_FAMILIES:
            raise ValueError(
                f"Engine serves decoder-only families {ENGINE_FAMILIES}; "
                f"{cfg.family!r} uses train.serve.greedy_generate")
        if max_seq > cfg.max_seq:
            what = ("the learned-position table" if cfg.pos == "learned"
                    else "the config's context")
            raise ValueError(f"max_seq {max_seq} exceeds {what} "
                             f"({cfg.max_seq})")
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = as_policy(policy)
        self.sampling = sampling
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.detokenizer = detokenizer
        self._dtype = carrier_dtype(cfg)
        if paged and cfg.family not in PAGED_FAMILIES:
            raise ValueError(
                f"paged KV serving needs a pure attention cache "
                f"({PAGED_FAMILIES}); {cfg.family!r} carries SSM state")
        kv_backend = self.policy.decode_attn_backend()[0]
        kv_spec = self.policy.kv_spec()
        # the ladder's rungs, fastest first (see the module docstring)
        if kv_backend == "fp":
            self._rungs = ["fp"]
        elif kv_backend == INT8_BACKEND:
            self._rungs = ["fused", "dequant", "fp"]
        else:
            self._rungs = ["dequant", "fp"]
        self._rung = 0
        # the carrier cast happens once here (the embedding and an untied
        # head included): the model's per-call cast then finds every leaf
        # in the carrier and copies nothing
        params = cast_params(tree_map(lambda x: _to_device(x, self.device),
                                      params), self._dtype)
        self.params = prepare_params(cfg, params, self.policy)
        del params
        self.paged = bool(paged)
        if self.paged:
            # the reference's tile rule: halved until it divides max_seq
            self.page_size = effective_block_k(self.max_seq, page_size)
            maxp = self.max_seq // self.page_size
            self.n_pages = (int(n_pages) if n_pages is not None
                            else 1 + self.max_slots * maxp)
            self.pool = PagePool(n_pages=self.n_pages,
                                 page_size=self.page_size,
                                 max_slots=self.max_slots,
                                 max_pages_per_slot=maxp)
            self._state = {"caches": init_paged_caches(
                cfg, self.n_pages, self.page_size, self._dtype,
                kv_spec=kv_spec, device=self.device)}
            # packed rows need a row-local KV codec (fp, or one scale per
            # position x head: a per-write-block scale would couple packed
            # neighbours) and a masked prefill (the int8-KV flash kernel is
            # causal-only, so the fused path prefills one prompt per row)
            packable = (kv_spec is None
                        or kv_spec.granularity is Granularity.PER_TOKEN)
            self._pack_ok = packable and self._rungs[0] != "fused"
        else:
            self.page_size = self.n_pages = self.pool = None
            self._pack_ok = False
            self._state = model.init_decode_state(
                self.max_slots, self.max_seq, dtype=self._dtype,
                policy=self.policy, device=self.device)
            if self._state["caches"] is None:
                # no KV cache (the SSM family): no rung to step down to
                self._rungs = ["none"]
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.monitor = EngineMonitor(monitor)
        #: set to ``FaultPlan.engine_hooks()`` to inject serving faults at
        #: the decode step's hook points
        self.fault_hooks = None
        self.preemptions = 0
        self._decode_steps = 0
        self._queue: deque = deque()
        self._free: List[int] = list(range(self.max_slots))
        self._running: Dict[int, _Running] = {}
        self._done: List[Response] = []
        self._pos = np.zeros((self.max_slots,), np.int32)
        self._last_tok = np.zeros((self.max_slots,), np.int64)
        self._next_id = 0
        self._order = 0
        self._skips: Dict[int, int] = {}          # request_id -> passes skipped
        #: preempted request_id -> (original prompt, tokens generated so far)
        self._carry: Dict[int, Tuple[List[int], List[int]]] = {}
        self._prefixes: Dict[tuple, List[int]] = {}   # cached prefix -> pids
        #: host-clock seconds and counts of the prefill and decode launches
        #: (each ends in a device -> host copy of the sampled tokens, so the
        #: clock covers the device work; a paged admission's page-in copy
        #: is enqueued after that point and lands in the next step); a
        #: decode step counts on the rung it completed on
        self.stats = {"prefill_s": 0.0, "prefill_calls": 0,
                      "prefill_tokens": 0, "decode_s": 0.0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "rung_steps": dict.fromkeys(self._rungs, 0),
                      "rung_s": dict.fromkeys(self._rungs, 0.0)}
        self.scheduler = Scheduler(self, max_queue=max_queue)
        if self.device.type == "cuda":
            # a library that does not build or load fails here, never as a
            # decode step the ladder would absorb
            for name in self._rung0_libraries():
                _build.load(name)

    def _weights_route(self) -> Optional[str]:
        """How the prepared block linears run: ``cuda`` (the int8 matmul
        kernel), ``plain`` (its plain version, CPU tensors) or ``dequant``
        (dequant-read matmul; also where the hybrid's SSM layers and its
        shared block resolve to different routes); None for raw
        weights."""
        def prepared(part):
            return any(isinstance(v, QState)
                       for sub in self.params.get(part, {}).values()
                       for v in (sub.values() if isinstance(sub, dict)
                                 else (sub,)))
        # (role, layer) of the first linear of each part with prepared
        # weights: the stacked blocks, the hybrid's depth-less shared block
        sites = []
        if prepared("blocks"):
            sites.append(("ssm_in" if self.cfg.family in ("ssm", "hybrid")
                          else "attn_qkv", 0))
        if prepared("shared"):
            sites.append(("attn_qkv", None))
        if not sites:
            return None
        n = self.cfg.n_layers
        for role, layer in sites:
            res = self.policy.resolve(role, layer, n)
            if not (res.backend == INT8_BACKEND
                    and int8_backend_supported(res.recipe)):
                return "dequant"
        return "cuda" if self.device.type == "cuda" else "plain"

    def _rung0_libraries(self) -> List[str]:
        """The kernel libraries the configured path (rung 0) launches."""
        names = []
        if self._weights_route() == "cuda":
            names.append("int8_matmul")
        if self._rungs[0] == "fused":
            names += ["decode_attn", q8_library(self._dtype)]
        elif self.cfg.attention_impl == "flash_pallas":
            names.append("flash_fwd_sm90" if self._dtype == torch.bfloat16
                         else "flash_attn")
        return names

    # -- public API --------------------------------------------------------

    def submit(self, req: Request) -> int:
        toks = [int(t) for t in req.tokens]
        if not toks:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.paged:
            page = self.page_size
            maxp = self.pool.max_pages_per_slot
            alloc = self.pool.n_pages - 1          # page 0 is the trash page
            acct = dict(max_seq=self.max_seq, page_size=page,
                        pages_total=alloc, pages_free=self.pool.free_pages,
                        slots_total=self.max_slots,
                        slots_free=len(self._free))
            if len(toks) > self.max_seq - 1:
                raise CapacityError(
                    f"prompt length {len(toks)} needs at least one decode "
                    f"row in max_seq={self.max_seq} ({maxp} pages x {page} "
                    f"rows/page per slot)",
                    tokens=len(toks),
                    pages_needed=pages_for(len(toks) + 1, page), **acct)
            live = min(len(toks) + req.max_new_tokens, self.max_seq)
            peak = pages_for(live, page)
            if peak > alloc:
                raise CapacityError(
                    f"request peaks at {peak} pages ({live} live tokens / "
                    f"{page} rows per page) but the pool holds only {alloc} "
                    f"allocatable pages -- even alone it would exhaust the "
                    f"pool mid-decode",
                    tokens=len(toks), pages_needed=peak, **acct)
        elif len(toks) > self.max_seq - 1:
            raise CapacityError(
                f"prompt length {len(toks)} needs at least one decode row in "
                f"max_seq={self.max_seq}",
                tokens=len(toks), max_seq=self.max_seq,
                slots_total=self.max_slots, slots_free=len(self._free))
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
                lim = (f"max_seq={self.max_seq} = "
                       f"{self.pool.max_pages_per_slot} pages x "
                       f"{self.page_size} rows/page per slot"
                       if self.paged else f"max_seq={self.max_seq}")
                raise ValueError(
                    f"request {rid} truncated at {len(t)}/{max_new_tokens} "
                    f"tokens (cache rows exhausted: {lim}); grow max_seq"
                    + (" or n_pages" if self.paged else "")
                    + " or pass eos_id")
            out[i, :len(t)] = t
        return out

    def cancel(self, request_id: int, reason: str = "timeout",
               retry_after_s: Optional[float] = None) -> bool:
        """Cancel a queued or running request (on the thread that runs the
        scheduler's steps).  Running: finished the normal way (slot and
        pages freed, tokens so far kept).  Queued: removed before admission
        (a preempted continuation still reports its original prompt).
        False when the request is unknown or already finished."""
        for req in self._queue:
            if req.request_id == request_id:
                self._queue.remove(req)
                self._skips.pop(request_id, None)
                orig, prior = self._carry.pop(
                    request_id, (list(req.tokens), []))
                self._done.append(Response(
                    request_id=request_id, prompt=orig, tokens=prior,
                    finish_reason=reason, retry_after_s=retry_after_s))
                return True
        for st in self._running.values():
            if st.req.request_id == request_id:
                self._finish(st, reason)
                return True
        return False

    def cache_prefix(self, tokens: Sequence[int]) -> int:
        """Prefill ``tokens`` once and pin its whole pages as a shared
        prefix: a later request whose prompt starts with it aliases the
        pinned pages into its own table and pages in only its tail (a
        trailing partial page is recomputed per request).  Returns the
        number of pages cached; paged mode only."""
        if not self.paged:
            raise ValueError("cache_prefix requires paged=True")
        toks = [int(t) for t in tokens]
        page = self.page_size
        n_pg = len(toks) // page
        if n_pg == 0:
            raise ValueError(f"prefix shorter than one page ({page} tokens); "
                             "nothing to share")
        plen = n_pg * page
        if plen > self.max_seq - 1:
            raise ValueError(f"prefix of {plen} tokens leaves no decode row "
                             f"in max_seq={self.max_seq}")
        key = tuple(toks[:plen])
        if key in self._prefixes:
            return n_pg
        if n_pg > self.pool.free_pages:
            raise CapacityError(
                f"caching a {n_pg}-page prefix needs {n_pg} free pages",
                tokens=plen, page_size=page, pages_needed=n_pg,
                pages_total=self.pool.n_pages - 1,
                pages_free=self.pool.free_pages,
                slots_total=self.max_slots, slots_free=len(self._free))
        toksa = np.zeros((1, self._row_len(plen)), np.int64)
        toksa[0, :plen] = key
        # one segment, the causal mask: the rows a request prefilling this
        # prompt itself would write
        _, state = self._prefill_call(toksa, np.asarray([[0, plen - 1]]))
        pids = self.pool.alloc(n_pg)
        self.pool.pin(pids)
        self._page_in(state["caches"], 0, 0, pids)
        self._prefixes[key] = pids
        return n_pg

    def kv_cache_nbytes(self) -> int:
        """Resident bytes of the decode state (the KV strips or pools, and
        the SSM states)."""
        return sum(t.numel() * t.element_size()
                   for part in self._state.values() if part is not None
                   for t in part.values())

    def live_kv_bytes(self) -> int:
        """KV bytes referenced by live sequences: paged, the live pages
        times a page's bytes over all layers; dense, the whole cache (every
        slot's strip is committed whether or not the slot is live)."""
        if not self.paged:
            return self.kv_cache_nbytes()
        return self.pool.live_pages * page_nbytes(self._state["caches"])

    def _kv_mode(self) -> str:
        """Which path reads the KV cache in the rung that runs: ``fused``
        (the int8-KV kernels), ``dequant`` (int8 storage, dequantize on
        read), ``fp``, or ``none`` (no KV cache: the SSM family)."""
        if self._state["caches"] is None:
            return "none"
        if "k_scale" not in self._state["caches"]:
            return "fp"
        return "fused" if self._rungs[self._rung] == "fused" else "dequant"

    def kv_decode_read_bytes(self) -> int:
        """Bytes of KV a decode step reads across the stack in the rung that
        runs (``kernels.decode_attn.decode_kv_read_bytes``); paged mode
        counts the live pages only; 0 without a KV cache."""
        if self._state["caches"] is None:
            return 0
        k = self._state["caches"]["k"]
        n_layers, kh, hd = k.shape[0], k.shape[-2], k.shape[-1]
        fp_bytes = torch.empty((), dtype=self._dtype).element_size()
        if self.paged:
            batch, rows = 1, self.pool.live_pages * self.page_size
        else:
            batch, rows = k.shape[1], k.shape[2]
        return decode_kv_read_bytes(self._kv_mode(), batch, rows, kh, hd,
                                    n_layers=n_layers, fp_bytes=fp_bytes)

    def path_summary(self) -> str:
        """Which path serving runs: ``weights=prepared-int8(<route>)`` with
        route ``cuda`` (the int8 matmul kernel), ``plain`` (its plain version,
        CPU tensors) or ``dequant`` (dequant-read matmul), or
        ``weights=raw``; ``kv=int8-fused``, ``int8-dequant``, ``fp`` or
        ``none`` (paged: ``int8-paged-fused(p<page>)``,
        ``int8-paged-gather(p<page>)`` or ``fp-paged(p<page>)``) for the
        rung that runs, and ``degraded=<rung>(rung i/n)`` below rung 0."""
        route = self._weights_route()
        weights = f"prepared-int8({route})" if route else "raw"
        mode = self._kv_mode()
        if self.paged:
            kv = {"fused": "int8-paged-fused", "dequant": "int8-paged-gather",
                  "fp": "fp-paged"}[mode] + f"(p{self.page_size})"
        else:
            kv = {"fused": "int8-fused", "dequant": "int8-dequant",
                  "fp": "fp", "none": "none"}[mode]
        s = f"weights={weights} kv={kv}"
        if self._rung > 0:
            s += (f" degraded={self._rungs[self._rung]}"
                  f"(rung {self._rung}/{len(self._rungs) - 1})")
        return s

    def resilience_summary(self) -> Dict[str, object]:
        """The monitor's summary (quarantines, kernel errors, slow steps,
        the healthy streak, every demotion and promotion with its step and
        reason, step latency) with the ladder's rung, rung index and rungs,
        the preemptions and the decode steps."""
        s = self.monitor.summary()
        s.update({"rung": self._rungs[self._rung],
                  "rung_index": self._rung,
                  "rungs": list(self._rungs),
                  "preemptions": self.preemptions,
                  "decode_steps": self._decode_steps})
        return s

    # -- scheduler internals -----------------------------------------------

    def _drain_done(self) -> List[Response]:
        done, self._done = self._done, []
        return done

    def _bucket_len(self, n: int) -> int:
        b = PREFILL_BUCKET
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _row_len(self, n: int) -> int:
        """Paged prefill row width: the dense bucket rounded up to whole
        pages (page-in copies whole pages out of the row)."""
        return min(pages_for(self._bucket_len(n), self.page_size)
                   * self.page_size, self.max_seq)

    def _shared_prefix(self, toks: List[int]):
        """Longest cached prefix of ``toks`` -> (length, pids) or None."""
        best = None
        for pref, pids in self._prefixes.items():
            if len(pref) <= len(toks) and list(pref) == toks[:len(pref)]:
                if best is None or len(pref) > best[0]:
                    best = (len(pref), pids)
        return best

    def _prefill_call(self, toks: np.ndarray, last: np.ndarray, segs=None):
        """One prefill launch into max_seq-row buffers (so attention's
        reduction length is the dense engine's) on rung 0's path, whatever
        the rung -> (logits, state: caches in the structure of the engine's,
        SSM states)."""
        dev = self.device
        logits, state = self.model.prefill(
            self.params, torch.from_numpy(toks).to(dev), policy=self.policy,
            max_seq=self.max_seq, last_pos=torch.from_numpy(last).to(dev),
            segments=None if segs is None else torch.from_numpy(segs).to(dev),
            kv_path=self._kv_path(self._rungs[0]))
        return logits, dict(state,
                            caches=self._match_prefill_state(state["caches"]))

    def _admit(self) -> None:
        """Admit queued requests into free slots.  The queue is scanned in
        FIFO order and every request whose resources fit is admitted, so a
        large paged request that does not fit the free pages does not block
        smaller ones behind it (a request only overtakes a larger one).  A
        request skipped ``STARVATION_LIMIT`` passes becomes a barrier:
        nothing younger passes it until it is admitted."""
        if not self._queue or not self._free:
            return
        free_pages = self.pool.free_pages if self.paged else 0
        free_slots = len(self._free)
        selected: List[Request] = []
        shares: Dict[int, tuple] = {}
        kept: List[Request] = []
        blocked = False
        for req in self._queue:
            if blocked or free_slots == 0:
                kept.append(req)
                continue
            if self.paged:
                share = self._shared_prefix(req.tokens)
                npg = pages_for(len(req.tokens), self.page_size)
                # +1: headroom, so the first decode write does not preempt
                need = max(npg - (len(share[1]) if share else 0) + 1, 1)
                if need > free_pages:
                    n = self._skips[req.request_id] = \
                        self._skips.get(req.request_id, 0) + 1
                    if n >= STARVATION_LIMIT:
                        blocked = True
                    kept.append(req)
                    continue
                free_pages -= need
                if share:
                    shares[req.request_id] = share
            selected.append(req)
            free_slots -= 1
        self._queue = deque(kept)
        for r in selected:
            self._skips.pop(r.request_id, None)
        if not selected:
            return
        if self.paged:
            self._admit_paged(selected, shares)
            return
        groups: Dict[int, List[Request]] = {}
        for r in selected:
            groups.setdefault(self._bucket_len(len(r.tokens)), []).append(r)
        for lb, group in groups.items():
            self._admit_group(lb, group)

    def _start(self, r: Request, slot: int, first: int) -> None:
        st = _Running(req=r, slot=slot, order=self._order)
        self._order += 1
        self._running[slot] = st
        self._pos[slot] = len(r.tokens)
        self._last_tok[slot] = first
        # the first sampled token goes through the same eos / length
        # bookkeeping as every later one
        self._record(st, first)

    def _prefill_stats(self, t0: float, group: List[Request]) -> None:
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += int(sum(len(r.tokens) for r in group))

    def _admit_group(self, lb: int, group: List[Request]) -> None:
        """Dense mode: one bucketed prefill launch for ``group``, each
        row's whole max_seq strip (or its SSM and conv states) copied into
        its slot."""
        n = len(group)
        slots = [self._free.pop(0) for _ in range(n)]
        toks = np.zeros((n, lb), np.int64)
        last = np.zeros((n,), np.int64)
        for i, r in enumerate(group):
            toks[i, :len(r.tokens)] = r.tokens
            last[i] = len(r.tokens) - 1
        t0 = time.perf_counter()
        logits, state = self._prefill_call(toks, last)
        idx = torch.tensor(slots, device=self.device)
        for part, bufs in self._state.items():
            for name, buf in (bufs or {}).items():
                buf.index_copy_(1, idx, state[part][name])
        first = sample(logits, self.sampling, self._generator).cpu().numpy()
        self._prefill_stats(t0, group)
        for i, r in enumerate(group):
            self._start(r, slots[i], int(first[i]))

    def _admit_paged(self, selected: List[Request],
                     shares: Dict[int, tuple]) -> None:
        """Paged mode: one prefill launch for every admitted request (with
        fp KV, short prompts first-fit packed into shared rows at page-
        aligned offsets), then each prompt's fresh pages paged in from the
        prefill buffer."""
        page = self.page_size
        spans = [pages_for(len(r.tokens), page) * page for r in selected]
        lb = self._row_len(max(len(r.tokens) for r in selected))
        packed = self._pack_ok and len(selected) > 1
        if packed:
            rows: List[List[Tuple[int, int]]] = []   # per row: (req, offset)
            used: List[int] = []
            for i, w in enumerate(spans):            # greedy first-fit
                for ri, u in enumerate(used):
                    if u + w <= lb:
                        rows[ri].append((i, u))
                        used[ri] += w
                        break
                else:
                    rows.append([(i, 0)])
                    used.append(w)
        else:
            rows = [[(i, 0)] for i in range(len(selected))]
        toks = np.zeros((len(rows), lb), np.int64)
        segs = np.full((len(rows), lb), -1, np.int64)
        last = np.zeros((len(selected), 2), np.int64)
        placement: Dict[int, Tuple[int, int]] = {}
        for ri, row in enumerate(rows):
            for i, off in row:
                n = len(selected[i].tokens)
                toks[ri, off:off + n] = selected[i].tokens
                # the page-rounded span carries the id: its pad rows sit
                # causally after the prompt, and decode overwrites their
                # cache rows before any mask admits them
                segs[ri, off:off + spans[i]] = i
                last[i] = (ri, off + n - 1)
                placement[i] = (ri, off)
        t0 = time.perf_counter()
        logits, state = self._prefill_call(toks, last,
                                           segs if packed else None)
        caches = state["caches"]
        first = sample(logits, self.sampling, self._generator).cpu().numpy()
        self._prefill_stats(t0, selected)
        for i, r in enumerate(selected):
            ri, off = placement[i]
            share = shares.get(r.request_id)
            shared = self.pool.share(share[1]) if share else []
            fresh = self.pool.alloc(pages_for(len(r.tokens), page)
                                    - len(shared))
            slot = self._free.pop(0)
            self.pool.assign(slot, shared + fresh)
            if fresh:
                # shared pages hold the same rows (a prefix attends only to
                # itself), so only the tail is paged in
                self._page_in(caches, ri, off + len(shared) * page, fresh)
            self._start(r, slot, int(first[i]))

    def _page_in(self, prefill_caches, row: int, col0: int,
                 pids: List[int]) -> None:
        """Copy whole pages [col0, col0 + len(pids) * page) of prefill row
        ``row`` into pool pages ``pids``, every layer and buffer."""
        n, page = len(pids), self.page_size
        idx = torch.tensor(pids, device=self.device)
        for name, pool in self._state["caches"].items():
            seg = prefill_caches[name][:, row, col0:col0 + n * page]
            pool.index_copy_(1, idx, seg.reshape(seg.shape[0], n, page,
                                                 *seg.shape[2:]))

    def _ensure_write_pages(self) -> None:
        """Before a decode step, give every running slot the page its next
        row lands in; when the pool is dry, preempt the youngest other
        request and retry, and with nothing else to evict the needy request
        preempts itself (it waits in the queue with its tokens carried)."""
        for slot in sorted(self._running):
            st = self._running.get(slot)
            if st is None:                 # preempted earlier in this loop
                continue
            while slot in self._running \
                    and int(self._pos[slot]) // self.page_size \
                    >= int(self.pool.used[slot]):
                if self.pool.free_pages == 0:
                    if not self._preempt_for(slot):
                        self._preempt(st)
                        break
                    continue
                self.pool.append(slot, self.pool.alloc(1)[0])

    def _preempt_for(self, needy_slot: int) -> bool:
        victims = [st for s, st in self._running.items() if s != needy_slot]
        if not victims:
            return False
        self._preempt(max(victims, key=lambda s: s.order))
        return True

    def _preempt(self, st: _Running) -> None:
        """Evict a running request: free its slot and pages now, and queue
        it at the front with prompt = original prompt + tokens generated so
        far (the carry map keeps the split for the final Response)."""
        self.preemptions += 1
        rid = st.req.request_id
        orig, prior = self._carry.get(rid, (list(st.req.tokens), []))
        gen = prior + st.tokens
        del self._running[st.slot]
        self.pool.release_slot(st.slot)
        self._free.append(st.slot)
        self._pos[st.slot] = 0
        self._last_tok[st.slot] = 0
        self._carry[rid] = (orig, gen)
        remaining = st.req.max_new_tokens - len(st.tokens)
        if remaining < 1 or len(orig) + len(gen) > self.max_seq - 1:
            # no decode row left for a continuation
            self._done.append(Response(request_id=rid, prompt=orig,
                                       tokens=gen, finish_reason="length"))
            self._carry.pop(rid, None)
            return
        self._queue.appendleft(dataclasses.replace(
            st.req, tokens=orig + gen, max_new_tokens=remaining))

    # -- degradation ladder ------------------------------------------------

    @staticmethod
    def _kv_path(rung: str) -> Optional[str]:
        """The model's ``kv_path`` on ``rung`` (the fp rung's caches are
        fp, read one way; the ``none`` rung has no caches)."""
        return None if rung in ("fp", "none") else rung

    def _decode_call(self, tok, pos, table) -> np.ndarray:
        """One decode step on the current rung: the model, the per-slot
        finite flag reduced on the device (a non-finite row is zeroed before
        sampling; its token is discarded), the sampled tokens -> host (2, B)
        int64 array of (token, finite).  The model's new state replaces the
        engine's only when the model returns (the SSM states' commit)."""
        logits, self._state = self.model.decode(
            self.params, self._state, tok, pos, policy=self.policy,
            page_table=table, kv_path=self._kv_path(self._rungs[self._rung]))
        finite = torch.isfinite(logits).all(dim=-1)
        nxt = sample(torch.where(finite[:, None], logits, 0.0),
                     self.sampling, self._generator)
        return torch.stack([nxt.long(), finite.long()]).cpu().numpy()

    def _dequant_caches(self, caches):
        """int8 strips or pools -> K/V in the carrier (payload x guarded
        scale: never-written rows stay exactly 0).  Pinned prefix pages
        convert with their pool, so aliased tables stay valid."""
        return {name: dequant_kv(caches[name], caches[name + "_scale"],
                                 self._dtype) for name in ("k", "v")}

    def _requant_caches(self, caches):
        """K/V in the carrier -> int8 payloads and per-(position, head) fp32
        scales (all-zero rows keep scale 0, the padding convention), as the
        reference: near-exact, each live row re-enters the codec with a
        fresh scale.  Both divisions are by tensors, so the bits are the
        same on every device."""
        spec = self.policy.kv_spec()
        out = {}
        for name in ("k", "v"):
            xf = caches[name].to(torch.float32)
            scale = _div(xf.abs().amax(dim=-1, keepdim=True), spec.qmax)
            q = torch.clamp(torch.round(xf / scale_guard(scale)), spec.qmin,
                            spec.qmax)
            out[name] = q.to(storage_dtype(spec.bits))
            out[name + "_scale"] = scale
        return out

    def _match_prefill_state(self, caches):
        """Prefill runs rung 0's path and writes int8 caches; on the fp rung
        they are dequantized to match the engine's before the copy."""
        if caches is None:
            return None
        if "k_scale" in caches and "k_scale" not in self._state["caches"]:
            return self._dequant_caches(caches)
        return caches

    def _demote(self, why: str, step: int) -> bool:
        """One rung down; False on the bottom rung.  Stepping onto the fp
        rung dequantizes the live caches (strips and pools alike), so the
        running requests go on with their history."""
        if self._rung + 1 >= len(self._rungs):
            return False
        frm, to = self._rungs[self._rung], self._rungs[self._rung + 1]
        caches = self._state["caches"]
        if to == "fp" and "k_scale" in caches:
            self._state = dict(self._state,
                               caches=self._dequant_caches(caches))
        self._rung += 1
        self.monitor.record_demotion(step, frm, to, why)
        return True

    def _try_promote(self, step: int) -> bool:
        """One rung up after a healthy streak; False on rung 0.  Leaving the
        fp rung requantizes the live caches; dequant -> fused reads the same
        buffers another way."""
        if self._rung == 0:
            return False
        frm, to = self._rungs[self._rung], self._rungs[self._rung - 1]
        caches = self._state["caches"]
        if frm == "fp" and "k_scale" not in caches:
            self._state = dict(self._state,
                               caches=self._requant_caches(caches))
        self._rung -= 1
        self.monitor.record_promotion(step, frm, to)
        return True

    def _absorb_step_failure(self, e: FaultInjected, step: int) -> bool:
        """True when the engine demoted a rung and the caller should retry
        the step; False (the bottom rung, and the SSM family's one rung
        ``none``) re-raises.  The reference also refuses when its donated
        buffers were consumed; the port donates nothing, and a retry -- by
        the ladder here, or by the caller after a re-raise -- starts from
        the state the failed attempt started from.  KV caches are written
        in place, but every rung writes row ``pos`` of every layer before it
        reads it, so the retry overwrites whatever the failed attempt wrote.
        SSM states are a recurrence, which a second update would advance
        twice: the decode step computes them into fresh tensors, and
        ``_decode_call`` commits them only when the step returns."""
        self.monitor.record_kernel_error(step)
        return self._demote(f"decode step failed: {type(e).__name__}: {e}",
                            step=step)

    def _step(self) -> None:
        hooks = self.fault_hooks
        n = self._decode_steps
        if hooks is not None:
            hooks.pre_step(self, n)
        if self.paged:
            self._ensure_write_pages()
            if not self._running:
                return
        dev = self.device
        t0 = time.perf_counter()
        tok = torch.from_numpy(self._last_tok[:, None].copy()).to(dev)
        pos = torch.from_numpy(self._pos.copy()).to(dev)
        table = self.pool.table_array(dev) if self.paged else None
        try:
            if hooks is not None:
                hooks.kernel(n)
            host = self._decode_call(tok, pos, table)
        except FaultInjected as e:
            # the ladder's guarded dispatch: an injected failure demotes one
            # rung and retries; on the bottom rung it re-raises into the
            # scheduler's dead-loop watchdog.  The reference absorbs every
            # exception; here any other one (a kernel that does not launch,
            # a shape error) propagates, so the plain path never serves
            # around a failing kernel (ROADMAP section 3)
            if not self._absorb_step_failure(e, n):
                raise
            host = self._decode_call(tok, pos, table)
        dt = time.perf_counter() - t0
        self.monitor.record_step(dt * 1e3)
        rung = self._rungs[self._rung]
        self.stats["rung_steps"][rung] += 1
        self.stats["rung_s"][rung] += dt
        self.stats["decode_s"] += dt
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(self._running)
        self._decode_steps = n + 1
        finite = host[1].astype(bool)
        if hooks is not None:
            finite = hooks.mangle_finite(n, finite)
            hooks.post_step(self, n)
        for slot in list(self._running):
            st = self._running[slot]
            self._pos[slot] += 1
            if not finite[slot]:
                # quarantine this request only: its token is not recorded
                self.monitor.record_quarantine(n)
                self._finish(st, "numerics")
                continue
            self._last_tok[slot] = int(host[0, slot])
            self._record(st, int(host[0, slot]))
            if slot in self._running and self._pos[slot] >= self.max_seq:
                self._finish(st, "length")       # cache rows exhausted
        if self.monitor.should_demote(n):
            cfg = self.monitor.cfg
            self._demote(f"{cfg.numeric_limit}+ numeric quarantines within "
                         f"{cfg.numeric_window} steps", step=n)
        elif self._rung > 0 and self.monitor.should_reprobe():
            self._try_promote(step=n)

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
        if self.paged:
            # pages recycle now (refcounted: shared prefix pages survive);
            # position 0 on a trash-page table row keeps the freed slot's
            # discarded write out of pages another slot owns
            self.pool.release_slot(st.slot)
            self._pos[st.slot] = 0
            self._last_tok[st.slot] = 0
        rid = st.req.request_id
        orig, prior = self._carry.pop(rid, (list(st.req.tokens), []))
        self._done.append(Response(request_id=rid, prompt=orig,
                                   tokens=prior + st.tokens,
                                   finish_reason=reason))
