"""Paged KV cache: fixed-size pages, a free-list allocator, refcounts (port
of ``repro/infer/pages.py``).

The dense engine holds K/V as ``(slots, max_seq)`` strips, so decode memory
scales with the worst-case length.  Paged KV splits the cache into pages:

* ``init_paged_caches`` builds per-buffer pools ``(n_layers, n_pages,
  page_size, kv_heads, head_dim)`` -- int8 payloads plus ``(.., page_size,
  kv_heads, 1)`` fp32 scales under an int8 ``kv_spec``, carrier pools
  otherwise.  One page id addresses the same page in every layer, so the
  page table is per slot only.
* :class:`PagePool` is the host-side allocator: a LIFO free list (a freed
  page is handed out again first), a per-slot page table of width
  ``max_seq // page_size``, and per-page refcounts -- ``share`` aliases a
  cached prefix's pages into another slot's table without a copy.
* **Page 0 is the trash page.**  It is never on the free list; empty table
  entries point at it, so idle decode slots write their discarded rows
  there and no live slot ever reads it.

The pools live on the device in ``Engine._state`` and are written only by
the decode step and the page-in copy; the pool here tracks which pages are
live, never their contents.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.quantizer import storage_dtype

TRASH_PAGE = 0


class CapacityError(ValueError):
    """A request cannot be held by the configured cache geometry.  A
    :class:`ValueError` that carries the paged accounting, so callers can
    size pools or shed load without parsing the message."""

    def __init__(self, message: str, *,
                 tokens: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 page_size: Optional[int] = None,
                 pages_needed: Optional[int] = None,
                 pages_total: Optional[int] = None,
                 pages_free: Optional[int] = None,
                 slots_total: Optional[int] = None,
                 slots_free: Optional[int] = None):
        super().__init__(message)
        self.tokens = tokens
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_needed = pages_needed
        self.pages_total = pages_total
        self.pages_free = pages_free
        self.slots_total = slots_total
        self.slots_free = slots_free


@dataclasses.dataclass
class PagePool:
    """Host-side page allocator and per-slot page tables (module doc)."""
    n_pages: int
    page_size: int
    max_slots: int
    max_pages_per_slot: int

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is the trash page)")
        # LIFO: the page freed last is allocated first, so recycled pages
        # (the previous tenant's rows still in them) are the common case
        self._free: List[int] = list(range(1, self.n_pages))
        self.refcount = np.zeros((self.n_pages,), np.int32)
        self.refcount[TRASH_PAGE] = 1          # pinned forever
        self.table = np.zeros((self.max_slots, self.max_pages_per_slot),
                              np.int32)
        self.used = np.zeros((self.max_slots,), np.int32)  # pages per slot

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages currently referenced (trash page excluded)."""
        return int(np.sum(self.refcount[1:] > 0))

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise CapacityError(
                f"page pool exhausted: need {n} pages, {len(self._free)} free "
                f"of {self.n_pages - 1} allocatable",
                pages_needed=n, pages_total=self.n_pages - 1,
                pages_free=len(self._free), page_size=self.page_size)
        pids = [self._free.pop() for _ in range(n)]
        self.refcount[pids] += 1
        return pids

    def share(self, pids: List[int]) -> List[int]:
        """One more reference to each live page (prefix sharing)."""
        assert all(self.refcount[p] > 0 for p in pids)
        self.refcount[list(pids)] += 1
        return list(pids)

    def pin(self, pids: List[int]) -> None:
        """A permanent extra reference (cached prefixes outlive requests)."""
        self.refcount[list(pids)] += 1

    def release(self, pids: List[int]) -> None:
        for p in pids:
            if p == TRASH_PAGE:
                continue
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
            assert self.refcount[p] >= 0

    def assign(self, slot: int, pids: List[int]) -> None:
        """Install a slot's page list (already referenced by alloc/share)."""
        assert len(pids) <= self.max_pages_per_slot
        self.table[slot] = TRASH_PAGE
        self.table[slot, :len(pids)] = pids
        self.used[slot] = len(pids)

    def append(self, slot: int, pid: int) -> None:
        """Map one more allocated page at the end of a slot's table."""
        u = int(self.used[slot])
        assert u < self.max_pages_per_slot
        self.table[slot, u] = pid
        self.used[slot] = u + 1

    def slot_pages(self, slot: int) -> List[int]:
        return [int(p) for p in self.table[slot, :int(self.used[slot])]]

    def release_slot(self, slot: int) -> List[int]:
        """Free a finished slot: release its pages and point its table back
        at the trash page.  Returns the page ids that were mapped."""
        pids = self.slot_pages(slot)
        self.release(pids)
        self.table[slot] = TRASH_PAGE
        self.used[slot] = 0
        return pids

    def table_array(self, device: Union[str, torch.device] = "cpu"
                    ) -> torch.Tensor:
        """The (max_slots, max_pages_per_slot) table as an int32 tensor on
        ``device``: the decode kernel's page-table operand."""
        return torch.from_numpy(self.table.copy()).to(device)


def pages_for(n_tokens: int, page_size: int) -> int:
    """ceil(n_tokens / page_size): pages that hold n_tokens rows."""
    return -(-int(n_tokens) // int(page_size))


def init_paged_caches(cfg, n_pages: int, page_size: int, dtype: torch.dtype,
                      kv_spec=None, device: Union[str, torch.device] = "cpu"
                      ) -> Dict[str, torch.Tensor]:
    """Pools for the whole layer stack, the dense caches' dict layout with
    ``(L, n_pages, page_size, K, hd)`` in place of ``(L, B, max_seq, K,
    hd)``: int8 payloads plus fp32 ``(.., K, 1)`` scales when ``kv_spec``
    is set, carrier pools otherwise.  Zero-filled."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if kv_spec is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    qdt = storage_dtype(kv_spec.bits)
    side = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=qdt, device=device),
            "v": torch.zeros(shape, dtype=qdt, device=device),
            "k_scale": torch.zeros(side, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(side, dtype=torch.float32, device=device)}


def page_nbytes(caches: Dict[str, torch.Tensor]) -> int:
    """Bytes one page occupies across every buffer and layer."""
    return sum(t.shape[0] * int(np.prod(t.shape[2:])) * t.element_size()
               for t in caches.values())


__all__ = ["CapacityError", "PagePool", "TRASH_PAGE", "init_paged_caches",
           "page_nbytes", "pages_for"]
