"""Paged KV-cache block allocator (host-side control plane): a copy of
``repro.serving.kv_pool`` (numpy only), kept in the port because the port
imports nothing of the reference.

The device holds one KV pool per attention layer, laid out
``[num_pages, page_size, K, h]`` (``stacks.cache_template(paged=True)``).
This module owns the metadata: which physical pages belong to which slot,
page refcounts, the free list and the prefix cache. Every decision is made
on the host between engine ticks; the device only sees the resulting
``[n_slots, pages_per_slot]`` int32 page table (and occasional page copies
for copy-on-write).

- **Null page.** Physical page 0 is reserved: padding entries of every
  table row point at it, and retired slots' rows are reset to it, so a done
  slot riding through a fused tick writes into a sink, never into a page
  handed to another slot.
- **Refcounting + prefix cache.** Full pages holding a prompt prefix are
  content-addressed by a prefix-closed digest; repeated robot observations
  share those pages, and ``prefix_hits`` counts the pages saved.
- **Copy-on-write.** Writing into a page with refcount > 1 first copies it
  (``prepare_write`` returns the (src, dst) pairs the engine copies).
- **Cached-page retention.** A hashed page whose refcount drops to zero is
  retained (LRU) and reclaimed, oldest first, only under pressure.

Quantized pools' scale rows are cache leaves indexed by the same page ids,
so every page operation moves scales with values without this class
knowing about quantization.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """No free pages left; admission should defer (re-queue) the request."""


class KVPool:
    """Block allocator for one serving engine's paged KV caches.

    Parameters
    ----------
    num_pages: total physical pages, *including* the reserved null page 0.
    page_size: tokens per page.
    n_slots / pages_per_slot: shape of the page table handed to the device.

    Invariants (every public method preserves all of them):

    - ``page_table`` is ``[n_slots, pages_per_slot]`` int32; row ``b``
      holds ``slot_pages[b]`` left-justified, padded with the null page 0.
      Logical position ``i`` of slot ``b`` lives at
      ``(page_table[b, i // page_size], i % page_size)``.
    - Page 0 is never allocated, never freed, never hashed; ``refcount[0]``
      is pinned at 1. Every table entry that does not name a live page
      names page 0 (the device-side write sink).
    - ``refcount[p] > 0`` iff some slot's page list (or a mid-call
      transaction) references ``p``; refcount 0 means ``p`` is on the free
      list, or — if it still carries a prefix hash — in the retained LRU.
    - Prefix digests are *prefix-closed* (key ``i`` covers all positions up
      to page ``i``'s end), so ``admit`` may share exactly a leading run of
      hit pages; ``_hash_to_page`` only ever points at pages whose KV has
      actually been written (rollback drops registrations of fresh pages).
    - Mutating methods are atomic under ``PoolExhausted``: ``admit`` and
      ``prepare_write`` roll back partial work before raising, so the
      caller observes either the full transition or none of it.
    """

    def __init__(self, num_pages: int, page_size: int, n_slots: int,
                 pages_per_slot: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + null page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.refcount = np.zeros(num_pages, np.int32)
        self.refcount[0] = 1                       # null page, never freed
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.page_table = np.zeros((n_slots, pages_per_slot), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref==0
        self.reserve = 0                           # decode-headroom pages
        # stats
        self.prefix_hits = 0                       # pages reused via prefix cache
        self.pages_hwm = 0                         # high-water pages in use

    # -- accounting --------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """Pages referenced by live slots (excludes retained cache pages)."""
        return (self.num_pages - 1) - len(self._free) - len(self._cached)

    @property
    def cached_pages(self) -> int:
        """Zero-ref prefix pages retained for future hits (reclaimable)."""
        return len(self._cached)

    def num_pages_for(self, length: int) -> int:
        """Pages needed to cover ``length`` positions (ceil division)."""
        return -(-length // self.page_size)

    def byte_stats(self, bytes_per_page: int) -> dict:
        """Page counts priced at a caller-supplied per-page byte cost. The
        pool tracks page *indices* only and stays layout-blind: the engine
        passes its global bytes-per-page for the summed figure and its
        per-device bytes-per-page when the cache leaves are sharded across
        an accelerator mesh — same pool, no layout knowledge here."""
        return {"bytes_in_use": self.pages_in_use * bytes_per_page,
                "bytes_hwm": self.pages_hwm * bytes_per_page}

    def slot_len_capacity(self, slot: int) -> int:
        """Positions the slot's currently-held pages can store; decode past
        this must ``ensure`` growth first or its write lands out of range."""
        return len(self.slot_pages[slot]) * self.page_size

    # -- allocation core ---------------------------------------------------
    def set_reserve(self, n_pages: int):
        """Reserve ``n_pages`` of decode headroom: admission-side allocation
        (``admit`` / ``ensure(use_reserve=False)``) refuses to dip into the
        last ``n_pages`` of supply, so in-flight decodes can always grow
        into their next page instead of deadlocking behind a fresh prompt
        that grabbed the final free page. Decode-side growth and COW pass
        ``use_reserve=True`` and may consume the reserve."""
        if n_pages < 0 or n_pages > self.num_pages - 1:
            raise ValueError(f"reserve {n_pages} out of range "
                             f"(pool has {self.num_pages - 1} pages)")
        self.reserve = n_pages

    def _supply(self, use_reserve: bool) -> int:
        """Pages allocatable right now (free list + reclaimable cached),
        minus the decode-headroom reserve for admission-side callers."""
        supply = len(self._free) + len(self._cached)
        return supply if use_reserve else supply - self.reserve

    def _alloc(self, use_reserve: bool = True) -> int:
        if self._supply(use_reserve) <= 0:
            raise PoolExhausted(
                f"KV pool exhausted: {self.num_pages - 1} pages, "
                f"{self._supply(True)} allocatable, "
                f"reserve {self.reserve} "
                f"({'decode' if use_reserve else 'admission'} side)")
        if self._free:
            pid = self._free.pop()
        else:
            pid, _ = self._cached.popitem(last=False)   # evict oldest
            self._drop_hash(pid)
        self.refcount[pid] = 1
        self.pages_hwm = max(self.pages_hwm, self.pages_in_use)
        return pid

    def _drop_hash(self, pid: int):
        key = self._page_hash.pop(pid, None)
        if key is not None and self._hash_to_page.get(key) == pid:
            del self._hash_to_page[key]

    def _incref(self, pid: int):
        if self.refcount[pid] == 0:                     # revive cached page
            self._cached.pop(pid, None)
        self.refcount[pid] += 1

    def _decref(self, pid: int):
        assert self.refcount[pid] > 0, pid
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            if pid in self._page_hash:
                self._cached[pid] = None                # retain for reuse
            else:
                self._free.append(pid)

    def _sync_table_row(self, slot: int):
        row = self.page_table[slot]
        row[:] = 0
        pages = self.slot_pages[slot]
        row[:len(pages)] = pages

    # -- slot lifecycle ----------------------------------------------------
    def can_admit(self, seq_len: int,
                  prefix_keys: Sequence[bytes] = ()) -> bool:
        """Whether ``admit(slot, seq_len, prefix_keys)`` would succeed right
        now, without touching any state. Lets the engine check capacity
        *before* paying for vision + prefill on a request it would only have
        to defer. Accounts for prefix pages that sit in the retained cache:
        a hit revives such a page, so it is shared *and* no longer
        reclaimable — counting it as both would overstate supply."""
        n_pages = self.num_pages_for(seq_len)
        if n_pages > self.pages_per_slot:
            return True     # let admit() raise the ValueError
        n_full = seq_len // self.page_size
        n_shared = shared_cached = 0
        for i in range(min(n_full, len(prefix_keys))):
            pid = self._hash_to_page.get(prefix_keys[i])
            if pid is None:
                break
            n_shared += 1
            if self.refcount[pid] == 0:
                shared_cached += 1   # a hit revives it: not reclaimable too
        supply = self._supply(use_reserve=False) - shared_cached
        return n_pages - n_shared <= supply

    def match_prefix(self, prefix_keys: Sequence[bytes]) -> int:
        """Leading run of prefix digests already registered in the prefix
        cache — the pages a matching request can *share* (and, in the
        chunked-prefill engine, skip recomputing: prefill starts at the
        first non-shared token). Read-only; prefix-closed digests make the
        leading-run check sufficient."""
        n = 0
        for key in prefix_keys:
            if key not in self._hash_to_page:
                break
            n += 1
        return n

    def admit(self, slot: int, seq_len: int,
              prefix_keys: Sequence[bytes] = (),
              register: bool = True) -> Tuple[List[int], int]:
        """Allocate pages covering ``seq_len`` positions for ``slot``.

        ``prefix_keys`` are prefix-closed digests for each *full* page of
        the prompt (key i covers positions [0, (i+1)*page_size)). A leading
        run of keys already in the prefix cache is shared (refcount bump, no
        new pages); everything else is freshly allocated and — with
        ``register`` (the monolithic-prefill default, where the caller
        scatters all prompt KV before anything else runs) — the fresh full
        pages are registered so later requests can hit them. The chunked
        engine passes ``register=False`` and registers pages via
        ``register_prefix_pages`` only after their chunk is actually
        written, so a digest can never resolve to a page whose KV does not
        exist yet.

        Admission-side: never dips into the decode-headroom reserve.
        Atomic: on PoolExhausted, nothing is retained. Returns
        (page ids, n_shared).
        """
        assert not self.slot_pages[slot], f"slot {slot} still holds pages"
        n_pages = self.num_pages_for(seq_len)
        if n_pages > self.pages_per_slot:
            raise ValueError(f"seq_len {seq_len} exceeds slot capacity "
                             f"{self.pages_per_slot * self.page_size}")
        n_full = seq_len // self.page_size
        pages: List[int] = []
        n_shared = 0
        for i in range(min(n_full, len(prefix_keys))):
            pid = self._hash_to_page.get(prefix_keys[i])
            if pid is None:
                break
            self._incref(pid)
            pages.append(pid)
            n_shared += 1
        try:
            for i in range(n_shared, n_pages):
                pid = self._alloc(use_reserve=False)
                pages.append(pid)
                if register and i < n_full and i < len(prefix_keys):
                    self._hash_to_page[prefix_keys[i]] = pid
                    self._page_hash[pid] = prefix_keys[i]
        except PoolExhausted:
            for pid in pages[:n_shared]:
                self._decref(pid)
            for pid in pages[n_shared:]:
                # fresh pages hold no KV yet — drop their hash registration
                # so the rollback cannot leave prefix-cache entries pointing
                # at never-written pages, and free them outright
                self._drop_hash(pid)
                self.refcount[pid] = 0
                self._free.append(pid)
            raise
        self.prefix_hits += n_shared
        self.slot_pages[slot] = pages
        self._sync_table_row(slot)
        return pages, n_shared

    def ensure(self, slot: int, length: int,
               use_reserve: bool = True) -> List[int]:
        """Grow ``slot`` to cover ``length`` positions (capped at slot
        capacity). Returns the freshly allocated page ids. Raises
        ``PoolExhausted`` with the slot partially grown — already-appended
        pages stay owned by the slot (they are valid growth, not a broken
        transaction), so a retry after the caller frees pressure continues
        where this call stopped. ``use_reserve=False`` marks admission-side
        growth (chunked prefill) that must not eat the decode headroom;
        the default is decode-side growth, which may."""
        length = min(length, self.pages_per_slot * self.page_size)
        fresh: List[int] = []
        while self.slot_len_capacity(slot) < length:
            pid = self._alloc(use_reserve=use_reserve)
            self.slot_pages[slot].append(pid)
            fresh.append(pid)
        if fresh:
            self._sync_table_row(slot)
        return fresh

    def register_prefix_pages(self, slot: int,
                              prefix_keys: Sequence[bytes],
                              n_written: int) -> int:
        """Register the slot's full prompt pages whose KV has now been
        written (chunked prefill calls this after each chunk lands,
        ``n_written`` = prompt positions written so far). Only pages that
        carry no hash yet are registered — shared (hit) pages already have
        one — and a digest is never re-pointed away from a live page, so
        the prefix-closed invariant (``_hash_to_page`` only names
        written-KV pages) holds at every tick boundary. Returns how many
        pages were newly registered."""
        pages = self.slot_pages[slot]
        n = 0
        for i in range(min(n_written // self.page_size, len(prefix_keys),
                           len(pages))):
            pid = pages[i]
            if pid in self._page_hash:
                continue
            key = prefix_keys[i]
            if key in self._hash_to_page:
                continue        # another slot registered this digest first
            self._hash_to_page[key] = pid
            self._page_hash[pid] = key
            n += 1
        return n

    def prepare_write(self, slot: int, start: int,
                      end: int) -> List[Tuple[int, int]]:
        """Make positions [start, end) of ``slot`` safely writable:
        copy-on-write any shared page in the range. Returns (src, dst) page
        pairs the caller must copy on device before writing. Atomic: if the
        pool runs out mid-COW, completed swaps are rolled back (the caller
        never learns of pairs it would then fail to copy) and the exception
        propagates with the slot in its pre-call state."""
        copies: List[Tuple[int, int]] = []
        pages = self.slot_pages[slot]
        idxs: List[int] = []
        try:
            for i in range(start // self.page_size,
                           min(self.num_pages_for(end), len(pages))):
                pid = pages[i]
                if self.refcount[pid] > 1:
                    new = self._alloc()
                    self._decref(pid)
                    pages[i] = new
                    copies.append((pid, new))
                    idxs.append(i)
        except PoolExhausted:
            for i, (old, new) in zip(reversed(idxs), reversed(copies)):
                self.refcount[new] = 0
                self._free.append(new)
                self._incref(old)        # was > 1 pre-COW, so never cached
                pages[i] = old
            self._sync_table_row(slot)
            raise
        if copies:
            self._sync_table_row(slot)
        return copies

    def fork(self, src: int, dst: int):
        """Share all of ``src``'s pages with ``dst`` (zero-copy refcount
        bumps; ``dst`` must be empty). Later writes on either side trigger
        copy-on-write via ``prepare_write`` — the beam/speculative-decoding
        entry point; the engine's own admit path never forks."""
        assert not self.slot_pages[dst], f"slot {dst} still holds pages"
        for pid in self.slot_pages[src]:
            self._incref(pid)
        self.slot_pages[dst] = list(self.slot_pages[src])
        self._sync_table_row(dst)

    def free_slot(self, slot: int):
        """Release the slot's pages (eviction on finish). Shared pages
        survive while other slots or the prefix cache's future hits need
        them; the table row resets to the null page so stale device-side
        writes land in the sink."""
        for pid in self.slot_pages[slot]:
            self._decref(pid)
        self.slot_pages[slot] = []
        self.page_table[slot, :] = 0
