"""The engine's shared paged device KV store — the counterpart of the
reference's ``DevicePagePool`` (``repro/serving/paged_cache.py``),
single bank, no mesh.

One page store per process (the stand-in for a node's HBM), shared by
every ``PrefillWorker`` (writes fresh pages, §3 step 2) and the
``DecodeWorker`` (attends them through block tables, §3 step 4):

* ``k_pages``/``v_pages``: (L, P, page_tokens, KV, Dh) bf16 tensors on
  the pool's device; page 0 is the reserved null page (block tables pad
  with it, reads of it are always masked).
* host-side REFCOUNTS, a block-hash → page-run REGISTRY with LRU eviction
  of registry-only runs, allocation GENERATIONS and COPY-ON-WRITE — the
  reference's logic unchanged.
* device writes are in-place indexed copies into the slabs (the
  reference rebinds functional ``.at[].set`` updates).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.models.layers import DTYPE


class DevicePagePool:
    """Refcounted paged KV store with a prefix registry (see module doc).

    A page is held by the hash-run registry and/or by block-table rows
    and staged prefill results; ``release`` at refcount 0 returns it to
    the free list (below 0 raises: double-free guard). Registry-only runs
    (refcount 1) are evicted LRU under allocation pressure; runs a live
    slot references are pinned. ``make_writable`` copies a shared page
    before a slot appends into it.
    """

    def __init__(self, cfg: ModelConfig, *, n_pages: int,
                 page_tokens: int = 64, device="cuda") -> None:
        if BLOCK_TOKENS % page_tokens:
            raise ValueError(
                f"page_tokens={page_tokens} must divide the pool block "
                f"({BLOCK_TOKENS} tokens) so a block maps to a page run")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_tokens = page_tokens
        shape = (cfg.n_layers, n_pages, page_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=DTYPE, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=DTYPE, device=self.device)
        # reentrant: alloc -> eviction -> unregister -> release re-enters
        self._lock = threading.RLock()
        self.free: list[int] = list(range(n_pages - 1, 0, -1))  #: guarded_by self._lock
        self.refs = np.zeros(n_pages, np.int32)   #: guarded_by self._lock
        self.gens = np.zeros(n_pages, np.int64)   #: guarded_by self._lock
        self.runs: dict[int, list[int]] = {}      #: guarded_by self._lock
        self._lru: list[int] = []                 #: guarded_by self._lock
        #: guarded_by self._lock
        self.counters = dict(pages_written=0, shared_adoptions=0,
                             cow_copies=0, registry_evictions=0,
                             alloc_failures=0, pages_exported=0,
                             pages_imported=0)

    # ---- geometry ------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def pages_per_block(self) -> int:
        return BLOCK_TOKENS // self.page_tokens

    def pages_for(self, n_tokens: int) -> int:
        return (n_tokens + self.page_tokens - 1) // self.page_tokens

    @property
    def used_pages(self) -> int:
        with self._lock:
            return int((self.refs > 0).sum())

    def pressure(self) -> dict:
        """Occupancy snapshot for admission backpressure. ``pinned`` pages
        (held by a live slot or staged result) are the signal: registry-
        only runs evict on demand, so high occupancy with low
        ``pinned_frac`` is a warm cache, not pressure."""
        with self._lock:
            cap = self.n_pages - 1
            evictable = sum(len(self.runs[h]) for h in self._evictable_locked())
            used = int((self.refs > 0).sum())
            pinned = used - evictable
            return dict(
                capacity=cap, free=len(self.free), used=used,
                evictable=evictable, pinned=pinned,
                occupancy=used / cap if cap else 1.0,
                pinned_frac=pinned / cap if cap else 1.0)

    # ---- refcounted allocation ----------------------------------------
    def _evictable_locked(self) -> list[int]:
        """Registered block hashes held ONLY by the registry, LRU first.
        Caller holds ``self._lock``."""
        return [h for h in self._lru
                if all(self.refs[p] == 1 for p in self.runs[h])]

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` fresh pages (refcount 1 each), evicting registry-only
        runs LRU when the free list runs short. Raises ``MemoryError``
        (taking nothing) if pressure can't be relieved."""
        with self._lock:
            if len(self.free) < n:
                for h in self._evictable_locked():
                    self.unregister(h)
                    if len(self.free) >= n:
                        break
            if len(self.free) < n:
                self.counters["alloc_failures"] += 1
                raise MemoryError(
                    f"device page pool OOM: want {n} pages, "
                    f"free {len(self.free)} of {self.n_pages - 1}")
            pages = [self.free.pop() for _ in range(n)]
            for p in pages:
                self.refs[p] = 1
                self.gens[p] += 1
            return pages

    def gens_of(self, pages: list[int]) -> list[int]:
        """Allocation generations of a page run — a holder snapshots them
        and re-checks before taking late references (a freed-and-realloc'd
        page must read as STALE, never as someone else's KV)."""
        with self._lock:
            return [int(self.gens[p]) for p in pages]

    def retain(self, pages: list[int]) -> None:
        with self._lock:
            for p in pages:
                if self.refs[p] <= 0:
                    raise RuntimeError(f"retain of unowned page {p}")
                self.refs[p] += 1

    def release(self, pages: list[int]) -> None:
        with self._lock:
            for p in pages:
                if p == 0:
                    continue                # null-page padding in tables
                if self.refs[p] <= 0:
                    raise RuntimeError(f"double free of page {p}")
                self.refs[p] -= 1
                if self.refs[p] == 0:
                    self.free.append(p)

    # ---- block-hash registry (cross-slot prefix sharing) ---------------
    def register_block(self, hash_id: int, pages: list[int]) -> None:
        """Publish a full block's page run for later chains to adopt. The
        registry holds one reference of its own."""
        assert len(pages) == self.pages_per_block
        with self._lock:
            if hash_id in self.runs:        # racing identical prefills
                return
            self.retain(pages)
            self.runs[hash_id] = list(pages)
            self._lru.append(hash_id)

    def unregister(self, hash_id: int) -> None:
        with self._lock:
            pages = self.runs.pop(hash_id, None)
            if pages is None:
                return
            self._lru.remove(hash_id)
            self.release(pages)
            self.counters["registry_evictions"] += 1

    def lookup_chain(self, hash_ids: list[int]) -> int:
        """Deepest consecutive registered prefix (no side effects)."""
        with self._lock:
            n = 0
            for h in hash_ids:
                if h not in self.runs:
                    break
                n += 1
            return n

    def adopt_chain(self, hash_ids: list[int]) -> tuple[int, list[int]]:
        """Retain + return the page runs of the chain's registered prefix:
        (n_blocks_adopted, flat page ids). The caller owns one reference
        per page; the physical pages are SHARED with every adopter."""
        with self._lock:
            n = self.lookup_chain(hash_ids)
            pages: list[int] = []
            for h in hash_ids[:n]:
                run = self.runs[h]
                self.retain(run)
                pages.extend(run)
                self._lru.remove(h)         # touch recency
                self._lru.append(h)
            if n:
                self.counters["shared_adoptions"] += n
            return n, pages

    # ---- device writes -------------------------------------------------
    def write_run(self, pages: list[int], k: torch.Tensor,
                  v: torch.Tensor) -> None:
        """Scatter (L, T, KV, Dh) KV (host or device) into ``pages``
        (T ≤ len(pages)·page) with one indexed copy per slab; a partial
        tail page is zero-padded (fresh pages, nothing to preserve)."""
        pt = self.page_tokens
        L, T = k.shape[0], k.shape[1]
        n = len(pages)
        assert T <= n * pt, (T, n, pt)
        pad = n * pt - T
        k = torch.as_tensor(k).to(self.device, DTYPE)
        v = torch.as_tensor(v).to(self.device, DTYPE)
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        shape = (L, n, pt) + tuple(k.shape[2:])
        with self._lock:
            self.k_pages[:, idx] = k.reshape(shape)
            self.v_pages[:, idx] = v.reshape(shape)
            self.counters["pages_written"] += n

    def make_writable(self, page: int) -> int:
        """Copy-on-write: a page id safe to append into. A single-owner
        page is returned as-is; a shared one is copied to a fresh page
        (the caller points its table at the new id; its reference to the
        old one is dropped here)."""
        with self._lock:
            if self.refs[page] == 1:
                return page
            (new,) = self.alloc(1)
            self.k_pages[:, new] = self.k_pages[:, page]
            self.v_pages[:, new] = self.v_pages[:, page]
            self.release([page])
            self.counters["cow_copies"] += 1
            return new

    # ---- device↔host tier transfers (preemption spill/restore) ---------
    def export_run(self, pages: list[int], n_tokens: int):
        """Demote a live page run to host memory: gather its contiguous
        (L, n_tokens, KV, Dh) KV into fresh host tensors, then RELEASE the
        caller's reference to ``pages`` — ownership moves into the
        returned bytes. They are copies (advanced indexing never views
        the slab), so recycled pages cannot change them."""
        k, v = self.read_seq(pages, n_tokens)
        with self._lock:
            self.release(pages)
            self.counters["pages_exported"] += len(pages)
        return k, v

    def import_run(self, k: torch.Tensor, v: torch.Tensor,
                   n_tokens: int) -> list[int]:
        """Promote host KV back into a fresh page run (the inverse of
        ``export_run``; the registry is NOT touched — ``stage_run``
        re-shares full blocks). Raises ``MemoryError`` holding nothing."""
        pages = self.alloc(self.pages_for(n_tokens))
        try:
            self.write_run(pages, k[:, :n_tokens], v[:, :n_tokens])
        except BaseException:
            self.release(pages)
            raise
        with self._lock:
            self.counters["pages_imported"] += len(pages)
        return pages

    # ---- host-side reads ----------------------------------------------
    def read_seq(self, pages: list[int], n_tokens: int):
        """Gather one sequence's contiguous (L, n_tokens, KV, Dh) KV as
        host tensors (copies)."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        L = self.k_pages.shape[0]
        k = self.k_pages[:, idx]            # (L, n, pt, KV, Dh), a copy
        v = self.v_pages[:, idx]
        k = k.reshape(L, -1, *k.shape[3:])[:, :n_tokens]
        v = v.reshape(L, -1, *v.shape[3:])[:, :n_tokens]
        return k.cpu(), v.cpu()

    def stats(self) -> dict:
        """Lifetime counters + the ``pressure()`` occupancy gauges."""
        with self._lock:
            out = dict(self.counters)
            out.update(self.pressure())
            return out

    def check_leaks(self) -> None:
        """Invariant: every non-free page is referenced and vice versa;
        the null page is never allocated."""
        with self._lock:
            free = set(self.free)
            assert 0 not in free and self.refs[0] == 0, \
                "null page entered circulation"
            for p in range(1, self.n_pages):
                if p in free:
                    assert self.refs[p] == 0, \
                        f"freed page {p} still referenced"
                else:
                    assert self.refs[p] > 0, \
                        f"page {p} leaked (no ref, not free)"
            assert len(free) == len(self.free), "free list duplicates"
