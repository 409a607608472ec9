"""Paged device KV caches — the counterparts of the reference's
``repro/serving/paged_cache.py``. Two tiers of API, as there:

* the functional ``PagedKVCache`` helpers (``init_paged_cache``,
  ``alloc_pages``, ``assign_seq``, ``grow_seq``, ``free_seq``,
  ``write_kv``, ``gather_kv``): a self-contained paged cache whose block
  table and pages move together. The host-side table helpers return a
  new cache with new tables and the same page tensors, as the
  reference's do; ``write_kv`` checks every page it would touch before
  writing, then writes the pages IN PLACE (the reference rebinds a
  functional update), so a write that raises leaves every page as it
  was;
* ``DevicePagePool``, the engine's substrate (below).

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
* MESH BANKS (``mesh=`` a (data, model) ``launch.mesh.Mesh``): the page
  axis splits into one BANK of ``n_pages`` pages per data shard (capacity
  scales ×data) and the KV-head axis into one stripe per model position;
  each (data, model) position holds its own (L, n_pages, page, KV/m, Dh)
  slab pair on its device (``slabs``; ``device`` is then the first
  position's) — separate tensors even where two positions share a
  device, so in-place writes never collide. Host-side
  state stays LOGICAL and global, as in the reference: page ids are
  global (``bank_of`` recovers the bank, the local id is global %
  ``bank_pages``, and global ids ≡ 0 mod ``bank_pages`` are each bank's
  null page), refcounts and generations are one array, and the free
  lists, registries and LRUs are per bank, because a data shard's rows
  attend only pages of its own bank. With ``mesh=None`` the pool is the
  single-bank one (``free``/``runs``/``_lru`` ARE bank 0's objects).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.models.layers import DTYPE


@dataclass
class PagedKVCache:
    k_pages: torch.Tensor       # (L, P, page, KV, Dh)
    v_pages: torch.Tensor
    block_table: torch.Tensor   # (B, max_pages) int32, on the pages' device
    seq_lens: torch.Tensor      # (B,) int32
    page_tokens: int
    free: list = field(default_factory=list)   # host-side free page ids

    @property
    def n_layers(self) -> int:
        return self.k_pages.shape[0]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def max_pages_per_seq(self) -> int:
        return self.block_table.shape[1]

    def _with(self, table: np.ndarray, lens: np.ndarray) -> "PagedKVCache":
        dev = self.k_pages.device
        return PagedKVCache(self.k_pages, self.v_pages,
                            torch.from_numpy(table).to(dev),
                            torch.from_numpy(lens).to(dev),
                            self.page_tokens, self.free)


def init_paged_cache(cfg: ModelConfig, *, batch: int, n_pages: int,
                     page_tokens: int = 64, max_seq: int = 32768,
                     device="cuda") -> PagedKVCache:
    """Zero pages for every attention layer; page 0 is the null page
    (never allocated: tables pad with it)."""
    device = resolve_device(device)
    La = cfg.attention_layers
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    max_pages = (max_seq + page_tokens - 1) // page_tokens
    shape = (La, n_pages, page_tokens, KV, Dh)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=DTYPE, device=device),
        v_pages=torch.zeros(shape, dtype=DTYPE, device=device),
        block_table=torch.zeros((batch, max_pages), dtype=torch.int32,
                                device=device),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
        page_tokens=page_tokens,
        free=list(range(n_pages - 1, 0, -1)),  # page 0 = null page
    )


def _tables(cache: PagedKVCache):
    """Host copies of the block table and lengths."""
    return (cache.block_table.cpu().numpy().copy(),
            cache.seq_lens.cpu().numpy().copy())


def alloc_pages(cache: PagedKVCache, n: int) -> list[int]:
    if len(cache.free) < n:
        raise MemoryError(f"paged cache OOM: want {n}, free {len(cache.free)}")
    return [cache.free.pop() for _ in range(n)]


def free_seq(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Release all pages of a batch slot back to the free list."""
    table, lens = _tables(cache)
    n_used = int(np.ceil(lens[slot] / cache.page_tokens))
    cache.free.extend(int(p) for p in table[slot, :n_used] if p != 0)
    table[slot] = 0
    lens[slot] = 0
    return cache._with(table, lens)


def assign_seq(cache: PagedKVCache, slot: int, n_tokens: int) -> PagedKVCache:
    """Allocate pages for a new sequence of ``n_tokens`` in ``slot``."""
    n = (n_tokens + cache.page_tokens - 1) // cache.page_tokens
    pages = alloc_pages(cache, n)
    table, lens = _tables(cache)
    table[slot, :n] = pages
    table[slot, n:] = 0
    lens[slot] = n_tokens
    return cache._with(table, lens)


def grow_seq(cache: PagedKVCache, slot: int, extra: int = 1) -> PagedKVCache:
    """Extend a sequence; allocates a fresh page at a page boundary."""
    table, lens = _tables(cache)
    old, new = int(lens[slot]), int(lens[slot]) + extra
    n_old = (old + cache.page_tokens - 1) // cache.page_tokens
    n_new = (new + cache.page_tokens - 1) // cache.page_tokens
    if n_new > n_old:
        table[slot, n_old:n_new] = alloc_pages(cache, n_new - n_old)
    lens[slot] = new
    return cache._with(table, lens)


def write_kv(cache: PagedKVCache, slot: int, start: int,
             k_new: torch.Tensor, v_new: torch.Tensor) -> PagedKVCache:
    """Write (L, S, KV, Dh) new KV of one sequence into its pages,
    starting at token offset ``start``, in place.

    A write that runs past the slot's assigned pages (page-table entry 0,
    the reserved null page) or past the table raises before any page is
    written: callers must ``assign_seq``/``grow_seq`` first."""
    pt = cache.page_tokens
    table = cache.block_table.cpu().numpy()
    S = k_new.shape[1]
    runs = []                    # (page id, offset, source slice)
    tok = start
    while tok < start + S:
        page_idx = tok // pt
        off = tok % pt
        n = min(pt - off, start + S - tok)   # stop at the page boundary
        if page_idx >= table.shape[1]:
            raise IndexError(
                f"write_kv overruns the block table: token {tok} needs page "
                f"index {page_idx} but the table holds {table.shape[1]} "
                f"pages per sequence (grow max_seq or shorten the write)")
        pid = int(table[slot, page_idx])
        if pid == 0:
            raise IndexError(
                f"write_kv into unassigned page: slot {slot} token {tok} "
                f"maps to table entry {page_idx} = 0 (the null page) — "
                f"assign_seq/grow_seq the sequence before writing")
        runs.append((pid, off, slice(tok - start, tok - start + n)))
        tok += n
    for pid, off, src in runs:
        n = src.stop - src.start
        cache.k_pages[:, pid, off:off + n] = k_new[:, src]
        cache.v_pages[:, pid, off:off + n] = v_new[:, src]
    return cache


def gather_kv(cache: PagedKVCache, max_tokens: int):
    """Per-sequence contiguous KV (L, B, max_tokens, KV, Dh) gathered from
    the pages through the block table (the plain paged read; the decode
    kernel fuses this gather with attention). A ``max_tokens`` that is
    not a multiple of ``page_tokens`` rounds up to whole pages and the
    surplus tail is sliced off."""
    pt = cache.page_tokens
    n = (max_tokens + pt - 1) // pt
    tbl = cache.block_table[:, :n].long()              # (B, n)
    k = cache.k_pages[:, tbl]                          # (L, B, n, pt, KV, Dh)
    v = cache.v_pages[:, tbl]
    L, B = k.shape[0], k.shape[1]
    k = k.reshape(L, B, n * pt, *k.shape[4:])[:, :, :max_tokens]
    v = v.reshape(L, B, n * pt, *v.shape[4:])[:, :, :max_tokens]
    return k, v


class DevicePagePool:
    """Refcounted paged KV store with a prefix registry (see module doc).

    A page is held by the hash-run registry and/or by block-table rows
    and staged prefill results; ``release`` at refcount 0 returns it to
    its bank's free list (below 0 raises: double-free guard).
    Registry-only runs (refcount 1) are evicted LRU under allocation
    pressure; runs a live slot references are pinned. ``make_writable``
    copies a shared page before a slot appends into it.
    """

    def __init__(self, cfg: ModelConfig, *, n_pages: int,
                 page_tokens: int = 64, device="cuda", mesh=None) -> None:
        if BLOCK_TOKENS % page_tokens:
            raise ValueError(
                f"page_tokens={page_tokens} must divide the pool block "
                f"({BLOCK_TOKENS} tokens) so a block maps to a page run")
        KV, Dh = cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.page_tokens = page_tokens
        self.mesh = mesh
        d = m = 1
        if mesh is None:
            devices = [[resolve_device(device)]]
        else:
            d = int(mesh.shape.get("data", 1))
            m = int(mesh.shape.get("model", 1))
            if KV % m:
                raise ValueError(
                    f"{KV} kv heads do not stripe over model={m} shards")
            devices = [[resolve_device(mesh.devices[b, mi])
                        for mi in range(m)] for b in range(d)]
        self.device = devices[0][0]
        self.n_banks = d
        self.n_model = m
        self.bank_pages = n_pages       # per-bank budget incl. its null page
        shape = (cfg.n_layers, n_pages, page_tokens, KV // m, Dh)
        #: [bank][model position] -> (k slab, v slab) on that position's
        #: device, KV/m heads each, in head order
        self.slabs = [[(torch.zeros(shape, dtype=DTYPE, device=dev),
                        torch.zeros(shape, dtype=DTYPE, device=dev))
                       for dev in row] for row in devices]
        if mesh is None:
            self.k_pages, self.v_pages = self.slabs[0][0]
        # reentrant: alloc -> eviction -> unregister -> release re-enters
        self._lock = threading.RLock()
        self._bank_free: list[list[int]] = [           #: guarded_by self._lock
            list(range((b + 1) * n_pages - 1, b * n_pages, -1))
            for b in range(d)]
        self.free: list[int] = self._bank_free[0]   #: guarded_by self._lock
        total = d * n_pages
        self.refs = np.zeros(total, np.int32)   #: guarded_by self._lock
        self.gens = np.zeros(total, np.int64)   #: guarded_by self._lock
        self._bank_runs: list[dict[int, list[int]]] = [  #: guarded_by self._lock
            {} for _ in range(d)]
        self._bank_lru: list[list[int]] = [     #: guarded_by self._lock
            [] for _ in range(d)]
        self.runs: dict[int, list[int]] = self._bank_runs[0]  #: guarded_by self._lock
        self._lru: list[int] = self._bank_lru[0]  #: guarded_by self._lock
        #: guarded_by self._lock
        self.counters = dict(pages_written=0, shared_adoptions=0,
                             cow_copies=0, registry_evictions=0,
                             alloc_failures=0, pages_exported=0,
                             pages_imported=0, bytes_written=0)

    # ---- geometry ------------------------------------------------------
    @property
    def n_pages(self) -> int:
        """GLOBAL page count across every bank (``n_banks·bank_pages``)."""
        return self.n_banks * self.bank_pages

    def bank_of(self, page: int) -> int:
        """Data-shard bank a global page id lives on."""
        return page // self.bank_pages

    @property
    def pages_per_block(self) -> int:
        return BLOCK_TOKENS // self.page_tokens

    def pages_for(self, n_tokens: int) -> int:
        return (n_tokens + self.page_tokens - 1) // self.page_tokens

    @property
    def used_pages(self) -> int:
        with self._lock:
            return int((self.refs > 0).sum())

    @property
    def free_pages(self) -> int:
        """Mesh-wide LOGICAL free pages (sum over banks)."""
        with self._lock:
            return sum(len(f) for f in self._bank_free)

    @property
    def occupancy(self) -> float:
        """Fraction of usable pages (null pages excluded) currently held."""
        cap = self.n_pages - self.n_banks
        return self.used_pages / cap if cap else 1.0

    def pressure(self) -> dict:
        """Occupancy snapshot for admission backpressure, mesh-wide and
        LOGICAL (a page counted once however its bytes stripe, capacity
        summed over the banks). ``pinned`` pages (held by a live slot or
        staged result) are the signal: registry-only runs evict on
        demand, so high occupancy with low ``pinned_frac`` is a warm
        cache, not pressure."""
        with self._lock:
            cap = self.n_pages - self.n_banks
            evictable = sum(len(self._bank_runs[b][h])
                            for b in range(self.n_banks)
                            for h in self._evictable_locked(b))
            used = int((self.refs > 0).sum())
            pinned = used - evictable
            return dict(
                capacity=cap, free=sum(len(f) for f in self._bank_free),
                used=used, evictable=evictable, pinned=pinned,
                occupancy=used / cap if cap else 1.0,
                pinned_frac=pinned / cap if cap else 1.0)

    # ---- refcounted allocation ----------------------------------------
    def _evictable_locked(self, bank: int = 0) -> list[int]:
        """One bank's registered block hashes held ONLY by the registry,
        LRU first. Caller holds ``self._lock``."""
        return [h for h in self._bank_lru[bank]
                if all(self.refs[p] == 1 for p in self._bank_runs[bank][h])]

    def alloc(self, n: int, bank: int = 0) -> list[int]:
        """Take ``n`` fresh pages from one bank (refcount 1 each),
        evicting that bank's registry-only runs LRU when its free list
        runs short. Raises ``MemoryError`` (taking nothing) if pressure
        can't be relieved. Returned ids are GLOBAL."""
        with self._lock:
            free = self._bank_free[bank]
            if len(free) < n:
                for h in self._evictable_locked(bank):
                    self.unregister(h, bank=bank)
                    if len(free) >= n:
                        break
            if len(free) < n:
                self.counters["alloc_failures"] += 1
                raise MemoryError(
                    f"device page pool OOM: want {n} pages, "
                    f"free {len(free)} of {self.bank_pages - 1} "
                    f"in bank {bank}")
            pages = [free.pop() for _ in range(n)]
            for p in pages:
                self.refs[p] = 1
                self.gens[p] += 1
            return pages

    def best_stage_bank(self, hash_ids: list[int]) -> int:
        """Bank a fresh staging run should target: the deepest registered
        prefix of this chain wins (maximises zero-copy adoption), free
        pages break ties (spreads load over the data shards)."""
        if self.n_banks == 1:
            return 0
        with self._lock:
            best, best_key = 0, None
            for b in range(self.n_banks):
                key = (self.lookup_chain(hash_ids, bank=b),
                       len(self._bank_free[b]), -b)
                if best_key is None or key > best_key:
                    best, best_key = b, key
            return best

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
                    self._bank_free[self.bank_of(p)].append(p)

    # ---- block-hash registry (cross-slot prefix sharing) ---------------
    def register_block(self, hash_id: int, pages: list[int]) -> None:
        """Publish a full block's page run for later chains to adopt. The
        registry holds one reference of its own. The run's bank is its
        pages' (sharing never crosses banks: the same prefix may register
        independently per bank)."""
        assert len(pages) == self.pages_per_block
        bank = self.bank_of(pages[0])
        assert all(self.bank_of(p) == bank for p in pages), \
            f"page run straddles banks: {pages}"
        with self._lock:
            if hash_id in self._bank_runs[bank]:  # racing identical prefills
                return
            self.retain(pages)
            self._bank_runs[bank][hash_id] = list(pages)
            self._bank_lru[bank].append(hash_id)

    def unregister(self, hash_id: int, bank: Optional[int] = None) -> None:
        """Evict a registered run — from one bank, or (``bank=None``)
        from every bank holding an independent copy of it."""
        banks = range(self.n_banks) if bank is None else (bank,)
        with self._lock:
            for b in banks:
                pages = self._bank_runs[b].pop(hash_id, None)
                if pages is None:
                    continue
                self._bank_lru[b].remove(hash_id)
                self.release(pages)
                self.counters["registry_evictions"] += 1

    def lookup_chain(self, hash_ids: list[int], bank: int = 0) -> int:
        """Deepest consecutive registered prefix in one bank (no side
        effects)."""
        with self._lock:
            runs = self._bank_runs[bank]
            n = 0
            for h in hash_ids:
                if h not in runs:
                    break
                n += 1
            return n

    def adopt_chain(self, hash_ids: list[int],
                    bank: int = 0) -> tuple[int, list[int]]:
        """Retain + return the page runs of the chain's registered prefix
        in one bank: (n_blocks_adopted, flat page ids). The caller owns
        one reference per page; the physical pages are SHARED with every
        adopter of that bank."""
        with self._lock:
            n = self.lookup_chain(hash_ids, bank=bank)
            runs, lru = self._bank_runs[bank], self._bank_lru[bank]
            pages: list[int] = []
            for h in hash_ids[:n]:
                run = runs[h]
                self.retain(run)
                pages.extend(run)
                lru.remove(h)               # touch recency
                lru.append(h)
            if n:
                self.counters["shared_adoptions"] += n
            return n, pages

    # ---- device writes -------------------------------------------------
    def _by_bank(self, pages: list[int]) -> list:
        """(bank, positions in the run, bank-local ids) for each bank a
        run touches; positions None when the run lies in one bank."""
        banks = {self.bank_of(p) for p in pages}
        if len(banks) == 1:
            (b,) = banks
            return [(b, None, [p - b * self.bank_pages for p in pages])]
        return [(b, [i for i, p in enumerate(pages) if self.bank_of(p) == b],
                 [p - b * self.bank_pages for p in pages
                  if self.bank_of(p) == b]) for b in sorted(banks)]

    def write_run(self, pages: list[int], k: torch.Tensor,
                  v: torch.Tensor) -> None:
        """Scatter (L, T, KV, Dh) KV (host or device) into ``pages``
        (T ≤ len(pages)·page) with one indexed copy per slab, each model
        stripe's heads into its own slab; a partial tail page is
        zero-padded (fresh pages, nothing to preserve)."""
        pt = self.page_tokens
        L, T = k.shape[0], k.shape[1]
        n = len(pages)
        assert T <= n * pt, (T, n, pt)
        pad = n * pt - T
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        moved = k.numel() * k.element_size() + v.numel() * v.element_size()
        k = k.to(self.device, DTYPE)
        v = v.to(self.device, DTYPE)
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        shape = (L, n, pt) + tuple(k.shape[2:])
        k, v = k.reshape(shape), v.reshape(shape)
        kv_loc = k.shape[3] // self.n_model
        with self._lock:
            for b, pos, local in self._by_bank(pages):
                kb, vb = (k, v) if pos is None else (k[:, pos], v[:, pos])
                for mi, (ks, vs) in enumerate(self.slabs[b]):
                    heads = slice(mi * kv_loc, (mi + 1) * kv_loc)
                    idx = torch.tensor(local, dtype=torch.long,
                                       device=ks.device)
                    ks[:, idx] = kb[:, :, :, heads].to(ks.device)
                    vs[:, idx] = vb[:, :, :, heads].to(vs.device)
            self.counters["pages_written"] += n
            self.counters["bytes_written"] += moved

    def make_writable(self, page: int) -> int:
        """Copy-on-write: a page id safe to append into. A single-owner
        page is returned as-is; a shared one is copied, every stripe, to
        a fresh page IN THE SAME BANK (a slot's pages stay on its data
        shard; the caller points its table at the new id; its reference
        to the old one is dropped here)."""
        with self._lock:
            if self.refs[page] == 1:
                return page
            b = self.bank_of(page)
            (new,) = self.alloc(1, bank=b)
            src, dst = page % self.bank_pages, new % self.bank_pages
            for ks, vs in self.slabs[b]:
                ks[:, dst] = ks[:, src]
                vs[:, dst] = vs[:, src]
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
                   n_tokens: int, bank: int = 0) -> list[int]:
        """Promote host KV back into a fresh page run in one bank (the
        inverse of ``export_run``; the registry is NOT touched —
        ``stage_run`` re-shares full blocks). Raises ``MemoryError``
        holding nothing."""
        pages = self.alloc(self.pages_for(n_tokens), bank=bank)
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
        host tensors (copies), every model stripe's heads in head order —
        the bytes an unbanked pool would give."""
        parts = []
        for b, pos, local in self._by_bank(pages):
            kv = []
            for ks, vs in self.slabs[b]:
                idx = torch.tensor(local, dtype=torch.long, device=ks.device)
                kv.append((ks[:, idx].cpu(), vs[:, idx].cpu()))
            parts.append((pos, torch.cat([a for a, _ in kv], dim=3),
                          torch.cat([c for _, c in kv], dim=3)))
        if len(parts) == 1:
            _, k, v = parts[0]              # (L, n, pt, KV, Dh), a copy
        else:
            L, _, pt, KV, Dh = parts[0][1].shape
            k = torch.empty((L, len(pages), pt, KV, Dh), dtype=DTYPE)
            v = torch.empty_like(k)
            for pos, kb, vb in parts:
                k[:, pos], v[:, pos] = kb, vb
        L = k.shape[0]
        k = k.reshape(L, -1, *k.shape[3:])[:, :n_tokens]
        v = v.reshape(L, -1, *v.shape[3:])[:, :n_tokens]
        return k, v

    def stats(self) -> dict:
        """Lifetime counters + the ``pressure()`` occupancy gauges."""
        with self._lock:
            out = dict(self.counters)
            out.update(self.pressure())
            return out

    def check_leaks(self) -> None:
        """Invariant: every non-free page is referenced and vice versa,
        per bank; each bank's null page is never allocated."""
        with self._lock:
            n_free = 0
            free: set[int] = set()
            for b, bank_free in enumerate(self._bank_free):
                n_free += len(bank_free)
                free |= set(bank_free)
                assert all(self.bank_of(p) == b for p in bank_free), \
                    f"bank {b} free list holds foreign pages"
            for p in range(self.n_pages):
                if p % self.bank_pages == 0:    # a bank's null page
                    assert p not in free and self.refs[p] == 0, \
                        f"null page {p} entered circulation"
                elif p in free:
                    assert self.refs[p] == 0, \
                        f"freed page {p} still referenced"
                else:
                    assert self.refs[p] > 0, \
                        f"page {p} leaked (no ref, not free)"
            assert len(free) == n_free, "free list duplicates"
