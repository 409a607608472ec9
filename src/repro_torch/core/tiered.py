"""Tiered DRAM+SSD KVCache store — the paper's "underutilized CPU, DRAM
and SSD resources" made concrete (§3, Figure 3). The port's own copy of
the reference's ``core/tiered.py``, unchanged in behaviour.

``CachePool`` models a single flat DRAM tier: evicted blocks are destroyed,
so long-context cold prefixes — the workload Mooncake wins hardest on — are
recomputed from scratch. ``TieredCachePool`` adds the next rung of the
hierarchy: DRAM evictions *demote* block metadata to a per-instance SSD
tier with its own capacity and eviction policy; SSD hits *promote* back to
DRAM. The Conductor can then choose, per request, between recomputing a
prefix, fetching it from a peer's DRAM, and loading it from local SSD —
the compute-vs-load decision of Jin et al. ("Compute Or Load KV Cache?
Why Not Both?") grafted onto Algorithm 1.

Like ``CachePool`` this tracks residency + metadata only; bytes live in the
serving engine (``HostKVPool`` keeps demoted blocks' bytes) or are modeled
by the simulator. Invariants maintained here and asserted by
``tests/test_tiered_cache.py`` (reference) and
``tests/test_torch_tiers.py`` (port):

  * a block is resident in at most ONE tier at any time;
  * neither tier ever exceeds its capacity;
  * pinned blocks are never evicted from either tier, and promotion /
    demotion carries the pin count with the block.

Write-back batching: demotions are staged and accounted as one SSD write
per ``writeback_batch`` blocks (sequential batched writes are how real
tiers avoid write-amplification); ``flush_writeback()`` forces a partial
batch out, e.g. at checkpoint boundaries.

Tier-event hooks: a byte-holder (``HostKVPool`` with a file-backed
``SSDBlockStore``) mirrors metadata moves by setting ``on_demote(key)``
/ ``on_promote(key, count_read)`` / ``on_drop(key)``. They fire exactly
when a block changes tier or leaves the hierarchy, with ``on_demote``
guaranteed to run while the caller still holds the DRAM bytes — so the
hook can stage the write-back — and ``on_drop`` when the bytes may be
freed. ``on_insert(key, tier)`` fires when a FRESH block enters the
hierarchy (normally DRAM; "ssd" on the pinned-full straight-to-SSD path)
so a ``GlobalBlockDirectory`` can track DRAM residency too. All default
to ``None`` (the simulator's metadata-only use).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from repro_torch.core.cache import BlockMeta, CachePool


@dataclass(frozen=True)
class TierPrefix:
    """Longest contiguous resident prefix across the hierarchy.

    ``total`` counts blocks resident in *either* tier (the chain may
    interleave, e.g. D,S,D); ``dram``/``ssd`` split that prefix by tier.
    Note ``dram`` can exceed the DRAM-only ``prefix_len`` — e.g. chain
    [S, D] has ``prefix_len() == 0`` but ``TierPrefix(2, 1, 1)``.
    """
    total: int
    dram: int
    ssd: int


class TieredCachePool(CachePool):
    """Two-tier block store: DRAM (primary, inherited) + SSD (demotion).

    The inherited ``CachePool`` state IS the DRAM tier — ``prefix_len``,
    ``__len__`` and the eviction counters keep their DRAM-only meaning, so
    a ``TieredCachePool`` drops into every ``CachePool`` slot (Conductor,
    simulator, ``HostKVPool``) unchanged. ``__contains__`` answers for the
    whole hierarchy. ``insert``/``lookup`` return values keep base
    semantics except that ``insert``'s evicted list contains only blocks
    dropped from the hierarchy entirely (callers holding bytes may free
    exactly those).
    """

    def __init__(self, capacity_blocks: Optional[int] = None,
                 ssd_capacity_blocks: Optional[int] = 0,
                 policy: str = "lru", ssd_policy: str = "lru",
                 block_bytes: int = 0, writeback_batch: int = 1) -> None:
        super().__init__(capacity_blocks, policy, block_bytes)
        self.ssd = CachePool(ssd_capacity_blocks, ssd_policy, block_bytes)
        self.writeback_batch = max(int(writeback_batch), 1)
        # tier-traffic accounting
        self.demotions = 0          # DRAM → SSD moves
        self.promotions = 0         # SSD → DRAM moves
        self.dram_hits = 0
        self.ssd_hits = 0
        self.ssd_blocks_written = 0
        self.ssd_blocks_read = 0
        self.n_writebacks = 0       # batched SSD write operations issued
        self._wb_pending = 0        # demoted blocks awaiting a batch flush
        self._dropped: list[int] = []   # keys that left the hierarchy
        # tier-event hooks (see module docstring); None = metadata-only
        self.on_demote = None       # fn(key) — DRAM bytes still readable
        self.on_promote = None      # fn(key, count_read)
        self.on_drop = None         # fn(key) — bytes may be freed
        self.on_insert = None       # fn(key, tier) — fresh block entered

    # ---- residency ----------------------------------------------------
    def __contains__(self, key: int) -> bool:
        return key in self.blocks or key in self.ssd.blocks

    def resident_tier(self, key: int) -> Optional[str]:
        if key in self.blocks:
            return "dram"
        if key in self.ssd.blocks:
            return "ssd"
        return None

    @property
    def total_blocks(self) -> int:
        return len(self.blocks) + len(self.ssd.blocks)

    def tier_prefix(self, hash_ids: list[int]) -> TierPrefix:
        """Longest resident prefix across both tiers (no side effects)."""
        total = dram = ssd = 0
        for h in hash_ids:
            if h in self.blocks:
                dram += 1
            elif h in self.ssd.blocks:
                ssd += 1
            else:
                break
            total += 1
        return TierPrefix(total, dram, ssd)

    # ---- demotion / promotion -----------------------------------------
    def _drop(self, keys: Iterable[int]) -> None:
        """Blocks leaving the hierarchy: record + notify the byte-holder."""
        for k in keys:
            self._dropped.append(k)
            if self.on_drop is not None:
                self.on_drop(k)

    def _evict(self, key: int) -> None:
        """DRAM eviction = demotion (metadata moves; SSD does the drop)."""
        meta = self.blocks.pop(key, None)
        self.policy.on_evict(key)
        self.evictions += 1
        if meta is None:
            return
        if self.ssd.capacity == 0:
            self._drop([key])
            return  # no SSD tier configured — behave like the flat pool
        ssd_evicted, placed = self.ssd.insert_meta(meta)
        self._drop(ssd_evicted)             # end of the hierarchy
        if placed:
            self.demotions += 1
            self._account_ssd_write()
            if self.on_demote is not None:
                self.on_demote(key)
        else:
            self._drop([key])               # SSD full of pinned blocks

    def _account_ssd_write(self) -> None:
        """Every block written to SSD joins the current write-back batch."""
        self.ssd_blocks_written += 1
        self._wb_pending += 1
        if self._wb_pending >= self.writeback_batch:
            self.n_writebacks += 1
            self._wb_pending = 0

    def flush_writeback(self) -> int:
        """Force a partial write-back batch out; returns blocks flushed."""
        n, self._wb_pending = self._wb_pending, 0
        if n:
            self.n_writebacks += 1
        return n

    def _promote(self, key: int, count_read: bool = True) -> bool:
        """SSD → DRAM move (metadata, including pin count, travels).

        ``count_read=False`` for blocks re-inserted from above (recomputed
        or migrated in): they get rewritten in DRAM, not read off SSD, so
        they must not inflate the SSD read-traffic counter."""
        meta = self.ssd.remove(key)
        if meta is None:
            return False
        if count_read:
            self.ssd_blocks_read += 1
        # making DRAM room may itself demote victims back into the SSD
        # tier — that's the hierarchy working, not recursion: _promote is
        # only entered on an SSD hit.
        _, placed = self.insert_meta(meta)
        if placed:
            self.promotions += 1
            if self.on_promote is not None:
                self.on_promote(key, count_read)
            return True
        # DRAM entirely pinned: put the block back where it was
        ssd_evicted, _ = self.ssd.insert_meta(meta)
        self._drop(ssd_evicted)
        return False

    # ---- CachePool interface ------------------------------------------
    def lookup(self, hash_ids: list[int], touch: bool = True) -> int:
        """Prefix match across the hierarchy; SSD hits promote to DRAM."""
        if not touch:
            return self.tier_prefix(hash_ids).total
        n = 0
        for h in hash_ids:
            if h in self.blocks:
                meta = self.blocks[h]
                meta.hits += 1
                self.policy.on_hit(h, meta)
                self.dram_hits += 1
            elif h in self.ssd.blocks:
                # count the hit even if promotion fails (pinned-full DRAM);
                # the block is still readable from SSD
                self.ssd.blocks[h].hits += 1
                self._promote(h)
                self.ssd_hits += 1
            else:
                break
            n += 1
        self.hits += n
        self.misses += len(hash_ids) - n
        return n

    def insert(self, hash_ids: Iterable[int], start_pos: int = 0) -> list[int]:
        """Insert into DRAM (SSD-resident duplicates are promoted instead);
        returns keys dropped from the WHOLE hierarchy since the last insert
        (lookup-time promotions can drop SSD victims too — callers holding
        bytes free exactly the returned keys)."""
        for i, h in enumerate(hash_ids):
            if h in self.blocks:
                continue
            if h in self.ssd.blocks:
                self._promote(h, count_read=False)
                continue
            _, has_room = self._make_room()   # overflow demotes via _evict
            if not has_room:
                # DRAM all pinned — try writing the fresh block straight to
                # the SSD tier rather than losing it
                meta = BlockMeta(key=h, position=start_pos + i,
                                 size_bytes=self.block_bytes)
                if self.ssd.capacity != 0:
                    ssd_evicted, placed = self.ssd.insert_meta(meta)
                    self._drop(ssd_evicted)
                    if placed:
                        self._account_ssd_write()
                        if self.on_insert is not None:
                            self.on_insert(h, "ssd")
                        continue
                break
            meta = BlockMeta(key=h, position=start_pos + i,
                             size_bytes=self.block_bytes)
            self.blocks[h] = meta
            self.policy.on_insert(h, meta)
            if self.on_insert is not None:
                self.on_insert(h, "dram")
        dropped, self._dropped = self._dropped, []
        return dropped

    def touch_keys(self, hash_ids: Iterable[int],
                   count_read: bool = True) -> int:
        """Hit-account an arbitrary VERIFIED set of resident keys (no
        prefix semantics): DRAM keys are touched, SSD keys promoted.
        Unlike ``lookup`` this never walks past the given keys, so the
        serving engine can commit a loaded tail segment without touching
        the head blocks it chose to recompute instead. Returns the number
        of keys found resident."""
        n = 0
        for h in hash_ids:
            if h in self.blocks:
                meta = self.blocks[h]
                meta.hits += 1
                self.policy.on_hit(h, meta)
                self.dram_hits += 1
            elif h in self.ssd.blocks:
                self.ssd.blocks[h].hits += 1
                self._promote(h, count_read=count_read)
                self.ssd_hits += 1
            else:
                continue
            n += 1
            self.hits += 1
        return n

    def discard(self, key: int) -> bool:
        """Drop a block from whichever tier holds it (e.g. a block whose
        on-disk bytes failed their checksum — the metadata must never
        claim residency the store can't honour)."""
        meta = self.remove(key)
        if meta is None:
            meta = self.ssd.remove(key)
        if meta is None:
            return False
        self._drop([key])
        return True

    def pin(self, hash_ids: Iterable[int]) -> None:
        for h in hash_ids:
            if h in self.blocks:
                self.blocks[h].pinned += 1
            elif h in self.ssd.blocks:
                self.ssd.blocks[h].pinned += 1

    def unpin(self, hash_ids: Iterable[int]) -> None:
        for h in hash_ids:
            meta = self.blocks.get(h) or self.ssd.blocks.get(h)
            if meta is not None:
                meta.pinned = max(0, meta.pinned - 1)

    # ---- reporting -----------------------------------------------------
    def tier_stats(self) -> dict:
        return dict(dram_blocks=len(self.blocks),
                    ssd_blocks=len(self.ssd.blocks),
                    dram_hits=self.dram_hits, ssd_hits=self.ssd_hits,
                    misses=self.misses, hit_rate=self.hit_rate,
                    demotions=self.demotions, promotions=self.promotions,
                    ssd_evictions=self.ssd.evictions,
                    ssd_blocks_written=self.ssd_blocks_written,
                    ssd_blocks_read=self.ssd_blocks_read,
                    n_writebacks=self.n_writebacks)
