"""Host KVCache pool metadata (Figure 3) and eviction policies (Table 1)
— the port's own copy of the reference's ``core/cache.py``:
``CachePool`` for KV blocks (the DRAM tier, and the SSD tier inside
``core.tiered.TieredCachePool``), ``StateCache`` for SSM state
checkpoints, the LRU/LFU/LengthAware policies, and the block sizes.

A *block* is 512 tokens of KVCache identified by a prefix-chained hash id
(the trace's ``hash_ids``). ``CachePool`` tracks block residency and
metadata only; ``serving.engine.HostKVPool`` holds the bytes.
"""
from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable, Optional


class EvictionPolicy:
    """Interface: decide which resident block to evict."""
    name = "base"

    def on_insert(self, key: int, meta: "BlockMeta") -> None: ...
    def on_hit(self, key: int, meta: "BlockMeta") -> None: ...
    def on_evict(self, key: int) -> None: ...
    def victim(self) -> Optional[int]:
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    """Evict the least recently inserted or hit block."""
    name = "lru"

    def __init__(self) -> None:
        self._order: OrderedDict[int, None] = OrderedDict()

    def on_insert(self, key, meta):
        self._order[key] = None
        self._order.move_to_end(key)

    def on_hit(self, key, meta):
        if key in self._order:
            self._order.move_to_end(key)

    def on_evict(self, key):
        self._order.pop(key, None)

    def victim(self):
        return next(iter(self._order), None)


class _HeapPolicy(EvictionPolicy):
    """Lazy-deletion heap keyed by a (score, tiebreak) tuple; smallest first."""

    def __init__(self) -> None:
        self._heap: list[tuple] = []
        self._entry: dict[int, tuple] = {}
        self._counter = itertools.count()

    def _score(self, meta: "BlockMeta") -> tuple:
        raise NotImplementedError

    def _push(self, key: int, meta: "BlockMeta") -> None:
        entry = (*self._score(meta), next(self._counter), key)
        self._entry[key] = entry
        heapq.heappush(self._heap, entry)

    def on_insert(self, key, meta):
        self._push(key, meta)

    def on_hit(self, key, meta):
        if key in self._entry:
            self._push(key, meta)  # old entry becomes stale

    def on_evict(self, key):
        self._entry.pop(key, None)

    def victim(self):
        while self._heap:
            entry = self._heap[0]
            key = entry[-1]
            if self._entry.get(key) is entry:
                return key
            heapq.heappop(self._heap)  # stale
        return None


class LFUPolicy(_HeapPolicy):
    name = "lfu"

    def _score(self, meta):
        return (meta.hits,)


class LengthAwarePolicy(_HeapPolicy):
    """LFU, but among equal frequencies prefer evicting blocks that occur
    *later* in requests (deeper prefix position) — the paper's
    LengthAwareCache."""
    name = "length_aware"

    def _score(self, meta):
        return (meta.hits, -meta.position)


def make_policy(name: str) -> EvictionPolicy:
    policies = {"lru": LRUPolicy, "lfu": LFUPolicy,
                "length_aware": LengthAwarePolicy}
    try:
        return policies[name]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {name!r}; "
                         f"registered: {sorted(policies)}") from None


@dataclass
class BlockMeta:
    key: int
    position: int = 0        # block index within its request (depth)
    hits: int = 0
    pinned: int = 0          # in-flight transfers / active prefills
    size_bytes: int = 0


class CachePool:
    """One instance's KVCache pool: residency set + eviction policy.

    ``capacity_blocks`` models the DRAM budget (∞ if None). ``lookup``
    returns the prefix hit length in *blocks* — the longest chain prefix of
    ``hash_ids`` fully resident here (prefix-chained hashes make any
    resident block imply its prefix was resident when written, but eviction
    can break chains, so we check explicitly).
    """

    def __init__(self, capacity_blocks: Optional[int] = None,
                 policy: str = "lru", block_bytes: int = 0) -> None:
        self.capacity = capacity_blocks
        self.policy = make_policy(policy)
        self.block_bytes = block_bytes
        self.blocks: dict[int, BlockMeta] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self.blocks)

    def __contains__(self, key: int) -> bool:
        return key in self.blocks

    def prefix_len(self, hash_ids: list[int]) -> int:
        """Longest resident prefix, in blocks (no metadata side effects)."""
        n = 0
        for h in hash_ids:
            if h in self.blocks:
                n += 1
            else:
                break
        return n

    def lookup(self, hash_ids: list[int], touch: bool = True) -> int:
        """Prefix match + hit accounting (one hit/miss per block)."""
        n = self.prefix_len(hash_ids)
        if touch:
            for h in hash_ids[:n]:
                meta = self.blocks[h]
                meta.hits += 1
                self.policy.on_hit(h, meta)
            self.hits += n
            self.misses += len(hash_ids) - n
        return n

    def touch_keys(self, hash_ids: Iterable[int],
                   count_read: bool = True) -> int:
        """Hit-account an arbitrary set of resident keys (no prefix walk);
        the tiered subclass overrides this to also promote SSD keys."""
        n = 0
        for h in hash_ids:
            meta = self.blocks.get(h)
            if meta is None:
                continue
            meta.hits += 1
            self.policy.on_hit(h, meta)
            self.hits += 1
            n += 1
        return n

    def discard(self, key: int) -> bool:
        """Drop one block outright (no eviction accounting)."""
        return self.remove(key) is not None

    def _make_room(self) -> tuple[list[int], bool]:
        """Evict unpinned victims until one slot is free; returns
        (evicted keys, whether a slot is available)."""
        evicted: list[int] = []
        attempts = 0
        while self.capacity is not None and len(self.blocks) >= self.capacity:
            v = self.policy.victim()
            if v is None or attempts > len(self.blocks):
                break  # nothing evictable (all pinned)
            attempts += 1
            if self.blocks.get(v) is not None and self.blocks[v].pinned:
                # pinned victims are skipped by re-queueing as a hit
                self.policy.on_hit(v, self.blocks[v])
                continue
            self._evict(v)
            evicted.append(v)
        has_room = self.capacity is None or len(self.blocks) < self.capacity
        return evicted, has_room

    def insert(self, hash_ids: Iterable[int], start_pos: int = 0) -> list[int]:
        """Insert blocks (idempotent); returns evicted keys."""
        evicted: list[int] = []
        for i, h in enumerate(hash_ids):
            if h in self.blocks:
                continue
            dropped, has_room = self._make_room()
            evicted.extend(dropped)
            if not has_room:
                break  # everything pinned; drop the insert
            meta = BlockMeta(key=h, position=start_pos + i,
                             size_bytes=self.block_bytes)
            self.blocks[h] = meta
            self.policy.on_insert(h, meta)
        return evicted

    def insert_meta(self, meta: BlockMeta) -> tuple[list[int], bool]:
        """Insert one pre-existing ``BlockMeta`` preserving its hit count /
        pin count / position (tier moves). Returns (evicted keys, placed)."""
        if meta.key in self.blocks:
            return [], True
        evicted, has_room = self._make_room()
        if has_room:
            self.blocks[meta.key] = meta
            self.policy.on_insert(meta.key, meta)
        return evicted, has_room

    def remove(self, key: int) -> Optional[BlockMeta]:
        """Withdraw a block without counting an eviction (tier moves)."""
        meta = self.blocks.pop(key, None)
        if meta is not None:
            self.policy.on_evict(key)
        return meta

    def _evict(self, key: int) -> None:
        self.blocks.pop(key, None)
        self.policy.on_evict(key)
        self.evictions += 1

    def pin(self, hash_ids: Iterable[int]) -> None:
        for h in hash_ids:
            if h in self.blocks:
                self.blocks[h].pinned += 1

    def unpin(self, hash_ids: Iterable[int]) -> None:
        for h in hash_ids:
            if h in self.blocks:
                self.blocks[h].pinned = max(0, self.blocks[h].pinned - 1)

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


class StateCache(CachePool):
    """SSM prefix cache: one *state checkpoint* per block boundary instead
    of a KV slab. A hit on chain position k restores the recurrent state
    after 512·(k+1) tokens and skips that much prefill. Only the
    *deepest* hit matters (states subsume their prefixes), and a transfer
    is constant-size (``ssm_state_bytes``)."""

    def deepest_hit(self, hash_ids: list[int]) -> int:
        """Deepest resident checkpoint on this chain (0 = none).
        Unlike KV blocks, a checkpoint at depth k alone suffices."""
        best = 0
        for i, h in enumerate(hash_ids):
            if h in self.blocks:
                best = i + 1
        return best

    def lookup(self, hash_ids: list[int], touch: bool = True) -> int:
        best = self.deepest_hit(hash_ids)
        if touch and best:
            h = hash_ids[best - 1]
            meta = self.blocks[h]
            meta.hits += 1
            self.policy.on_hit(h, meta)
            self.hits += best
            self.misses += len(hash_ids) - best
        elif touch:
            self.misses += len(hash_ids)
        return best


def kv_block_bytes(cfg, block_tokens: int = 512) -> int:
    """Bytes of one 512-token KVCache block for a model config (bf16)."""
    return 2 * cfg.attention_layers * block_tokens * cfg.n_kv_heads \
        * cfg.head_dim * 2


def ssm_state_bytes(cfg) -> int:
    """Bytes of one SSM state checkpoint (fp32 state + bf16 conv tail)."""
    if cfg.ssm is None:
        return 0
    s = cfg.ssm
    return cfg.n_layers * (s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
                           + (s.d_conv - 1) * s.conv_channels(cfg.d_model) * 2)
