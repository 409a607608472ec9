"""Host KVCache pool metadata (Figure 3) with LRU eviction — the port's
own copy of what the serving path uses of the reference's
``core/cache.py``: ``CachePool`` for KV blocks and ``StateCache`` for
SSM state checkpoints (the other Table 1 policies and pinning come with
the tiers that use them).

A *block* is 512 tokens of KVCache identified by a prefix-chained hash id
(the trace's ``hash_ids``). ``CachePool`` tracks block residency and
metadata only; ``serving.engine.HostKVPool`` holds the bytes.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable, Optional


class LRUPolicy:
    """Evict the least recently inserted or hit block."""

    def __init__(self) -> None:
        self._order: OrderedDict[int, None] = OrderedDict()

    def on_insert(self, key: int, meta: "BlockMeta") -> None:
        self._order[key] = None
        self._order.move_to_end(key)

    def on_hit(self, key: int, meta: "BlockMeta") -> None:
        if key in self._order:
            self._order.move_to_end(key)

    def on_evict(self, key: int) -> None:
        self._order.pop(key, None)

    def victim(self) -> Optional[int]:
        return next(iter(self._order), None)


@dataclass
class BlockMeta:
    key: int
    position: int = 0        # block index within its request (depth)
    hits: int = 0


class CachePool:
    """One instance's KVCache pool: residency set + eviction policy.

    ``capacity_blocks`` models the DRAM budget (∞ if None). ``lookup``
    returns the prefix hit length in *blocks* — the longest chain prefix of
    ``hash_ids`` fully resident here (prefix-chained hashes make any
    resident block imply its prefix was resident when written, but eviction
    can break chains, so we check explicitly).
    """

    def __init__(self, capacity_blocks: Optional[int] = None) -> None:
        self.capacity = capacity_blocks
        self.policy = LRUPolicy()
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

    def _make_room(self) -> tuple[list[int], bool]:
        """Evict victims until one slot is free; returns (evicted keys,
        whether a slot is available)."""
        evicted: list[int] = []
        while self.capacity is not None and len(self.blocks) >= self.capacity:
            v = self.policy.victim()
            if v is None:
                break
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
                break  # zero capacity: drop the insert
            meta = BlockMeta(key=h, position=start_pos + i)
            self.blocks[h] = meta
            self.policy.on_insert(h, meta)
        return evicted

    def _evict(self, key: int) -> None:
        self.blocks.pop(key, None)
        self.policy.on_evict(key)
        self.evictions += 1


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


def ssm_state_bytes(cfg) -> int:
    """Bytes of one SSM state checkpoint (fp32 state + bf16 conv tail)."""
    if cfg.ssm is None:
        return 0
    s = cfg.ssm
    return cfg.n_layers * (s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
                           + (s.d_conv - 1) * s.conv_channels(cfg.d_model) * 2)
