"""GlobalBlockDirectory — the cluster-wide KVCache pool's metadata plane
(the port's own copy of the reference's ``core/directory.py``).

The paper's Figure-3 pool spans the DRAM and SSD of *every* node, but a
per-instance ``TieredCachePool``/``SSDBlockStore`` keeps each node's
tiers private: a block demoted on node A is invisible to a request
routed to node B, forcing exactly the recompute the KVCache-centric
architecture exists to avoid. This directory is the missing piece — a
Conductor-side registry of which nodes hold which block in which tier, so
prefill routing can propose a fourth arm (fetch a prefix off a *peer's*
SSD, priced as SSD read + network hop) and the serving engine can resolve
a local miss to a remote store.

The directory is deliberately *advisory*: it answers "who probably holds
this block", never "these bytes are valid". Every consumer re-verifies at
fetch time (per-layer CRCs on store reads; residency re-checks on DRAM
reads) and degrades to recompute when the directory turns out stale —
wrong bytes are impossible by construction, wasted fetches merely cost
the latency the cost model charged anyway.

Invariants (asserted by the property tests of
``tests/test_global_pool.py`` and ``tests/test_torch_tiers.py``):

  * at most ONE registration per (node, key) — re-registering updates the
    tier in place, it never duplicates an owner;
  * ``unregister``/``drop_node`` leave no dangling owners: a lookup never
    returns a node that dropped the block;
  * a bound pool's directory view equals its actual residency after any
    interleaving of insert/lookup(promote)/demote/discard.

``bind(node, pool)`` wires a ``TieredCachePool``'s tier-event hooks
(chaining with any hooks a byte-holder like ``HostKVPool`` installed
first) and seeds the pool's current residency, so simulator instances and
serving pools publish moves automatically. All methods are thread-safe:
the engine's prefetch thread may read while the serve loop writes.
"""
from __future__ import annotations

import threading
from typing import Iterable, Optional

TIERS = ("dram", "ssd")


def select_owner(cands):
    """Pick the (node, tier) to fetch from, or None. DRAM owners are
    preferred (a peer-DRAM read skips the SSD media time); ties break on
    the smallest node id for determinism. Shared by the in-process
    directory and the wire-protocol ``RemoteDirectory`` so both halves
    of the cluster agree on owner choice."""
    cands = list(cands)
    if not cands:
        return None
    return min(cands, key=lambda nt: (nt[1] != "dram", nt[0]))


def bind_pool(directory, node, pool) -> None:
    """Publish a ``TieredCachePool``'s residency into ``directory``:
    seed the current state, then chain the tier-event hooks (preserving
    hooks a byte-holder installed first) so every future move is
    mirrored. ``directory`` only needs ``register``/``unregister`` —
    works for both the shared-object and remote-client directories."""
    for key in pool.blocks:
        directory.register(key, node, "dram")
    for key in pool.ssd.blocks:
        directory.register(key, node, "ssd")
    prev_insert = pool.on_insert
    prev_demote = pool.on_demote
    prev_promote = pool.on_promote
    prev_drop = pool.on_drop

    def on_insert(key, tier):
        if prev_insert is not None:
            prev_insert(key, tier)
        directory.register(key, node, tier)

    def on_demote(key):
        if prev_demote is not None:
            prev_demote(key)
        directory.register(key, node, "ssd")

    def on_promote(key, count_read):
        if prev_promote is not None:
            prev_promote(key, count_read)
        directory.register(key, node, "dram")

    def on_drop(key):
        if prev_drop is not None:
            prev_drop(key)
        directory.unregister(key, node)

    pool.on_insert = on_insert
    pool.on_demote = on_demote
    pool.on_promote = on_promote
    pool.on_drop = on_drop


class GlobalBlockDirectory:
    """Block key -> {node: tier} ownership map for one serving cluster."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._owners: dict[int, dict] = {}  #: guarded_by self._lock
        self.n_registers = 0                #: guarded_by self._lock
        self.n_unregisters = 0              #: guarded_by self._lock

    # ---- writes --------------------------------------------------------
    def register(self, key: int, node, tier: str) -> None:
        """Record that ``node`` holds ``key`` in ``tier``. Idempotent per
        (node, key): a re-register moves the tier, never adds an owner."""
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; tiers: {list(TIERS)}")
        with self._lock:
            self._owners.setdefault(key, {})[node] = tier
            self.n_registers += 1

    def unregister(self, key: int, node) -> bool:
        """Drop ``node``'s claim on ``key`` (no-op if absent)."""
        with self._lock:
            holders = self._owners.get(key)
            if holders is None or node not in holders:
                return False
            del holders[node]
            if not holders:
                del self._owners[key]
            self.n_unregisters += 1
            return True

    def drop_node(self, node) -> int:
        """Remove every claim of a departed node; returns claims dropped."""
        with self._lock:
            dead = [k for k, h in self._owners.items() if node in h]
            for k in dead:
                self.unregister(k, node)
            return len(dead)

    # ---- reads ---------------------------------------------------------
    def holders(self, key: int) -> dict:
        with self._lock:
            return dict(self._owners.get(key, {}))

    def nodes_with(self, key: int, tier: Optional[str] = None) -> list:
        """Nodes holding ``key`` (optionally restricted to one tier)."""
        with self._lock:
            h = self._owners.get(key, {})
            return sorted(n for n, t in h.items() if tier is None or t == tier)

    def pick_owner(self, key: int, exclude: Iterable = (),
                   among: Optional[Iterable] = None):
        """(node, tier) to fetch ``key`` from, or None. DRAM owners are
        preferred (a peer-DRAM read skips the SSD media time); ties break
        on the smallest node id for determinism."""
        exclude = set(exclude)
        among = None if among is None else set(among)
        with self._lock:
            cands = [(n, t) for n, t in self._owners.get(key, {}).items()
                     if n not in exclude and (among is None or n in among)]
        return select_owner(cands)

    def best_ssd_extension(self, hash_ids: list, start: int = 0,
                           exclude: Iterable = ()) -> tuple:
        """Longest contiguous run ``hash_ids[start:start+k]`` held on ONE
        peer node's SSD; returns (k, node) with k == 0 when no peer
        extends the chain. Single-source keeps the arm's transfer a single
        FIFO-pipe enqueue, mirroring ``peer_fetch_arm``."""
        if start >= len(hash_ids):
            return 0, None
        exclude = set(exclude)
        best_k, best_node = 0, None
        for node in self.nodes_with(hash_ids[start], tier="ssd"):
            if node in exclude:
                continue
            k = 0
            with self._lock:
                for h in hash_ids[start:]:
                    if self._owners.get(h, {}).get(node) != "ssd":
                        break
                    k += 1
            if k > best_k:
                best_k, best_node = k, node
        return best_k, best_node

    def __len__(self) -> int:
        with self._lock:
            return len(self._owners)

    def snapshot(self) -> dict:
        """Deep copy of the ownership map (test/debug aid)."""
        with self._lock:
            return {k: dict(h) for k, h in self._owners.items()}

    def stats(self) -> dict:
        with self._lock:
            n_ssd = sum(1 for h in self._owners.values()
                        for t in h.values() if t == "ssd")
            n_dram = sum(1 for h in self._owners.values()
                         for t in h.values() if t == "dram")
            return dict(keys=len(self._owners), dram_claims=n_dram,
                        ssd_claims=n_ssd, registers=self.n_registers,
                        unregisters=self.n_unregisters)

    # ---- pool binding --------------------------------------------------
    def bind(self, node, pool) -> None:
        """Publish a ``TieredCachePool``'s residency: seed the current
        state, then chain the tier-event hooks (preserving hooks a
        byte-holder installed first) so every future move is mirrored."""
        bind_pool(self, node, pool)
