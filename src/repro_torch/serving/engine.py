"""Serving engines of the port — the counterpart of the reference's
``repro/serving/engine.py``.

The §3 workflow on the GPU: a host KVCache pool holding 512-token blocks
keyed by prefix-chained hashes in a DRAM tier over an optional SSD tier
(``HostKVPool``; the SSD tier's bytes live in a checksummed file store,
``serving/ssd_store.py``), a prefill worker that reuses pool blocks and
runs chunked incremental prefill (``PrefillWorker``/``ChunkedPrefill``;
with ``ssd_mode="overlap"`` it recomputes a prefix's head while its tail
streams off disk or off a peer's store layer by layer) and stores fresh
blocks back to the pool, ``stage_run`` copying a prompt's KV into the
shared ``DevicePagePool``, and a continuous-batching decode worker whose
slots sit at independent depths (``DecodeWorker``, paged or dense
substrate). Pools joined through a ``GlobalBlockDirectory`` and
``connect_pools`` fetch each other's blocks in process (``PeerSource``
over ``transport.InProcPeer``), or across processes over the wire
(``transport.SocketPeer``, which returns the same host tensors). For SSM
models prefix caching takes its other form: recurrent-state checkpoints
at block boundaries (``StateCheckpointWorker``); the KV workers refuse
SSM models.

Host KV bytes and state checkpoints are CPU tensors; device work runs on
the device the parameters live on; a ``DecodeWorker`` over a banked
``DevicePagePool(mesh=...)`` runs its paged step on every position of a
(data, model) mesh (``decode_step_paged_sharded``).
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import CacheTierSpec, ModelConfig
from repro_torch.core.cache import BlockMeta, CachePool, StateCache
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.launch.mesh import replicate_params
from repro_torch.models import layers
from repro_torch.models.mamba import MambaState
from repro_torch.models.transformer import (Caches, decode_step,
                                            decode_step_paged,
                                            decode_step_paged_sharded,
                                            init_caches, paged_shard_reason,
                                            prefill)
from repro_torch.serving.decode_graphs import CudaCapture, DecodeGraphs
from repro_torch.serving.layerwise import overlap_split
from repro_torch.serving import spans
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest
from repro_torch.serving.ssd_store import (AsyncPrefetcher, PrefetchHandle,
                                           SSDBlockStore)
from repro_torch.serving.transport import (InProcPeer, PeerError,
                                           fallback_reason)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def prefix_hash_ids(tokens: np.ndarray, block: int = BLOCK_TOKENS) -> list[int]:
    """Chained block hashes of a token sequence (Figure 3): block i's key
    commits to all tokens ≤ its end, so equal ids ⇔ equal prefixes."""
    out: list[int] = []
    h = hashlib.sha256()
    for i in range(len(tokens) // block):
        h.update(np.ascontiguousarray(tokens[i * block:(i + 1) * block]).tobytes())
        out.append(int.from_bytes(h.copy().digest()[:8], "little"))
    return out


class PrefixHasher:
    """Incremental chained block hasher with a per-session memo: a
    revisit verifies the memoised prefix with one array compare and
    SHA-hashes only the suffix blocks. Ids always equal
    ``prefix_hash_ids``."""

    def __init__(self, block: int = BLOCK_TOKENS,
                 capacity_sessions: int = 256) -> None:
        self.block = block
        self.capacity = capacity_sessions
        # session -> (committed tokens, ids, sha256 state after deepest
        # block), LRU-bounded: each entry pins O(prompt) host tokens
        self._memo: OrderedDict = OrderedDict()
        self.blocks_hashed = 0
        self.memo_hits = 0

    def hash_ids(self, tokens: np.ndarray, session=None) -> list[int]:
        block = self.block
        n_full = len(tokens) // block
        out: list[int] = []
        h = hashlib.sha256()
        start = 0
        if session is not None:
            m = self._memo.get(session)
            if m is not None:
                mtok, mids, mh = m
                d = len(mids)
                if d <= n_full and np.array_equal(
                        np.asarray(tokens[:d * block]), mtok):
                    out = list(mids)
                    h = mh.copy()
                    start = d
                    self.memo_hits += 1
        for i in range(start, n_full):
            h.update(np.ascontiguousarray(
                tokens[i * block:(i + 1) * block]).tobytes())
            out.append(int.from_bytes(h.copy().digest()[:8], "little"))
        self.blocks_hashed += n_full - start
        if session is not None and n_full:
            self._memo[session] = (
                np.asarray(tokens[:n_full * block]).copy(), list(out), h)
            self._memo.move_to_end(session)
            while len(self._memo) > self.capacity:
                self._memo.popitem(last=False)
        return out


@dataclass
class FetchPlan:
    """Side-effect-free snapshot of a hash chain's residency: which prefix
    blocks are resident and in which tier. The engine plans the §5.2
    load-vs-compute split off this, then commits via ``finish_fetch``.

    With a ``GlobalBlockDirectory`` a miss can resolve to a PEER node
    (tier ``"peer"``); ``sources[i]`` then names the owning node. The
    directory is advisory — every peer block re-verifies at fetch time
    and a stale entry degrades to recompute, never to wrong bytes."""
    hash_ids: list[int]
    tiers: list[str]                # per resident block: dram | ssd | peer
    sources: Optional[list] = None  # per block: owner node id (peer only)

    @property
    def n_resident(self) -> int:
        return len(self.tiers)

    @property
    def has_ssd(self) -> bool:
        return "ssd" in self.tiers

    @property
    def has_remote(self) -> bool:
        return "peer" in self.tiers

    def source(self, i: int):
        return self.sources[i] if self.sources is not None else None

    def truncate(self, n: int) -> "FetchPlan":
        return FetchPlan(self.hash_ids, self.tiers[:n],
                         None if self.sources is None else self.sources[:n])


class PeerSource:
    """Read-side adapter over a peer transport (``InProcPeer`` here; a
    socket peer raises the same taxonomy). ``read_layer`` maps a taxonomy
    error to a per-key reason (``peer_unreachable``, ``stale_directory``,
    ``verify_failed``) and returns ``None``, exactly like a failed local
    store read, so the fetching pool can log WHY it fell back to
    recompute and self-heal the directory."""

    def __init__(self, node, peer) -> None:
        self.node = node
        self.peer = peer
        self.reasons: dict[int, str] = {}

    @property
    def n_layers(self) -> int:
        if self.peer is None:
            return 0
        try:
            return self.peer.n_layers
        except PeerError:
            return 0

    def note_empty(self, key: int) -> None:
        """Classify a fetch that never started: a dead peer vs an alive
        peer with nothing to serve (the directory entry was stale)."""
        if key in self.reasons:
            return
        if self.peer is None:
            self.reasons[key] = "peer_unreachable"
            return
        try:
            self.peer.n_layers
        except PeerError as e:
            self.reasons[key] = fallback_reason(e)
        else:
            self.reasons[key] = "stale_directory"

    def read_layer(self, key: int, layer: int):
        if self.peer is None:
            self.reasons[key] = "peer_unreachable"
            return None
        try:
            return self.peer.read_layer(key, layer)
        except PeerError as e:
            self.reasons[key] = fallback_reason(e)
            return None


class HostKVPool:
    """Two-tier CPU KVCache pool: prefix hash → per-layer KV block bytes
    ((L, 512, KV, Dh) host tensors). Metadata and eviction are delegated
    to ``CachePool``/``TieredCachePool`` (demote on evict, promote on hit):

    * ``ssd_capacity_blocks`` alone keeps demoted bytes in host tensors
      (the tier split is the metadata's concern only);
    * with ``ssd_dir`` the SSD tier is REAL: demotions batch-write to a
      checksummed ``SSDBlockStore`` file, promotions read them back, and
      ``start_prefetch``/``finish_fetch`` expose the async layer-wise load
      path the ``PrefillWorker`` overlaps with head recompute (§5.2). A
      block whose on-disk bytes fail verification is discarded from the
      hierarchy and becomes a miss — never wrong bytes. A store a
      previous run (of either package) flushed is recovered into the SSD
      tier's metadata.

    With a shared ``GlobalBlockDirectory`` (+ ``node_id`` and peers wired
    by ``add_peer``/``connect_pools``) the pool joins the cluster-wide
    pool: its tier moves publish to the directory, and ``plan_fetch``
    resolves local misses to a peer's DRAM or SSD. Peer blocks stream
    through the same ``AsyncPrefetcher`` layer-major queue, verify before
    their metadata enters the local hierarchy, and on ANY failure the run
    truncates to recompute with the reason in ``fallback_reasons``.

    Also holds the preemption SPILL SLAB: req_id → (k, v, n_tokens) of a
    victim's exported device run (the HBM→DRAM rung), keyed per request
    and popped on restore/abandon.
    """

    def __init__(self, capacity_blocks: Optional[int] = None,
                 policy: str = "lru", ssd_capacity_blocks: int = 0,
                 ssd_policy: str = "lru", writeback_batch: int = 8,
                 ssd_dir: Optional[str] = None,
                 ssd_read_bw: Optional[float] = None,
                 ssd_write_bw: Optional[float] = None,
                 spec: Optional[CacheTierSpec] = None, directory=None,
                 node_id=None) -> None:
        if spec is None:
            spec = CacheTierSpec(
                dram_blocks=capacity_blocks, ssd_blocks=ssd_capacity_blocks,
                dram_policy=policy, ssd_policy=ssd_policy,
                writeback_batch=writeback_batch, ssd_dir=ssd_dir)
        self.spec = spec
        self.meta: CachePool = spec.make_pool()
        self.data: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.store: Optional[SSDBlockStore] = None
        self.prefetcher: Optional[AsyncPrefetcher] = None
        self.directory = directory
        self.node_id = node_id
        self.peers: dict = {}           # node id -> peer transport
        self.alive = True               # kill() = failure-injection switch
        self.peer_blocks_fetched = 0
        self.peer_fetch_failures = 0
        self.fallback_reasons: dict[str, int] = {}
        self._inflight: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # written by the serving-loop thread, read by stats() from any
        # thread — hence its own lock
        self._spill_lock = threading.Lock()
        self._spill: dict[int, tuple] = {}  #: guarded_by self._spill_lock
        #: guarded_by self._spill_lock
        self._spill_counters = dict(spills=0, spill_restores=0,
                                    spill_drops=0)
        if spec.ssd_dir is not None and not spec.tiered:
            raise ValueError(
                "ssd_dir given but the SSD tier is disabled (ssd_blocks=0) "
                "— nothing would ever reach the file-backed store; set "
                "ssd_capacity_blocks/CacheTierSpec.ssd_blocks > 0")
        if spec.tiered and spec.ssd_dir is not None:
            self.store = SSDBlockStore(
                spec.ssd_dir, writeback_batch=spec.writeback_batch,
                read_bw=ssd_read_bw, write_bw=ssd_write_bw)
            self.prefetcher = AsyncPrefetcher(self.store)
            self.meta.on_demote = self._on_demote
            self.meta.on_promote = self._on_promote
            self.meta.on_drop = self._on_drop
            # restart recovery: blocks a previous run flushed re-enter the
            # SSD tier's metadata (chain hashes are stable across runs, so
            # matching prefixes become hits again; depth is unknown → 0)
            for key in self.store.keys():
                ssd_evicted, placed = self.meta.ssd.insert_meta(
                    BlockMeta(key=key))
                for e in ssd_evicted:
                    self.store.delete(e)
                if not placed:
                    self.store.delete(key)
        # join the global pool AFTER recovery so bind() seeds recovered
        # blocks too; chaining preserves the byte-holder hooks above
        if directory is not None and hasattr(self.meta, "on_demote"):
            directory.bind(node_id, self.meta)

    # ---- global pool membership ----------------------------------------
    def add_peer(self, node_id, peer) -> None:
        """Make a remote node fetchable: a peer transport (anything with
        ``n_layers`` + ``read_layer`` raising the shared taxonomy) or a
        ``HostKVPool``, which is wrapped in an ``InProcPeer``."""
        if not hasattr(peer, "read_layer"):
            peer = InProcPeer(peer)
        self.peers[node_id] = peer

    def kill(self) -> None:
        """Failure injection: model this node dying — peers' reads against
        it raise ``PeerUnreachable`` from now on. Local state is left
        intact so tests can assert nothing was served from a dead node."""
        self.alive = False

    def _note_fallback(self, reason: str) -> None:
        self.fallback_reasons[reason] = self.fallback_reasons.get(reason, 0) + 1

    # ---- tier-event hooks (file-backed mode only) ----------------------
    def _on_demote(self, key: int) -> None:
        kv = self.data.get(key)
        if kv is not None:
            # staged (flushed per writeback batch) BEFORE the DRAM copy
            # goes: a peer's concurrent read through this pool's
            # BlockServer always finds the block in one of the two
            self.store.put(key, *kv)
            del self.data[key]

    def _on_promote(self, key: int, count_read: bool) -> None:
        if count_read:
            kv = self._inflight.pop(key, None)
            if kv is None:              # promotion outside a verified fetch
                kv = self.store.read_block(key)
            if kv is not None:
                self.data[key] = kv
            # unreadable bytes leave no DRAM copy; the next verified fetch
            # sees the hole and discards the block's metadata
        self.store.delete(key)

    def _on_drop(self, key: int) -> None:
        self.data.pop(key, None)
        if self.store is not None:
            self.store.delete(key)

    # ---- fetch protocol ------------------------------------------------
    def plan_fetch(self, hash_ids: list[int]) -> FetchPlan:
        """Residency snapshot of the chain's prefix (no side effects).
        Local misses consult the global directory: a block a reachable
        peer claims extends the plan with tier ``"peer"``."""
        rt = getattr(self.meta, "resident_tier", None)
        tiers: list[str] = []
        sources: list = []
        for h in hash_ids:
            t = rt(h) if rt is not None \
                else ("dram" if h in self.meta else None)
            src = None
            if t is None and self.directory is not None and self.peers:
                owner = self.directory.pick_owner(
                    h, exclude=(self.node_id,), among=self.peers)
                if owner is not None:
                    t, src = "peer", owner[0]
            if t is None:
                break
            tiers.append(t)
            sources.append(src)
        return FetchPlan(list(hash_ids), tiers, sources)

    def start_prefetch(self, plan: FetchPlan,
                       from_block: int = 0) -> Optional[PrefetchHandle]:
        """Enqueue async layer-wise loads of the plan's SSD and peer
        blocks at index ≥ ``from_block``; returns a PrefetchHandle (or
        None). Peer blocks stream through the same layer-major queue,
        read off the owning node via a ``PeerSource``."""
        if self.prefetcher is None:
            return None
        keys: list[int] = []
        sources: dict = {}
        peer_srcs: dict = {}
        for i in range(from_block, plan.n_resident):
            h, t = plan.hash_ids[i], plan.tiers[i]
            if t == "ssd":
                keys.append(h)
            elif t == "peer":
                node = plan.source(i)
                if node not in peer_srcs:
                    peer_srcs[node] = PeerSource(node, self.peers.get(node))
                keys.append(h)
                sources[h] = peer_srcs[node]
        if not keys:
            return None
        return self.prefetcher.fetch(keys, sources)

    def _remote_block(self, src: PeerSource, key: int):
        """Synchronous whole-block peer read (the blocking path)."""
        L = src.n_layers
        if L == 0:
            src.note_empty(key)
            return None
        ks, vs = [], []
        for layer in range(L):
            pair = src.read_layer(key, layer)
            if pair is None:
                return None
            ks.append(pair[0])
            vs.append(pair[1])
        return torch.stack(ks), torch.stack(vs)

    def _take_peer_block(self, i: int, h: int, kv) -> bool:
        """Install a VERIFIED peer block: bytes first, then metadata (the
        hierarchy never claims bytes it can't serve). Returns False when
        the local hierarchy has no room — treated as a fetch failure. A
        pinned-full-DRAM insert that lands straight in the SSD tier
        writes the bytes through to the store."""
        self.data[h] = (kv[0], kv[1])
        evicted = self.meta.insert([h], start_pos=i)
        for e in evicted:
            self.data.pop(e, None)      # file-backed: on_drop already freed
        if h not in self.meta:
            self.data.pop(h, None)
            self._note_fallback("no_local_room")
            return False
        rt = getattr(self.meta, "resident_tier", None) \
            if self.store is not None else None
        if rt is not None and rt(h) == "ssd":
            if h not in self.store:     # landed straight in the SSD tier
                self.store.put(h, *self.data[h])
            del self.data[h]
        self.peer_blocks_fetched += 1
        return True

    def finish_fetch(self, plan: FetchPlan,
                     handle: Optional[PrefetchHandle] = None,
                     from_block: int = 0) -> int:
        """Verify + install bytes for plan blocks [from_block:], promote
        their metadata, and return how many CONSECUTIVE blocks from
        ``from_block`` are usable. A block that fails verification is
        discarded from the hierarchy (peer blocks: the stale directory
        claim is withdrawn) and truncates the usable run — the caller
        recomputes from there, with the reason in ``fallback_reasons``."""
        if handle is not None:
            handle.wait()               # §5.2 wait-before-attend barrier
        h_sources = handle.sources if handle is not None else {}
        n_ok = 0
        local_seg: list[int] = []
        for i in range(from_block, plan.n_resident):
            h, tier = plan.hash_ids[i], plan.tiers[i]
            if tier == "dram":
                if h in self.data or self.store is None:
                    n_ok += 1
                    local_seg.append(h)
                    continue
                self.meta.discard(h)    # metadata claimed bytes we lost
                break
            if tier == "peer":
                node = plan.source(i)
                src = h_sources.get(h)
                kv = handle.result(h) if handle is not None else None
                if kv is None:
                    if src is None:
                        src = PeerSource(node, self.peers.get(node))
                    kv = self._remote_block(src, h)
                if kv is None:
                    reason = (src.reasons.get(h) if src is not None
                              else None) or "peer_fetch_failed"
                    self._note_fallback(reason)
                    self.peer_fetch_failures += 1
                    if self.directory is not None and reason in (
                            "stale_directory", "verify_failed"):
                        self.directory.unregister(h, node)  # self-heal
                    break
                if not self._take_peer_block(i, h, kv):
                    break
                n_ok += 1
                continue
            # tier == "ssd" — the local store path
            kv = handle.result(h) if handle is not None else None
            if kv is None and self.store is not None:
                kv = self.store.read_block(h)
            if kv is None:
                self.meta.discard(h)
                self._note_fallback("local_verify_failed")
                break
            self._inflight[h] = kv
            n_ok += 1
            local_seg.append(h)
        if local_seg:
            self.meta.touch_keys(local_seg)  # promotions consume _inflight
        self._inflight.clear()
        return n_ok

    def match_prefix(self, hash_ids: list[int]) -> int:
        if self.store is None and not self.peers:
            return self.meta.lookup(hash_ids)
        n = self.finish_fetch(self.plan_fetch(hash_ids))
        self.meta.misses += len(hash_ids) - n
        return n

    # ---- bytes ---------------------------------------------------------
    def get(self, hash_ids: list[int]):
        """Stack blocks → (L, n·512, KV, Dh) k and v host tensors, reading
        through the store for blocks whose bytes sit on disk."""
        ks, vs = [], []
        for h in hash_ids:
            kv = self.data.get(h)
            if kv is None and self.store is not None:
                kv = self.store.read_block(h)
            if kv is None:
                raise KeyError(f"block {h} has no readable bytes")
            ks.append(kv[0])
            vs.append(kv[1])
        return torch.cat(ks, dim=1), torch.cat(vs, dim=1)

    def put(self, hash_ids: list[int], k: torch.Tensor, v: torch.Tensor,
            start_pos: int = 0) -> None:
        """k/v (L, n·512, KV, Dh) host tensors covering ``hash_ids``; a
        block the hierarchy places straight in the SSD tier is written to
        the store."""
        evicted = self.meta.insert(hash_ids, start_pos=start_pos)
        for e in evicted:
            self.data.pop(e, None)      # file-backed: on_drop already freed
        rt = getattr(self.meta, "resident_tier", None) \
            if self.store is not None else None
        for i, h in enumerate(hash_ids):
            if h not in self.meta or h in self.data:
                continue
            sl = slice(i * BLOCK_TOKENS, (i + 1) * BLOCK_TOKENS)
            if rt is not None and rt(h) == "ssd":
                if h not in self.store:  # inserted straight to the SSD tier
                    self.store.put(h, k[:, sl], v[:, sl])
            else:
                self.data[h] = (k[:, sl].clone(), v[:, sl].clone())

    # ---- preemption spill slab (device→host demotion of live runs) -----
    def spill_put(self, req_id: int, k, v, n_tokens: int) -> None:
        """Park a preempted slot's exported KV run until it restores.
        Overwriting would silently lose bytes, so it raises."""
        with self._spill_lock:
            if req_id in self._spill:
                raise RuntimeError(
                    f"request {req_id} already has a spilled run — a victim "
                    f"must restore (spill_pop) before it can spill again")
            self._spill[req_id] = (k, v, n_tokens)
            self._spill_counters["spills"] += 1

    def spill_get(self, req_id: int):
        """Peek a spilled run: (k, v, n_tokens). KeyError if absent."""
        with self._spill_lock:
            return self._spill[req_id]

    def spill_pop(self, req_id: int, *, restored: bool = True) -> bool:
        """Drop a spilled run — after a restore, or when the request is
        abandoned (``restored=False``). Returns whether it existed."""
        with self._spill_lock:
            had = self._spill.pop(req_id, None) is not None
            if had:
                key = "spill_restores" if restored else "spill_drops"
                self._spill_counters[key] += 1
            return had

    def spill_depth(self) -> int:
        """Preempted requests parked in the slab (``BackpressureSignal``
        ``spilled`` gauge)."""
        with self._spill_lock:
            return len(self._spill)

    def est_block_read_s(self) -> float:
        """Expected SSD read seconds per block (for the split search)."""
        return self.store.est_block_read_s() if self.store is not None \
            else 0.0

    @property
    def n_blocks(self) -> int:
        return len(self.data) + (len(self.store) if self.store else 0)

    def stats(self) -> dict:
        """Block residency, peer-fetch counters, fallback reasons
        (flattened as ``fallback_<reason>``), the store's counters
        (prefixed ``store_``) and the preemption spill slab."""
        out = dict(
            dram_blocks=len(self.data),
            store_blocks=len(self.store) if self.store else 0,
            total_blocks=self.n_blocks,
            peer_blocks_fetched=self.peer_blocks_fetched,
            peer_fetch_failures=self.peer_fetch_failures,
        )
        for reason, n in self.fallback_reasons.items():
            out[f"fallback_{reason}"] = n
        if self.store is not None:
            for key, n in self.store.stats().items():
                out[f"store_{key}"] = n
        with self._spill_lock:
            out.update(self._spill_counters)
            out["spill_entries"] = len(self._spill)
            out["spill_bytes"] = sum(
                k.numel() * k.element_size() + v.numel() * v.element_size()
                for k, v, _ in self._spill.values())
        return out

    def close(self) -> None:
        """Drop the spill slab, join the prefetch thread, then flush and
        close the store."""
        with self._spill_lock:
            self._spill.clear()
        if self.prefetcher is not None:
            self.prefetcher.close()
        if self.store is not None:
            self.store.close()


def connect_pools(pools: list[HostKVPool]) -> None:
    """Cross-register every pool as a peer of every other (the in-process
    stand-in for Messenger endpoints). Pools must carry distinct
    ``node_id``s and share one ``GlobalBlockDirectory``."""
    for a in pools:
        for b in pools:
            if a is not b:
                a.add_peer(b.node_id, b)


@dataclass
class PrefillResult:
    first_token: int
    kv_k: torch.Tensor          # (L, S, KV, Dh) full-depth host KV
    kv_v: torch.Tensor
    prompt_len: int
    reused_blocks: int
    new_blocks: int
    ssd_blocks: int = 0         # prefix blocks loaded off the SSD store
    peer_blocks: int = 0        # prefix blocks fetched off a PEER's pool
    overlapped: bool = False    # head recompute ∥ tail SSD load was used
    skipped_blocks: int = 0     # DRAM blocks chunk-skipped mid-head-span
    hash_ids: Optional[list] = None   # the request's prefix chain
    pages: Optional[list] = None      # staged device page run
    page_pool: Optional[object] = None  # the DevicePagePool holding ``pages``
    page_gens: Optional[list] = None  # allocation generations at staging
    _pages_adopted: bool = False      # first join takes the staging ref

    def release_pages(self) -> None:
        """Drop the staging reference of a result that will never be
        joined; a no-op after the first join consumed it."""
        if self.pages is not None and self.page_pool is not None \
                and not self._pages_adopted:
            self.page_pool.release(self.pages)
            self._pages_adopted = True


def paged_supported(cfg: ModelConfig) -> bool:
    """The paged decode substrate covers uniform attention-only stacks;
    hybrid, SSM and encoder-decoder stacks keep their own caches. Drivers
    use this to decide whether to build a ``DevicePagePool`` at all
    (staging into a pool no decode worker will ever adopt from just leaks
    pages)."""
    return cfg.attention_layers == cfg.n_layers and not cfg.encoder_layers


def kv_worker_refusal(cfg: ModelConfig) -> str:
    """Why the KV serving workers (``PrefillWorker``, ``DecodeWorker``)
    cannot serve ``cfg`` — empty when they can — naming the entry point
    to use instead. The reference's workers take these models and lose
    state silently: its dense join copies KV only (a hybrid's Mamba2
    state stays zero), and its token-only prefill gives an
    encoder-decoder no encoder output at all."""
    if cfg.kind == "ssm":
        return (f"{cfg.name} is an SSM model whose decode state is its "
                f"recurrent state — serve it through StateCheckpointWorker "
                f"and decode_step")
    if cfg.ssm is not None:
        return (f"{cfg.name} is a hybrid whose decode state is its KV and "
                f"its Mamba2 states together, which a KV join would drop — "
                f"run models.transformer.prefill and decode_step")
    if cfg.encoder_layers:
        return (f"{cfg.name} is an encoder-decoder model whose decoder "
                f"cross-attends its encoder's output, which a token-only "
                f"prefill never computes — run "
                f"models.transformer.prefill(frames=...) and decode_step")
    return ""


def stage_run(pool: Optional[DevicePagePool], hash_ids: list[int], k_full,
              v_full, S: int, bank: Optional[int] = None
              ) -> Optional[list[int]]:
    """Stage a request's KV into a page run (§3 step 2: fresh pages
    written layer-stacked; step 1: registered prefix runs ADOPTED — the
    physical pages are shared, no bytes move). Full 512-token blocks
    register under their chain hash; the partial tail gets private pages.
    On a banked (mesh) pool the whole run lives in ONE data-shard bank —
    ``bank=None`` picks the bank with the deepest registered prefix.
    The caller owns one reference per returned page. Returns None
    (nothing held) if the pool can't fit the run even after evicting
    registry-only runs."""
    if pool is None:
        return None
    if bank is None:
        bank = pool.best_stage_bank(hash_ids)
    B = BLOCK_TOKENS
    n_full = len(hash_ids)
    held: list[int] = []
    try:
        adopted, pages = pool.adopt_chain(hash_ids, bank=bank)
        held = list(pages)
        for i in range(adopted, n_full):
            run = pool.alloc(pool.pages_per_block, bank=bank)
            held += run
            pool.write_run(run, k_full[:, i * B:(i + 1) * B],
                           v_full[:, i * B:(i + 1) * B])
            pool.register_block(hash_ids[i], run)
            pages += run
        tail = S - n_full * B
        if tail > 0:
            run = pool.alloc(pool.pages_for(tail), bank=bank)
            held += run
            pool.write_run(run, k_full[:, n_full * B:S],
                           v_full[:, n_full * B:S])
            pages += run
        return pages
    except MemoryError:
        pool.release(held)
        return None
    except BaseException:
        # a non-capacity failure must not strand the partly written run
        pool.release(held)
        raise


@dataclass
class RestorePlan:
    """Priced decision for bringing a preempted victim back: reload its
    spilled bytes through ``stage_run`` vs recompute through prefill."""
    mode: str                   # "reload" | "recompute"
    est_reload_s: float
    est_recompute_s: float


def plan_restore(n_tokens: int, *, reload_s_per_block: Optional[float],
                 recompute_s_per_block: Optional[float],
                 mode: str = "auto") -> RestorePlan:
    """Price the two restore arms for a spilled run of ``n_tokens``. An
    unwarmed (``None``) arm loses; reload wins ties (the bytes exist)."""
    if mode not in ("auto", "reload", "recompute"):
        raise ValueError(f"unknown restore mode {mode!r}")
    n_blocks = -(-n_tokens // BLOCK_TOKENS)
    tl = (reload_s_per_block or 0.0) * n_blocks
    tc = (recompute_s_per_block or 0.0) * n_blocks
    if mode != "auto":
        chosen = mode
    elif recompute_s_per_block is None:
        chosen = "reload"
    elif reload_s_per_block is None:
        chosen = "recompute"
    else:
        chosen = "reload" if tl <= tc else "recompute"
    return RestorePlan(mode=chosen, est_reload_s=tl, est_recompute_s=tc)


class ChunkedPrefill:
    """A prefill suspended between device chunks — the serving loop's
    interleave unit. ``advance()`` runs exactly one device chunk (the
    first call also does the hashing, fetch planning and pool reads that
    precede it) and returns True once the request is complete (result in
    ``.result``); ``chunks_done`` counts the calls that ran, the last one
    too. Draining it in one go IS the blocking path."""

    def __init__(self, worker: "PrefillWorker", tokens: np.ndarray,
                 session=None) -> None:
        self.worker = worker
        self.tokens = np.asarray(tokens)
        self.prompt_len = len(self.tokens)
        self.chunks_done = 0
        self.result: Optional[PrefillResult] = None
        #: the request served, for the spans (the serving loop sets it)
        self.req_id: Optional[int] = None
        self._gen = worker._chunks(self.tokens, session)

    @property
    def done(self) -> bool:
        return self.result is not None

    def advance(self) -> bool:
        """Run one device chunk; True once the prefill finished."""
        if self.result is not None:
            return True
        with spans.span("prefill.advance", req_id=self.req_id):
            try:
                next(self._gen)
                self.chunks_done += 1
                return False
            except StopIteration as e:
                self.chunks_done += 1
                self.result = e.value
                return True

    def drain(self) -> PrefillResult:
        while not self.advance():
            pass
        return self.result


class PrefillWorker:
    """§3 steps 1–3: KVCache reuse → chunked incremental prefill →
    store-back of fresh full blocks to the host pool (a device-to-host
    copy, Mooncake's design). One request at a time (B = 1), on the
    device the parameters live on.

    With a file-backed pool, ``ssd_mode`` picks how SSD- or peer-resident
    prefix blocks reach the card: ``"blocking"`` loads them synchronously
    before any compute; ``"overlap"`` splits the prefix per
    ``layerwise.overlap_split``, RECOMPUTING the head chunks while the
    tail streams from the store layer by layer on the prefetch thread,
    and only then computes the uncached suffix. Verification failures
    shrink the loaded tail and the lost blocks are recomputed. Each
    overlapped request's split lands in ``overlap_plans``.

    Every prefill is chunk-resumable: ``start()`` returns a
    ``ChunkedPrefill``; ``__call__`` drains it."""

    def __init__(self, params, cfg: ModelConfig, pool: HostKVPool, *,
                 prefill_chunk: int = 1024, ssd_mode: str = "overlap",
                 page_pool: Optional[DevicePagePool] = None) -> None:
        reason = kv_worker_refusal(cfg)
        if reason:
            raise ValueError(f"PrefillWorker's KV path serves uniform "
                             f"attention stacks: {reason}")
        if ssd_mode not in ("blocking", "overlap"):
            raise ValueError(f"unknown ssd_mode {ssd_mode!r}")
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.chunk = prefill_chunk
        self.ssd_mode = ssd_mode
        self.page_pool = page_pool
        self.device = params["embed"].device
        self.hasher = PrefixHasher()
        self.counters = dict(reused_blocks=0, computed_tokens=0, requests=0,
                             ssd_loaded_blocks=0, overlapped_requests=0,
                             fallback_blocks=0, peer_blocks=0,
                             skipped_blocks=0, page_oom=0, chunks=0,
                             stage_deferred=0, prefix_load_bytes=0,
                             offload_bytes=0, stage_bytes=0)
        #: the most recent overlapped requests' splits (a dict each: the
        #: ``ChunkOverlapPlan`` fields, the loaded tail, the estimates and
        #: the seconds from the barrier to the tail on the card)
        self.overlap_plans: deque = deque(maxlen=256)
        # serving-loop hook: called with the page count a stage would pin;
        # False skips staging (the join stages later)
        self.stage_guard = None
        self._t_block_ema: Optional[float] = None  # measured s / 512-tok blk

    def _note_compute(self, tokens: int, dt: float) -> None:
        if tokens <= 0 or dt <= 0:
            return
        per_block = dt * BLOCK_TOKENS / tokens
        self._t_block_ema = per_block if self._t_block_ema is None \
            else 0.7 * self._t_block_ema + 0.3 * per_block

    def est_chunk_s(self) -> float:
        """Measured seconds per device chunk (0.0 until warmed up)."""
        if self._t_block_ema is None:
            return 0.0
        return self._t_block_ema * self.chunk / BLOCK_TOKENS

    def _chunk_extend(self, t: torch.Tensor, caches: Caches, lo: int,
                      hi: int):
        """One timed device chunk (the resumable unit); the synchronise
        makes the EMA measure device time."""
        t0 = time.monotonic_ns()
        with spans.span("prefill.chunk_dispatch"):
            logits, caches = decode_step(self.params, t[:, lo:hi], caches,
                                         self.cfg)
        with spans.span("prefill.chunk_sync"):
            _sync(self.device)
        t1 = time.monotonic_ns()
        self._note_compute(hi - lo, (t1 - t0) * 1e-9)
        self.counters["chunks"] += 1
        spans.add("prefill.chunk", t0, t1)
        return logits, caches

    def _set_blocks(self, caches: Caches, hash_ids: list[int], lo: int,
                    hi: int) -> Caches:
        """Copy pool blocks [lo, hi) into the cache arena on this thread
        (a blocking host-to-device copy) and resume after them."""
        B = BLOCK_TOKENS
        with spans.span("prefill.prefix_load") as sp:
            k_h, v_h = self.pool.get(hash_ids[lo:hi])
            caches.kv.k[:, 0, lo * B:hi * B] = k_h.to(self.device)
            caches.kv.v[:, 0, lo * B:hi * B] = v_h.to(self.device)
            moved = _nbytes(k_h) + _nbytes(v_h)
            sp.moved(moved)
        self.counters["prefix_load_bytes"] += moved
        return caches._replace(length=hi * B)

    def _offload(self, caches: Caches) -> tuple:
        """The prompt's whole KV copied to host memory."""
        with spans.span("prefill.offload") as sp:
            k_full = caches.kv.k[:, 0].to("cpu", copy=True)
            v_full = caches.kv.v[:, 0].to("cpu", copy=True)
            moved = _nbytes(k_full) + _nbytes(v_full)
            sp.moved(moved)
        self.counters["offload_bytes"] += moved
        return k_full, v_full

    def _store_back(self, hash_ids: list[int], k, v, start_pos: int) -> None:
        """Fresh full blocks [start_pos, start_pos + len(hash_ids)) into
        the host pool."""
        with spans.span("prefill.store_back"):
            self.pool.put(hash_ids, k, v, start_pos=start_pos)

    def _stage(self, hash_ids, k_full, v_full, S) -> Optional[list[int]]:
        if self.page_pool is not None and self.stage_guard is not None \
                and not self.stage_guard(self.page_pool.pages_for(S)):
            self.counters["stage_deferred"] += 1
            return None
        if self.page_pool is None:
            return None
        pp = self.page_pool
        with spans.span("prefill.stage") as sp:
            b0 = pp.counters["bytes_written"]
            pages = stage_run(pp, hash_ids, k_full, v_full, S)
            moved = pp.counters["bytes_written"] - b0
            sp.moved(moved)
        self.counters["stage_bytes"] += moved
        if pages is None:
            self.counters["page_oom"] += 1
        return pages

    def _stage_result(self, hash_ids, k_full, v_full, S) -> dict:
        """PrefillResult kwargs for the staged page run (+ generation
        snapshot so late re-joins can detect recycled pages)."""
        pages = self._stage(hash_ids, k_full, v_full, S)
        return dict(
            hash_ids=hash_ids, pages=pages, page_pool=self.page_pool,
            page_gens=None if pages is None
            else self.page_pool.gens_of(pages))

    def stats(self) -> dict:
        out = dict(self.counters)
        out["hash_blocks"] = self.hasher.blocks_hashed
        out["hash_memo_hits"] = self.hasher.memo_hits
        return out

    def start(self, tokens: np.ndarray, session=None) -> ChunkedPrefill:
        window = self.cfg.sliding_window
        if window and len(tokens) > window:
            # the reference bounds this prefill's cache to the window
            # (init_caches' eff_window) and then raises on a chunk wider
            # than the window or, chunk by chunk, silently clamps the
            # write offset: refuse instead
            raise ValueError(
                f"a {len(tokens)}-token prompt is longer than "
                f"{self.cfg.name}'s {window}-token sliding window; the "
                f"reference's "
                f"PrefillWorker writes it into a window-sized cache (an "
                f"error for chunks wider than the window, a silent clamp "
                f"for narrower ones), so the port refuses it")
        return ChunkedPrefill(self, tokens, session=session)

    def __call__(self, tokens: np.ndarray, session=None) -> PrefillResult:
        return self.start(tokens, session=session).drain()

    def _chunks(self, tokens: np.ndarray, session=None):
        """Generator behind ``ChunkedPrefill``: yields between device
        chunks; its StopIteration value is the ``PrefillResult``."""
        cfg = self.cfg
        S = len(tokens)
        with spans.span("prefill.match"):
            hash_ids = self.hasher.hash_ids(tokens, session=session)
            plan = None
            if self.ssd_mode == "overlap" \
                    and self.pool.prefetcher is not None:
                plan = self.pool.plan_fetch(hash_ids)
                n_res = plan.n_resident
                # full hit: keep a tail to recompute logits
                if n_res * BLOCK_TOKENS >= S:
                    n_res = max((S - 1) // BLOCK_TOKENS, 0)
                plan = plan.truncate(n_res)
                if not (plan.has_ssd or plan.has_remote):
                    plan = None
            if plan is None:
                # blocking path: flat pool, metadata-only tiers, or
                # synchronous file-backed/peer loads (ssd_mode="blocking");
                # peer blocks are counted around the synchronous fetch
                # alone: the serving loop interleaves other prefills on
                # this pool between this generator's chunks
                peer0 = self.pool.peer_blocks_fetched
                n_hit = self.pool.match_prefix(hash_ids)
                n_peer = self.pool.peer_blocks_fetched - peer0
                prefix_tokens = n_hit * BLOCK_TOKENS
                # full hit: recompute last block's tail to get logits
                if prefix_tokens >= S:
                    n_hit = max((S - 1) // BLOCK_TOKENS, 0)
                    prefix_tokens = n_hit * BLOCK_TOKENS
        if plan is not None:
            result = yield from self._chunks_overlapped(tokens, hash_ids,
                                                        plan)
            return result

        t = torch.as_tensor(np.asarray(tokens, np.int64)[None, :],
                            device=self.device)
        caches = init_caches(cfg, 1, S, device=self.device)
        if n_hit:
            caches = self._set_blocks(caches, hash_ids, 0, n_hit)
        # chunked incremental prefill over the uncached suffix (a cold
        # request is the n_hit = 0 case)
        logits = None
        for lo in range(prefix_tokens, S, self.chunk):
            hi = min(lo + self.chunk, S)
            logits, caches = self._chunk_extend(t, caches, lo, hi)
            if hi < S:
                yield               # suspension point for the serving loop
        first = int(torch.argmax(logits[0, -1]))
        k_full, v_full = self._offload(caches)

        # store-back of every fresh full block to the host pool
        n_total = len(hash_ids)
        if n_total > n_hit:
            sl = slice(n_hit * BLOCK_TOKENS, n_total * BLOCK_TOKENS)
            self._store_back(hash_ids[n_hit:], k_full[:, sl], v_full[:, sl],
                             n_hit)
        self.counters["reused_blocks"] += n_hit
        self.counters["computed_tokens"] += S - prefix_tokens
        self.counters["requests"] += 1
        self.counters["peer_blocks"] += n_peer
        return PrefillResult(
            first_token=first, kv_k=k_full, kv_v=v_full, prompt_len=S,
            reused_blocks=n_hit, new_blocks=n_total - n_hit,
            peer_blocks=n_peer,
            **self._stage_result(hash_ids, k_full, v_full, S))

    def _chunks_overlapped(self, tokens: np.ndarray, hash_ids: list[int],
                           plan: FetchPlan):
        """Head recompute ∥ tail SSD/peer load (§5.2 / Jin et al.), as a
        chunk-resumable generator.

        Timeline: pick split s via ``overlap_split``; blocks [0, d0) come
        from DRAM; launch async layer-wise loads of blocks [s, n);
        recompute chunks over the non-DRAM runs of [d0·B, s·B) while they
        stream (each run resumes prefill at its own offset); barrier; set
        the loaded tail into the cache arena; compute the uncached suffix.
        """
        B = BLOCK_TOKENS
        cfg = self.cfg
        S = len(tokens)
        n = plan.n_resident
        tl = self.pool.est_block_read_s()
        tc = self._t_block_ema if self._t_block_ema is not None else tl
        # peer blocks are loads for the split search (the local read EMA
        # is the per-block load estimate at hand)
        ov = overlap_split(["dram" if t == "dram" else "ssd"
                            for t in plan.tiers], tc, tl)
        s, d0 = ov.split, ov.dram_head
        handle = self.pool.start_prefetch(plan, from_block=s)
        if d0:
            self.pool.meta.touch_keys(hash_ids[:d0])

        t = torch.as_tensor(np.asarray(tokens, np.int64)[None, :],
                            device=self.device)
        caches = init_caches(cfg, 1, S, device=self.device)
        if d0:
            caches = self._set_blocks(caches, hash_ids, 0, d0)

        # head assembly, overlapping the prefetch thread's layer loads:
        # DRAM blocks inside [d0, s) are chunk-SKIPPED (set straight into
        # the arena), and only the non-resident runs between them
        # recompute. The suffix below is never empty, so yielding after
        # each head chunk never strands the result.
        i = d0
        while i < s:
            j = i
            if plan.tiers[i] == "dram":
                while j < s and plan.tiers[j] == "dram":
                    j += 1
                caches = self._set_blocks(caches, hash_ids, i, j)
                self.pool.meta.touch_keys(hash_ids[i:j])
            else:
                while j < s and plan.tiers[j] != "dram":
                    j += 1
                for lo in range(i * B, j * B, self.chunk):
                    hi = min(lo + self.chunk, j * B)
                    _, caches = self._chunk_extend(t, caches, lo, hi)
                    yield
            i = j
        n_skip = ov.head_skipped

        # §5.2 barrier: verify + install the loaded tail, then copy it to
        # the card here, on the worker's thread
        t_barrier = time.monotonic()
        peer0 = self.pool.peer_blocks_fetched
        n_tail = self.pool.finish_fetch(plan, handle, from_block=s)
        n_peer = self.pool.peer_blocks_fetched - peer0
        usable = s + n_tail
        if n_tail:
            caches = self._set_blocks(caches, hash_ids, s, usable)
        t_barrier = time.monotonic() - t_barrier

        # uncached suffix (+ any blocks lost to verification failures);
        # never empty — the caller truncates full-hit plans
        if usable * B >= S:
            raise AssertionError(f"empty suffix: {usable} blocks of {S}")
        logits = None
        for lo in range(usable * B, S, self.chunk):
            hi = min(lo + self.chunk, S)
            logits, caches = self._chunk_extend(t, caches, lo, hi)
            if hi < S:
                yield
        first = int(torch.argmax(logits[0, -1]))
        k_full, v_full = self._offload(caches)

        # store-back: the RECOMPUTED head runs (chunk-skipped DRAM blocks
        # are already pool-resident) and the fresh suffix blocks
        n_total = len(hash_ids)
        i = d0
        while i < s:
            if plan.tiers[i] == "dram":
                i += 1
                continue
            j = i
            while j < s and plan.tiers[j] != "dram":
                j += 1
            sl = slice(i * B, j * B)
            self._store_back(hash_ids[i:j], k_full[:, sl], v_full[:, sl], i)
            i = j
        if n_total > usable:
            sl = slice(usable * B, n_total * B)
            self._store_back(hash_ids[usable:n_total], k_full[:, sl],
                             v_full[:, sl], usable)

        reused = d0 + n_skip + n_tail
        self.counters["reused_blocks"] += reused
        self.counters["computed_tokens"] += S - reused * B
        self.counters["requests"] += 1
        self.counters["ssd_loaded_blocks"] += n_tail
        self.counters["overlapped_requests"] += 1
        self.counters["fallback_blocks"] += n - usable
        self.counters["peer_blocks"] += n_peer
        self.counters["skipped_blocks"] += n_skip
        self.overlap_plans.append(dict(
            prompt_len=S, tiers="".join(t[0] for t in plan.tiers),
            split=s, dram_head=d0, head_recompute=ov.head_recompute,
            head_skipped=n_skip, loaded_tail=n_tail, fallback=n - usable,
            t_compute_block_s=tc, t_load_block_s=tl,
            t_overlapped_s=ov.t_overlapped, t_blocking_s=ov.t_blocking,
            barrier_s=t_barrier))
        return PrefillResult(
            first_token=first, kv_k=k_full, kv_v=v_full, prompt_len=S,
            reused_blocks=reused, new_blocks=n_total - reused,
            ssd_blocks=n_tail, peer_blocks=n_peer, overlapped=True,
            skipped_blocks=n_skip,
            **self._stage_result(hash_ids, k_full, v_full, S))


@dataclass
class _Slot:
    """One occupied decode-batch slot. ``prompt_len`` is the KV depth the
    slot JOINED at; ``final_len`` the depth at completion — the growth
    reservation bound, invariant across preempt/restore cycles."""
    request: ServingRequest
    prompt_len: int
    final_len: int
    emitted: list = field(default_factory=list)

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def done(self) -> bool:
        return len(self.emitted) >= self.request.max_new


@dataclass
class PreemptedRun:
    """A victim slot's decode state after ``DecodeWorker.preempt``: the
    exported KV (ownership moved out of the device pool) plus what
    ``join(..., resume_emitted=...)`` needs to resume exactly.
    ``n_tokens`` = prompt + all but the last emitted token."""
    request: ServingRequest
    emitted: list
    n_tokens: int
    k: torch.Tensor             # (L, n_tokens, KV, Dh) host copies
    v: torch.Tensor


def _pow2_ceil(n: int) -> int:
    w = 1
    while w < n:
        w *= 2
    return w


def plan_width_buckets(needs: list[int], max_pages: int,
                       max_buckets: int = 1) -> list[int]:
    """Block-table widths (descending) for one decode step over slots
    needing ``needs`` pages each: powers of two capped at ``max_pages``;
    with ``max_buckets=1`` the single width is the deepest slot's."""
    widths = sorted({min(_pow2_ceil(n), max_pages) for n in needs},
                    reverse=True)
    return widths[:max(max_buckets, 1)] or [1]


def decode_graphable(cfg: ModelConfig, device, mesh,
                     width_buckets: int) -> bool:
    """Whether ``DecodeWorker``'s paged step replays as CUDA graphs
    (``serving/decode_graphs.py``): on a CUDA device, unsharded, one
    table width a step and no experts. The sharded step, the bucketed
    sub-batches (whose row counts vary) and MoE routing (not
    shape-static) stay eager, as does every step on the CPU."""
    return (torch.device(device).type == "cuda" and mesh is None
            and width_buckets == 1 and cfg.moe is None)


def bucket_width(need: int, plan: list[int], max_pages: int) -> int:
    """Smallest plan width covering ``need`` pages."""
    n2 = min(_pow2_ceil(need), max_pages)
    for w in reversed(plan):
        if w >= n2:
            return w
    return plan[0]


class DecodeWorker:
    """§3 step 4: continuous batching with per-slot cache depths, on the
    device the parameters live on.

    * ``substrate="paged"`` (default): slots attend the shared
      ``DevicePagePool`` through a block table; ``join()`` ADOPTS the
      staged page run (a host-side list splice), ``step()`` runs the
      paged decode kernel per layer over the live page span (the table
      sliced to the deepest active slot, padded to a power of two). On
      a CUDA device (``decode_graphable``) the step replays one CUDA
      graph per table width (``DecodeGraphs``).
    * ``substrate="dense"``: an (L, B, max_len) arena — the exactness
      oracle.

    ``mesh`` (or a ``page_pool`` built with one) shards the paged step
    over a (data, model) mesh: the slots split into one contiguous row
    group per data shard, each adopting and growing pages in its own
    bank of the pool, and KV heads stripe over the model axis.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int,
                 max_len: int, substrate: str = "paged",
                 page_pool: Optional[DevicePagePool] = None,
                 page_tokens: int = 64, width_buckets: int = 1,
                 mesh=None) -> None:
        if substrate not in ("paged", "dense"):
            raise ValueError(f"unknown decode substrate {substrate!r}")
        if substrate == "dense" and cfg.sliding_window \
                and max_len > cfg.sliding_window:
            # the reference's dense arena is window-sized (init_caches'
            # eff_window): a slot past the window would have its writes
            # silently clamped to the last slot
            raise ValueError(
                f"dense decode of {cfg.name} with max_len {max_len} past "
                f"its {cfg.sliding_window}-token sliding window: the "
                f"reference's window-sized arena silently clamps writes "
                f"past the window, so the port refuses it — decode on the "
                f"paged substrate")
        reason = kv_worker_refusal(cfg)
        if reason:
            # the reference's dense join copies KV only and would leave a
            # joined slot's SSM state at zero, and an encoder-decoder's
            # slot without cross-attention K/V; refuse rather than decode
            # from an empty state
            raise ValueError(f"DecodeWorker joins KV caches: {reason}")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.substrate = substrate
        self.width_buckets = max(int(width_buckets), 1)
        self.slots: list[Optional[_Slot]] = [None] * max_batch
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.int64,
                                  device=self.device)
        self.counters = dict(zero_copy_joins=0, staged_joins=0, steps=0,
                             preemptions=0, resumed_joins=0,
                             bucket_substeps=0, paged_calls=0,
                             graph_captures=0, graph_replays=0)
        self.mesh = None
        self._graphs: Optional[DecodeGraphs] = None
        if substrate == "paged":
            if page_pool is not None:
                if mesh is not None and mesh is not page_pool.mesh:
                    raise ValueError(
                        "mesh= disagrees with page_pool.mesh — the pool's "
                        "banking fixes the decode mesh; pass one of them")
                mesh = page_pool.mesh
            d = 1 if mesh is None else int(mesh.shape.get("data", 1))
            if max_batch % d:
                raise ValueError(
                    f"max_batch={max_batch} must divide over the mesh's "
                    f"data axis ({d}) — slots partition into per-shard "
                    f"row groups")
            if mesh is not None:
                m = int(mesh.shape.get("model", 1))
                reason = paged_shard_reason(cfg, m, d)
                if reason:
                    raise ValueError(
                        f"cannot shard paged decode over {d}x{m}: {reason}")
            if page_pool is None:
                # standalone sizing (per bank): every slot of the bank at
                # full depth + one extra sequence of staging headroom
                per_seq = (max_len + page_tokens - 1) // page_tokens
                page_pool = DevicePagePool(
                    cfg, n_pages=1 + (max_batch // d + 1) * per_seq,
                    page_tokens=page_tokens, device=self.device, mesh=mesh)
            self.page_pool = page_pool
            self.mesh = mesh
            self.slots_per_bank = max_batch // page_pool.n_banks
            if self.width_buckets > 1 and mesh is not None:
                raise ValueError(
                    "width_buckets>1 sub-batches the step, which breaks "
                    "the mesh's even data-axis row split — pick one")
            # the weights once per distinct mesh device
            self._replicas = None if mesh is None \
                else replicate_params(params, mesh)
            pt = page_pool.page_tokens
            self.max_pages = (max_len + pt - 1) // pt
            self.block_table = np.zeros((max_batch, self.max_pages), np.int32)
            self.seq_lens = np.zeros(max_batch, np.int32)
            self.n_pages_slot = np.zeros(max_batch, np.int32)
            self.caches = None
            if decode_graphable(cfg, self.device, mesh, self.width_buckets):
                self._graphs = DecodeGraphs(
                    self._unsharded_step, max_batch, self.max_pages,
                    self.device, CudaCapture(self.device))
        else:
            self.page_pool = None
            c = init_caches(cfg, max_batch, max_len, device=self.device)
            self.caches = c._replace(length=torch.zeros(
                max_batch, dtype=torch.int32, device=self.device))

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    @property
    def has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    def reserved_growth_pages(self) -> int:
        """Worst-case device pages the active slots may still allocate
        (growth to their final length + one COW each)."""
        if self.substrate != "paged":
            return 0
        pt = self.page_pool.page_tokens
        need = 0
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            held = int(self.n_pages_slot[i])
            need += max(-(-s.final_len // pt) - held, 0) + 1
        return need

    # ---- paged-substrate plumbing --------------------------------------
    def _slot_bank(self, slot: int) -> int:
        """Data-shard bank of a batch slot: slots partition into
        contiguous per-bank row groups, so the sharded step's row split
        lands each group on the shard holding its pages."""
        return slot // self.slots_per_bank

    def _pick_slot(self, pref_bank: Optional[int]) -> int:
        """Free slot for a join: the staged run's own bank when it has
        room (zero-copy adoption needs slot bank == page bank), else the
        bank with the most free slots (load-balances the data shards)."""
        free_by_bank: dict[int, int] = {}
        for i, s in enumerate(self.slots):
            if s is None:
                free_by_bank.setdefault(self._slot_bank(i), i)
        if pref_bank is not None and pref_bank in free_by_bank:
            return free_by_bank[pref_bank]
        counts = {b: sum(1 for i, s in enumerate(self.slots)
                         if s is None and self._slot_bank(i) == b)
                  for b in free_by_bank}
        bank = max(counts, key=lambda b: (counts[b], -b))
        return free_by_bank[bank]

    def _adopt_pages(self, pres: PrefillResult, bank: int = 0) -> list[int]:
        """Take a reference on the request's page run: zero-copy when the
        prefill staged into OUR pool's target bank (the first join
        consumes the staging reference; later joins share the run), else
        stage a copy into ``bank``. A run staged into a DIFFERENT bank is
        re-staged (the slot's data shard attends only its own bank) and
        this join consumes the staging reference."""
        pp = self.page_pool
        same_bank = (pres.pages is not None and pres.page_pool is pp
                     and (not pres.pages
                          or pp.bank_of(pres.pages[0]) == bank))
        if same_bank:
            pages = list(pres.pages)
            if pres._pages_adopted:
                # late share: verify no page was freed and recycled since
                if pp.gens_of(pages) != pres.page_gens:
                    raise RuntimeError(
                        "stale page run: this PrefillResult's pages were "
                        "released (its joined slots finished) and re-used; "
                        "re-prefill instead of re-joining")
                pp.retain(pages)
            else:
                pres._pages_adopted = True
            self.counters["zero_copy_joins"] += 1
            return pages
        hash_ids = pres.hash_ids if pres.hash_ids is not None else []
        pages = stage_run(pp, hash_ids, pres.kv_k, pres.kv_v,
                          pres.prompt_len, bank=bank)
        if pages is None:
            raise MemoryError("device page pool cannot hold the request")
        if pres.page_pool is pp:
            pres.release_pages()    # cross-bank copy consumes the staging ref
        self.counters["staged_joins"] += 1
        return pages

    def _free_slot_pages(self, slot: int) -> None:
        n = int(self.n_pages_slot[slot])
        self.page_pool.release([int(p) for p in self.block_table[slot, :n]])
        self.block_table[slot] = 0
        self.seq_lens[slot] = 0
        self.n_pages_slot[slot] = 0

    def join(self, request: ServingRequest, pres: PrefillResult, *,
             resume_emitted: Optional[list] = None) -> int:
        """Add a prefilled request to the continuous batch. Paged:
        adoption of the staged page run. ``resume_emitted`` re-joins a
        preempted victim from its restored run; the stream continues from
        ``resume_emitted[-1]`` with the completion bound unchanged."""
        if not self.has_free_slot:
            raise RuntimeError(
                f"decode batch full: all {self.max_batch} slots occupied — "
                f"check has_free_slot before join")
        with spans.span("decode.join", req_id=request.req_id):
            if self.substrate == "paged" and self.page_pool.n_banks > 1:
                pref = None
                if pres.pages and pres.page_pool is self.page_pool:
                    pref = self.page_pool.bank_of(pres.pages[0])
                slot = self._pick_slot(pref)
            else:
                slot = self.slots.index(None)
            L = pres.prompt_len
            n_emit = 0
            if resume_emitted is not None:
                n_emit = len(resume_emitted)
                if not 1 <= n_emit < request.max_new:
                    raise ValueError(
                        f"resume_emitted carries {n_emit} tokens; a "
                        f"resumable victim has emitted at least 1 and "
                        f"fewer than max_new={request.max_new}")
            final_len = L + request.max_new - max(n_emit - 1, 0)
            if final_len > self.max_len:
                raise ValueError(
                    f"prompt ({L}) + remaining new tokens exceeds max_len "
                    f"({self.max_len}) — the slot would outgrow its KV "
                    f"capacity mid-decode")
            if self.substrate == "paged":
                pages = self._adopt_pages(pres, bank=self._slot_bank(slot))
                assert len(pages) <= self.max_pages, (
                    f"prompt needs {len(pages)} pages > max_len's "
                    f"{self.max_pages}")
                self.block_table[slot, :len(pages)] = pages
                self.block_table[slot, len(pages):] = 0
                self.n_pages_slot[slot] = len(pages)
                self.seq_lens[slot] = L
            else:
                kv = self.caches.kv
                kv.k[:, slot, :L] = pres.kv_k[:, :L].to(self.device)
                kv.v[:, slot, :L] = pres.kv_v[:, :L].to(self.device)
                self.caches.length[slot] = L
            if resume_emitted is not None:
                first = int(resume_emitted[-1])
                emitted = list(resume_emitted)
                self.counters["resumed_joins"] += 1
            else:
                first = pres.first_token
                emitted = [pres.first_token]
            self.tokens[slot, 0] = first
            self.slots[slot] = _Slot(request=request, prompt_len=L,
                                     final_len=final_len, emitted=emitted)
            return slot

    def preempt(self, slot: int) -> PreemptedRun:
        """Victim-evict an active slot: export its live page run to host
        bytes (ownership moves into the returned run) and free the slot.
        Registered prefix blocks stay in the registry. Paged only."""
        if self.substrate != "paged":
            raise RuntimeError(
                "preempt() requires the paged substrate — the dense arena "
                "frees no reclaimable device pages")
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"preempt of empty slot {slot}")
        n_tokens = int(self.seq_lens[slot])
        n = int(self.n_pages_slot[slot])
        pages = [int(p) for p in self.block_table[slot, :n]]
        k, v = self.page_pool.export_run(pages, n_tokens)
        self.block_table[slot] = 0
        self.seq_lens[slot] = 0
        self.n_pages_slot[slot] = 0
        self.slots[slot] = None
        self.counters["preemptions"] += 1
        return PreemptedRun(request=s.request, emitted=list(s.emitted),
                            n_tokens=n_tokens, k=k, v=v)

    def stats(self) -> dict:
        out = dict(self.counters)
        out["active_slots"] = self.n_active
        out["reserved_growth_pages"] = self.reserved_growth_pages()
        return out

    def _prepare_writes(self, active: list[int]) -> None:
        """Give every active slot an exclusively owned page at its write
        position: a fresh page at a page boundary, COW if shared."""
        pp = self.page_pool
        pt = pp.page_tokens
        with spans.span("decode.prepare"):
            for i in active:
                pidx = int(self.seq_lens[i]) // pt
                if pidx >= self.max_pages:
                    raise RuntimeError(
                        f"slot {i} outgrew its block table (len "
                        f"{int(self.seq_lens[i])} of max_len {self.max_len})")
                if pidx == int(self.n_pages_slot[i]):
                    (pg,) = pp.alloc(1, bank=self._slot_bank(i))
                    self.block_table[i, pidx] = pg
                    self.n_pages_slot[i] += 1
                else:
                    pid = int(self.block_table[i, pidx])
                    new = pp.make_writable(pid)
                    if new != pid:
                        self.block_table[i, pidx] = new

    def _unsharded_step(self, tokens, tbl_d, lens_d) -> tuple:
        """The paged step on device tables → (logits (B, 1, V) fp32, the
        next token of every row (B,))."""
        pp = self.page_pool
        logits, _, _ = decode_step_paged(self.params, tokens, pp.k_pages,
                                         pp.v_pages, tbl_d, lens_d, self.cfg)
        return logits, torch.argmax(logits[:, -1], dim=-1)

    def _paged_call(self, tokens, tbl: np.ndarray, lens: np.ndarray,
                    rows: int) -> tuple:
        """One paged step on a SNAPSHOT of the host tables: the copies
        keep later host mutation (growth, COW, length bumps) away from a
        step still reading them (``torch.from_numpy`` aliases). On a mesh
        the step takes BANK-LOCAL page ids: each data shard indexes its
        own bank's slabs. Returns the step's logits (B, 1, V) fp32 and the
        next token of each of the first ``rows`` rows. Replayed as a CUDA
        graph where the worker has graphs, unless the plain-attention
        oracle is on."""
        if self._graphs is not None and not layers._FORCE_PLAIN:
            return self._graph_call(tokens, tbl, lens)
        pp = self.page_pool
        if self.mesh is not None:
            tbl = tbl % pp.bank_pages
        with spans.span("decode.tables"):
            tbl_d = torch.from_numpy(np.array(tbl, np.int32)).to(self.device)
            lens_d = torch.from_numpy(np.array(lens, np.int32)).to(
                self.device)
        with spans.span("decode.dispatch"):
            if self.mesh is None:
                logits, nxt = self._unsharded_step(tokens, tbl_d, lens_d)
            else:
                slabs = pp.slabs
                logits, _, _ = decode_step_paged_sharded(
                    self._replicas, tokens,
                    [[k for k, _ in row] for row in slabs],
                    [[v for _, v in row] for row in slabs], tbl_d, lens_d,
                    self.cfg, self.mesh)
                logits = logits.to(self.device)
                nxt = torch.argmax(logits[:, -1], dim=-1)
            self.counters["paged_calls"] += 1
            return logits, nxt[:rows]

    def _graph_call(self, tokens, tbl: np.ndarray, lens: np.ndarray) -> tuple:
        """``_paged_call`` of a whole-batch step through ``DecodeGraphs``.
        The first step of a width runs eagerly and is then captured; a
        step run again on the same inputs writes the same K/V row into the
        same tail page, which ``_prepare_writes`` made the slot's own, so
        running or replaying a step's inputs more than once is harmless."""
        with spans.span("decode.tables"):
            self._graphs.load(tokens, tbl, lens)
        with spans.span("decode.dispatch"):
            out, replayed = self._graphs.run(tbl.shape[1])
            self.counters["graph_replays" if replayed
                          else "graph_captures"] += 1
            self.counters["paged_calls"] += 1
            return out

    def _step_full(self, active: list[int]) -> torch.Tensor:
        """Single-width full-batch step; per-slot next tokens (B,)."""
        pt = self.page_pool.page_tokens
        need = max(int(self.seq_lens[i]) // pt + 1 for i in active)
        width = min(_pow2_ceil(need), self.max_pages)
        return self._paged_call(self.tokens, self.block_table[:, :width],
                                self.seq_lens, self.max_batch)[1]

    def _step_bucketed(self, active: list[int]) -> torch.Tensor:
        """Width-bucketed step: one sub-batch per pow2 table width, rows
        padded to a power of two with null rows (len 0, table 0). Exact
        with ``_step_full``: every row's computation is row-local."""
        pt = self.page_pool.page_tokens
        needs = {i: int(self.seq_lens[i]) // pt + 1 for i in active}
        plan = plan_width_buckets(list(needs.values()), self.max_pages,
                                  self.width_buckets)
        nxt = torch.zeros(self.max_batch, dtype=torch.int64,
                          device=self.device)
        for w in plan:
            rows = [i for i in active
                    if bucket_width(needs[i], plan, self.max_pages) == w]
            if not rows:
                continue
            nr = _pow2_ceil(len(rows))
            ridx = torch.tensor(rows, device=self.device)
            toks = torch.zeros((nr, 1), dtype=torch.int64,
                               device=self.device)
            toks[:len(rows)] = self.tokens[ridx]
            tbl = np.zeros((nr, w), np.int32)
            tbl[:len(rows)] = self.block_table[rows][:, :w]
            lens = np.zeros(nr, np.int32)
            lens[:len(rows)] = self.seq_lens[rows]
            nxt[ridx] = self._paged_call(toks, tbl, lens, len(rows))[1]
            self.counters["bucket_substeps"] += 1
        return nxt

    def step(self) -> list[tuple[int, int, bool]]:
        """One continuous-batching iteration.
        Returns [(req_id, token, finished)] for active slots."""
        if self.n_active == 0:
            return []
        self.counters["steps"] += 1
        if self.substrate == "paged":
            active = [i for i, s in enumerate(self.slots) if s is not None]
            self._prepare_writes(active)
            if self.width_buckets > 1:
                nxt = self._step_bucketed(active)
            else:
                nxt = self._step_full(active)
            for i in active:
                self.seq_lens[i] += 1
        else:
            with spans.span("decode.dispatch"):
                logits, self.caches = decode_step(self.params, self.tokens,
                                                  self.caches, self.cfg)
                nxt = torch.argmax(logits[:, -1], dim=-1)
        # a replay's tokens are its graph's output, which the width's next
        # replay rewrites: joins write into it before the next step copies
        # it into the graph's input, and that copy precedes the replay
        self.tokens = nxt[:, None].to(torch.int64)
        with spans.span("decode.token_sync"):
            nxt_host = nxt.cpu().numpy()
        out = []
        with spans.span("decode.emit"):
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                tok = int(nxt_host[i])
                s.emitted.append(tok)
                if s.done:
                    out.append((s.req_id, tok, True))
                    self.slots[i] = None
                    if self.substrate == "paged":
                        self._free_slot_pages(i)
                    else:
                        self.caches.length[i] = 0
                else:
                    out.append((s.req_id, tok, False))
        return out


class StateCheckpointWorker:
    """Prefix caching for SSM models: the reference's
    ``StateCheckpointWorker``, on the device the parameters live on.

    Attention-free models have no append-only KVCache; Mooncake's prefix
    reuse becomes *state checkpointing*: after every ``chunk``-token block
    boundary (512 by default) the (constant-size) recurrent state is
    snapshotted to host
    memory, keyed by the same prefix-chained hash as KV blocks. A later
    request sharing a prefix restores the DEEPEST checkpoint on its chain
    and prefills only the suffix — a transfer is O(state), whatever the
    prefix length. ``scan_calls`` counts the model calls that reach the
    SSD scan (all but a one-token extend, which takes the recurrence).
    """

    def __init__(self, params, cfg: ModelConfig, *,
                 capacity_checkpoints: Optional[int] = None,
                 chunk: int = BLOCK_TOKENS) -> None:
        if cfg.kind != "ssm":
            raise ValueError("state checkpointing is the SSM path; "
                             f"{cfg.name} is {cfg.kind}")
        self.params = params
        self.cfg = cfg
        self.chunk = chunk
        self.device = params["embed"].device
        self.meta = StateCache(capacity_checkpoints)
        self.data: dict[int, MambaState] = {}   # hash -> host state copy
        self.counters = dict(restored_tokens=0, computed_tokens=0)
        self.scan_calls = 0

    def _snapshot(self, hash_id: int, caches: Caches) -> None:
        for e in self.meta.insert([hash_id]):
            self.data.pop(e, None)
        if hash_id in self.meta:
            self.data[hash_id] = MambaState(
                ssm=caches.ssm.ssm.to("cpu", copy=True),
                conv=caches.ssm.conv.to("cpu", copy=True))

    def __call__(self, tokens: np.ndarray):
        """Prefill one request (B = 1) with state-checkpoint reuse.
        Returns (first_token, final Caches)."""
        cfg = self.cfg
        S = len(tokens)
        hash_ids = prefix_hash_ids(tokens, self.chunk)
        depth = self.meta.lookup(hash_ids)          # deepest checkpoint
        start = depth * self.chunk
        if start >= S:                              # full hit: redo last blk
            depth -= 1
            start = depth * self.chunk
        t = torch.as_tensor(np.asarray(tokens, np.int64)[None, :],
                            device=self.device)
        caches = None
        if depth > 0:
            st = self.data[hash_ids[depth - 1]]
            caches = Caches(kv=None, length=start, ssm=MambaState(
                ssm=st.ssm.to(self.device), conv=st.conv.to(self.device)))

        # chunked continuation, snapshotting at every block boundary
        logits = None
        lo = start
        while lo < S:
            hi = min(lo + self.chunk, S)
            if caches is None:
                logits, caches = prefill(self.params, t[:, :hi], cfg)
                logits = logits[:, None]
                self.scan_calls += 1
            else:
                logits, caches = decode_step(self.params, t[:, lo:hi],
                                             caches, cfg)
                self.scan_calls += hi - lo > 1
            if hi % self.chunk == 0:
                self._snapshot(hash_ids[hi // self.chunk - 1], caches)
            lo = hi
        self.counters["restored_tokens"] += start
        self.counters["computed_tokens"] += S - start
        first = int(torch.argmax(logits[0, -1]))
        return first, caches

    def stats(self) -> dict:
        """Unified snapshot (cross-component ``stats()`` protocol)."""
        out = dict(self.counters)
        out["checkpoints"] = len(self.data)
        return out
