"""Serving engines of the port — the counterpart of the main-path classes
of the reference's ``repro/serving/engine.py``.

The §3 workflow on the GPU: a host-DRAM KVCache pool holding 512-token
blocks keyed by prefix-chained hashes (``HostKVPool``), a prefill worker
that reuses pool blocks and runs chunked incremental prefill
(``PrefillWorker``/``ChunkedPrefill``) and stores fresh blocks back to
the pool, ``stage_run`` copying a prompt's KV into the shared
``DevicePagePool``, and a continuous-batching decode worker whose slots
sit at independent depths (``DecodeWorker``, paged or dense substrate).

Host KV bytes are CPU tensors; device work runs on the device the
parameters live on. Not ported yet: the SSD tier and its overlapped
load path, peers and the global directory, sharded decode, SSM state
checkpoints.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import CacheTierSpec, ModelConfig
from repro_torch.core.cache import CachePool
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.models.transformer import (Caches, decode_step,
                                            decode_step_paged, init_caches)
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    """Residency snapshot of a hash chain's prefix (DRAM tier only here:
    every resident block's tier is ``"dram"``)."""
    hash_ids: list[int]
    tiers: list[str]

    @property
    def n_resident(self) -> int:
        return len(self.tiers)


class HostKVPool:
    """Flat CPU-DRAM KVCache pool: prefix hash → per-layer KV block bytes
    ((L, 512, KV, Dh) host tensors). Metadata and eviction are delegated
    to ``CachePool``. Also holds the preemption SPILL SLAB: req_id →
    (k, v, n_tokens) of a victim's exported device run (the HBM→DRAM
    rung), keyed per request and popped on restore/abandon."""

    def __init__(self, capacity_blocks: Optional[int] = None,
                 spec: Optional[CacheTierSpec] = None) -> None:
        if spec is None:
            spec = CacheTierSpec(dram_blocks=capacity_blocks)
        self.spec = spec
        self.meta: CachePool = spec.make_pool()
        self.data: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # written by the serving-loop thread, read by stats() from any
        # thread — hence its own lock
        self._spill_lock = threading.Lock()
        self._spill: dict[int, tuple] = {}  #: guarded_by self._spill_lock
        #: guarded_by self._spill_lock
        self._spill_counters = dict(spills=0, spill_restores=0,
                                    spill_drops=0)

    def plan_fetch(self, hash_ids: list[int]) -> FetchPlan:
        """Residency snapshot of the chain's prefix (no side effects)."""
        tiers: list[str] = []
        for h in hash_ids:
            if h not in self.meta:
                break
            tiers.append("dram")
        return FetchPlan(list(hash_ids), tiers)

    def match_prefix(self, hash_ids: list[int]) -> int:
        return self.meta.lookup(hash_ids)

    def get(self, hash_ids: list[int]):
        """Stack blocks → (L, n·512, KV, Dh) k and v host tensors."""
        ks, vs = [], []
        for h in hash_ids:
            kv = self.data.get(h)
            if kv is None:
                raise KeyError(f"block {h} has no bytes")
            ks.append(kv[0])
            vs.append(kv[1])
        return torch.cat(ks, dim=1), torch.cat(vs, dim=1)

    def put(self, hash_ids: list[int], k: torch.Tensor, v: torch.Tensor,
            start_pos: int = 0) -> None:
        """k/v (L, n·512, KV, Dh) host tensors covering ``hash_ids``."""
        for e in self.meta.insert(hash_ids, start_pos=start_pos):
            self.data.pop(e, None)
        for i, h in enumerate(hash_ids):
            if h not in self.meta or h in self.data:
                continue
            sl = slice(i * BLOCK_TOKENS, (i + 1) * BLOCK_TOKENS)
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

    @property
    def n_blocks(self) -> int:
        return len(self.data)

    def stats(self) -> dict:
        out = dict(dram_blocks=len(self.data), total_blocks=self.n_blocks)
        with self._spill_lock:
            out.update(self._spill_counters)
            out["spill_entries"] = len(self._spill)
            out["spill_bytes"] = sum(
                k.numel() * k.element_size() + v.numel() * v.element_size()
                for k, v, _ in self._spill.values())
        return out

    def close(self) -> None:
        with self._spill_lock:
            self._spill.clear()


@dataclass
class PrefillResult:
    first_token: int
    kv_k: torch.Tensor          # (L, S, KV, Dh) full-depth host KV
    kv_v: torch.Tensor
    prompt_len: int
    reused_blocks: int
    new_blocks: int
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


def stage_run(pool: Optional[DevicePagePool], hash_ids: list[int], k_full,
              v_full, S: int) -> Optional[list[int]]:
    """Stage a request's KV into a page run (§3 step 2: fresh pages
    written layer-stacked; step 1: registered prefix runs ADOPTED — the
    physical pages are shared, no bytes move). Full 512-token blocks
    register under their chain hash; the partial tail gets private pages.
    The caller owns one reference per returned page. Returns None
    (nothing held) if the pool can't fit the run even after evicting
    registry-only runs."""
    if pool is None:
        return None
    B = BLOCK_TOKENS
    n_full = len(hash_ids)
    held: list[int] = []
    try:
        adopted, pages = pool.adopt_chain(hash_ids)
        held = list(pages)
        for i in range(adopted, n_full):
            run = pool.alloc(pool.pages_per_block)
            held += run
            pool.write_run(run, k_full[:, i * B:(i + 1) * B],
                           v_full[:, i * B:(i + 1) * B])
            pool.register_block(hash_ids[i], run)
            pages += run
        tail = S - n_full * B
        if tail > 0:
            run = pool.alloc(pool.pages_for(tail))
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
    interleave unit. ``advance()`` runs exactly one device chunk and
    returns True once the request is complete (result in ``.result``).
    Draining it in one go IS the blocking path."""

    def __init__(self, worker: "PrefillWorker", tokens: np.ndarray,
                 session=None) -> None:
        self.result: Optional[PrefillResult] = None
        self._gen = worker._chunks(np.asarray(tokens), session)

    def advance(self) -> bool:
        if self.result is not None:
            return True
        try:
            next(self._gen)
            return False
        except StopIteration as e:
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
    device the parameters live on. Every prefill is chunk-resumable:
    ``start()`` returns a ``ChunkedPrefill``; ``__call__`` drains it."""

    def __init__(self, params, cfg: ModelConfig, pool: HostKVPool, *,
                 prefill_chunk: int = 1024,
                 page_pool: Optional[DevicePagePool] = None) -> None:
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.chunk = prefill_chunk
        self.page_pool = page_pool
        self.device = params["embed"].device
        self.hasher = PrefixHasher()
        self.counters = dict(reused_blocks=0, computed_tokens=0, requests=0,
                             page_oom=0, chunks=0, stage_deferred=0)
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
        t0 = time.monotonic()
        logits, caches = decode_step(self.params, t[:, lo:hi], caches,
                                     self.cfg)
        _sync(self.device)
        self._note_compute(hi - lo, time.monotonic() - t0)
        self.counters["chunks"] += 1
        return logits, caches

    def _stage(self, hash_ids, k_full, v_full, S) -> Optional[list[int]]:
        if self.page_pool is not None and self.stage_guard is not None \
                and not self.stage_guard(self.page_pool.pages_for(S)):
            self.counters["stage_deferred"] += 1
            return None
        pages = stage_run(self.page_pool, hash_ids, k_full, v_full, S)
        if pages is None and self.page_pool is not None:
            self.counters["page_oom"] += 1
        return pages

    def stats(self) -> dict:
        out = dict(self.counters)
        out["hash_blocks"] = self.hasher.blocks_hashed
        out["hash_memo_hits"] = self.hasher.memo_hits
        return out

    def start(self, tokens: np.ndarray, session=None) -> ChunkedPrefill:
        return ChunkedPrefill(self, tokens, session=session)

    def __call__(self, tokens: np.ndarray, session=None) -> PrefillResult:
        return self.start(tokens, session=session).drain()

    def _chunks(self, tokens: np.ndarray, session=None):
        """Generator behind ``ChunkedPrefill``: yields between device
        chunks; its StopIteration value is the ``PrefillResult``."""
        cfg = self.cfg
        S = len(tokens)
        hash_ids = self.hasher.hash_ids(tokens, session=session)
        n_hit = self.pool.match_prefix(hash_ids)
        prefix_tokens = n_hit * BLOCK_TOKENS
        if prefix_tokens >= S:           # full hit: recompute last block's
            n_hit = max((S - 1) // BLOCK_TOKENS, 0)  # tail to get logits
            prefix_tokens = n_hit * BLOCK_TOKENS

        t = torch.as_tensor(np.asarray(tokens, np.int64)[None, :],
                            device=self.device)
        caches = init_caches(cfg, 1, S, device=self.device)
        if n_hit:
            k_h, v_h = self.pool.get(hash_ids[:n_hit])
            caches.kv.k[:, 0, :prefix_tokens] = k_h.to(self.device)
            caches.kv.v[:, 0, :prefix_tokens] = v_h.to(self.device)
        caches = caches._replace(length=prefix_tokens)
        # chunked incremental prefill over the uncached suffix (a cold
        # request is the n_hit = 0 case)
        logits = None
        for lo in range(prefix_tokens, S, self.chunk):
            hi = min(lo + self.chunk, S)
            logits, caches = self._chunk_extend(t, caches, lo, hi)
            if hi < S:
                yield               # suspension point for the serving loop
        first = int(torch.argmax(logits[0, -1]))
        k_full = caches.kv.k[:, 0].to("cpu", copy=True)
        v_full = caches.kv.v[:, 0].to("cpu", copy=True)

        # store-back of every fresh full block to the host pool
        n_total = len(hash_ids)
        if n_total > n_hit:
            sl = slice(n_hit * BLOCK_TOKENS, n_total * BLOCK_TOKENS)
            self.pool.put(hash_ids[n_hit:], k_full[:, sl], v_full[:, sl],
                          start_pos=n_hit)
        self.counters["reused_blocks"] += n_hit
        self.counters["computed_tokens"] += S - prefix_tokens
        self.counters["requests"] += 1
        pages = self._stage(hash_ids, k_full, v_full, S)
        return PrefillResult(
            first_token=first, kv_k=k_full, kv_v=v_full, prompt_len=S,
            reused_blocks=n_hit, new_blocks=n_total - n_hit,
            hash_ids=hash_ids, pages=pages, page_pool=self.page_pool,
            page_gens=None if pages is None else self.page_pool.gens_of(pages))


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
      sliced to the deepest active slot, padded to a power of two).
    * ``substrate="dense"``: an (L, B, max_len) arena — the exactness
      oracle.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int,
                 max_len: int, substrate: str = "paged",
                 page_pool: Optional[DevicePagePool] = None,
                 page_tokens: int = 64, width_buckets: int = 1) -> None:
        if substrate not in ("paged", "dense"):
            raise ValueError(f"unknown decode substrate {substrate!r}")
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
                             bucket_substeps=0, paged_calls=0)
        if substrate == "paged":
            if page_pool is None:
                # standalone sizing: every slot at full depth + one extra
                # sequence of staging headroom
                per_seq = (max_len + page_tokens - 1) // page_tokens
                page_pool = DevicePagePool(
                    cfg, n_pages=1 + (max_batch + 1) * per_seq,
                    page_tokens=page_tokens, device=self.device)
            self.page_pool = page_pool
            pt = page_pool.page_tokens
            self.max_pages = (max_len + pt - 1) // pt
            self.block_table = np.zeros((max_batch, self.max_pages), np.int32)
            self.seq_lens = np.zeros(max_batch, np.int32)
            self.n_pages_slot = np.zeros(max_batch, np.int32)
            self.caches = None
        else:
            self.page_pool = None
            c = init_caches(cfg, max_batch, max_len, device=self.device)
            self.caches = c._replace(length=torch.zeros(
                max_batch, dtype=torch.int32, device=self.device))

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

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
    def _adopt_pages(self, pres: PrefillResult) -> list[int]:
        """Take a reference on the request's page run: zero-copy when the
        prefill staged into OUR pool (the first join consumes the staging
        reference; later joins share the run), else stage a copy."""
        pp = self.page_pool
        if pres.pages is not None and pres.page_pool is pp:
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
        pages = stage_run(pp, hash_ids, pres.kv_k, pres.kv_v, pres.prompt_len)
        if pages is None:
            raise MemoryError("device page pool cannot hold the request")
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
        slot = self.slots.index(None)
        L = pres.prompt_len
        n_emit = 0
        if resume_emitted is not None:
            n_emit = len(resume_emitted)
            if not 1 <= n_emit < request.max_new:
                raise ValueError(
                    f"resume_emitted carries {n_emit} tokens; a resumable "
                    f"victim has emitted at least 1 and fewer than "
                    f"max_new={request.max_new}")
        final_len = L + request.max_new - max(n_emit - 1, 0)
        if final_len > self.max_len:
            raise ValueError(
                f"prompt ({L}) + remaining new tokens exceeds max_len "
                f"({self.max_len}) — the slot would outgrow its KV capacity "
                f"mid-decode")
        if self.substrate == "paged":
            pages = self._adopt_pages(pres)
            assert len(pages) <= self.max_pages, \
                f"prompt needs {len(pages)} pages > max_len's {self.max_pages}"
            self.block_table[slot, :len(pages)] = pages
            self.block_table[slot, len(pages):] = 0
            self.n_pages_slot[slot] = len(pages)
            self.seq_lens[slot] = L
        else:
            self.caches.kv.k[:, slot, :L] = pres.kv_k[:, :L].to(self.device)
            self.caches.kv.v[:, slot, :L] = pres.kv_v[:, :L].to(self.device)
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
        for i in active:
            pidx = int(self.seq_lens[i]) // pt
            if pidx >= self.max_pages:
                raise RuntimeError(
                    f"slot {i} outgrew its block table (len "
                    f"{int(self.seq_lens[i])} of max_len {self.max_len})")
            if pidx == int(self.n_pages_slot[i]):
                (pg,) = pp.alloc(1)
                self.block_table[i, pidx] = pg
                self.n_pages_slot[i] += 1
            else:
                pid = int(self.block_table[i, pidx])
                new = pp.make_writable(pid)
                if new != pid:
                    self.block_table[i, pidx] = new

    def _paged_call(self, tokens, tbl: np.ndarray, lens: np.ndarray):
        """One paged step on a SNAPSHOT of the host tables: the copies
        keep later host mutation (growth, COW, length bumps) away from a
        step still reading them (``torch.from_numpy`` aliases)."""
        pp = self.page_pool
        tbl_d = torch.from_numpy(np.array(tbl, np.int32)).to(self.device)
        lens_d = torch.from_numpy(np.array(lens, np.int32)).to(self.device)
        logits, _, _ = decode_step_paged(self.params, tokens, pp.k_pages,
                                         pp.v_pages, tbl_d, lens_d, self.cfg)
        self.counters["paged_calls"] += 1
        return logits

    def _step_full(self, active: list[int]) -> torch.Tensor:
        """Single-width full-batch step; per-slot next tokens (B,)."""
        pt = self.page_pool.page_tokens
        need = max(int(self.seq_lens[i]) // pt + 1 for i in active)
        width = min(_pow2_ceil(need), self.max_pages)
        logits = self._paged_call(self.tokens, self.block_table[:, :width],
                                  self.seq_lens)
        return torch.argmax(logits[:, -1], dim=-1)

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
            logits = self._paged_call(toks, tbl, lens)
            nxt[ridx] = torch.argmax(logits[:len(rows), -1], dim=-1)
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
            logits, self.caches = decode_step(self.params, self.tokens,
                                              self.caches, self.cfg)
            nxt = torch.argmax(logits[:, -1], dim=-1)
        self.tokens = nxt[:, None].to(torch.int64)
        nxt_host = nxt.cpu().numpy()
        out = []
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
