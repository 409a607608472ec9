"""Always-on serving loop: continuous batching with interleaved chunked
prefill (§3's workflow as ONE iteration instead of phase-at-a-time).
The port's copy of the reference's ``repro/serving/loop.py``: the loop
is host logic and is unchanged; the device work happens in the workers.

``ServingLoop`` owns one ``DecodeWorker`` (and through it the shared
``DevicePagePool``) plus N ``PrefillWorker``s, and pulls requests from a
thread-fed arrival queue. Each iteration:

    arrivals → joins → one decode step → prefill chunks in the slack

* **Admission** happens at ``submit()`` against a ``BackpressureSignal``
  snapshot (queue depth, slot occupancy, in-flight prefills, pinned page
  fraction, spilled victims) evaluated by a registered admission policy
  kind — the live engine's counterpart of §7's early/predictive
  rejection. A rejected request never consumes compute. The queue-cap
  check and the enqueue are one atomic step under the loop lock, so
  concurrent submitters cannot race past ``max_queue``.
* **Joins** are slot-level and PRIORITY-ORDERED: finished prefills enter
  the decode batch through ``DecodeWorker.join`` highest priority first
  (FIFO within a class); a join that hits device-page OOM is deferred
  and retried once decodes release pages.
* **Preemption** (``preempt=True``, paged substrate): when a pending
  join can not become obtainable by waiting — the headroom guard says
  active slots' reserved growth plus the candidate exceed what is free
  or evictable — and a STRICTLY lower-priority slot is active, the loop
  spills victims (lowest priority first, then shallowest progress) to
  the ``HostKVPool`` via ``DecodeWorker.preempt``/``export_run`` (the
  device→host demotion rung), joins the competing request, and re-joins
  each victim later from its spilled KV: either RELOADED through the
  ``stage_run`` staging path or RECOMPUTED through chunked prefill,
  priced per ``plan_restore``. Restored streams are bit-exact with a
  never-preempted run.
* **Chunked prefill interleave**: prefills advance one device chunk at a
  time (``ChunkedPrefill.advance``) between decode steps. With a
  ``tbt_budget_s`` the loop fits as many chunks as the measured chunk EMA
  says fit in the slack the budget leaves after a decode step (always at
  least one whenever any decode slot would otherwise starve prefill);
  with no budget it runs a fixed ``chunks_per_iter`` — deterministic, the
  mode tests and the gated benchmark use.

Because chunk boundaries are suspension points of the SAME generator the
blocking ``PrefillWorker.__call__`` drains, every emitted token is
bit-exact with the request-at-a-time oracle regardless of how the loop
slices the work.

The public surface speaks ``ServingRequest``/``RequestOutput``
(``repro_torch.serving.request``).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.policies.admission import BackpressureSignal
from repro_torch.core.policies.base import get_policy
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.serving.engine import (ChunkedPrefill, DecodeWorker,
                                        PrefillResult, PrefillWorker,
                                        plan_restore, stage_run)
from repro_torch.serving.request import RequestOutput, ServingRequest


@dataclass
class _Active:
    """A request whose prefill is mid-chunks on some worker. ``emitted``
    is set for a recompute-restore replay: the victim's already-emitted
    tokens, to resume from once the re-prefill finishes."""
    request: ServingRequest
    cp: ChunkedPrefill
    worker_idx: int
    emitted: Optional[list] = None


@dataclass
class _Pending:
    """A unit waiting to enter the decode batch.

    * ``kind="join"``: a finished prefill (``pres`` set); ``emitted`` is
      not None when it replays a recompute restore.
    * ``kind="restore"``: a spilled victim; ``pres`` is None until the
      loop prices the restore and (reload arm) stages the spilled bytes.

    ``n_tokens`` is the KV depth the entry joins at; ``seq`` keeps FIFO
    order within a priority class.
    """
    request: ServingRequest
    pres: Optional[PrefillResult]
    n_tokens: int
    seq: int
    kind: str = "join"
    emitted: Optional[list] = None


class ServingLoop:
    """Continuous-batching loop over one decode worker + N prefill workers.

    ``submit()`` is thread-safe (any number of client threads feed the
    arrival queue); ``run()`` is the engine thread. ``tbt_budget_s=None``
    selects the deterministic interleave (exactly ``chunks_per_iter``
    prefill chunks between decode steps).

    ``preempt=False`` restores the defer-only behaviour (joins wait for
    decodes to release pages, never reclaim them) — the benchmark's
    comparison arm. ``restore_mode`` pins the victim-restore arm
    (``"reload"``/``"recompute"``) or prices it per restore (``"auto"``).
    ``spill_pool`` names the ``HostKVPool`` that parks spilled KV
    (default: the first prefill worker's pool).
    """

    def __init__(self, prefill_workers: list[PrefillWorker],
                 decode_worker: DecodeWorker, *,
                 tbt_budget_s: Optional[float] = None,
                 chunks_per_iter: int = 1, max_queue: int = 64,
                 admission: str = "predictive",
                 preempt: bool = True, restore_mode: str = "auto",
                 spill_pool=None) -> None:
        assert prefill_workers, "need at least one PrefillWorker"
        if restore_mode not in ("auto", "reload", "recompute"):
            raise ValueError(f"unknown restore_mode {restore_mode!r}")
        self.pws = list(prefill_workers)
        self.dw = decode_worker
        self.page_pool = decode_worker.page_pool
        self.tbt_budget_s = tbt_budget_s
        self.chunks_per_iter = max(chunks_per_iter, 1)
        self.max_queue = max_queue
        self.policy = get_policy("admission", admission)
        self.preempt = preempt
        self.restore_mode = restore_mode
        self.spill_pool = spill_pool if spill_pool is not None \
            else self.pws[0].pool
        self._arrivals: "queue.Queue[ServingRequest]" = queue.Queue()
        # guards the client-visible flags/counters that submit() threads
        # and the engine thread both touch
        self._lock = threading.Lock()
        self._intake_open = True              #: guarded_by self._lock
        self._stopping = False                #: guarded_by self._lock
        # engine-thread state
        self._active: list[_Active] = []      # prefills mid-chunks
        self._pending_join: list[_Pending] = []
        self._busy: set[int] = set()          # worker idx with a live gen
        self._rr = 0                          # chunk round-robin cursor
        self._seq = 0                         # FIFO tiebreak for pendings
        self._iter = 0                        # engine-local iteration count
        self._t_step_ema: Optional[float] = None
        self._t_reload_ema: Optional[float] = None   # s / spilled block
        self.outputs: dict[int, RequestOutput] = {}
        #: guarded_by self._lock
        self._counters = dict(
            submitted=0, rejected=0, joined=0, completed=0,
            decode_steps=0, prefill_chunks=0, join_oom=0, iterations=0,
            preemptions=0, pages_spilled=0, restores_reload=0,
            restores_recompute=0)
        # keep staged-but-unjoined prefills from eating the decode
        # batch's reserved growth pages (staging retries at join time)
        for pw in self.pws:
            if pw.page_pool is self.page_pool:
                pw.stage_guard = self._stage_headroom_ok

    # ---- client side ---------------------------------------------------
    def signal(self) -> BackpressureSignal:
        """Live occupancy snapshot the admission policy evaluates."""
        pressure = self.page_pool.pressure() if self.page_pool is not None \
            else {}
        return BackpressureSignal(
            queue_depth=self._arrivals.qsize(),
            queue_capacity=self.max_queue,
            slots_used=self.dw.n_active,
            slots_total=self.dw.max_batch,
            prefills_active=len(self._active) + len(self._pending_join),
            pages_pinned=pressure.get("pinned", 0),
            pages_total=pressure.get("capacity", 0),
            spilled=self.spill_pool.spill_depth())

    def submit(self, request: ServingRequest) -> bool:
        """Offer a ``ServingRequest``; False = shed by backpressure
        (nothing ran). The queue-cap check and the enqueue are atomic
        under the loop lock (concurrent submitters can not race past
        ``max_queue``)."""
        if request.tokens is None:
            raise ValueError("ServingRequest.tokens is required for submit")
        if not self._intake_is_open():
            raise RuntimeError("serving loop intake is closed")
        with self._lock:
            self._counters["submitted"] += 1
            if self._arrivals.qsize() >= self.max_queue \
                    or not self.policy.engine_admit(self.signal(),
                                                    request.priority):
                self._counters["rejected"] += 1
                return False
            self._arrivals.put(request)
        return True

    def close_intake(self) -> None:
        """No more submits; ``run()`` returns once in-flight work drains."""
        with self._lock:
            self._intake_open = False

    def stop(self) -> None:
        """Abandon queued + mid-prefill work and spilled victims; finish
        active decodes."""
        with self._lock:
            self._stopping = True
            self._intake_open = False

    def _intake_is_open(self) -> bool:
        with self._lock:
            return self._intake_open

    def _stop_requested(self) -> bool:
        with self._lock:
            return self._stopping

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] += n

    # ---- engine side ---------------------------------------------------
    @property
    def idle(self) -> bool:
        return (self._arrivals.empty() and not self._active
                and not self._pending_join and self.dw.n_active == 0)

    def run(self) -> dict:
        """Drive iterations until intake is closed and everything drained.
        Returns a final ``stats()`` snapshot."""
        while not (self.idle and not self._intake_is_open()):
            if self._stop_requested():
                self._drop_pending()
                if self.dw.n_active == 0:
                    break
            self._iteration()
        return self.stats()

    def iterate(self) -> None:
        """One loop iteration (arrivals → joins → decode step → prefill
        chunks) — for drivers that interleave ``submit`` calls with the
        engine deterministically (tests, the gated benchmark) instead of
        feeding from a thread."""
        self._iteration()

    def _drop_pending(self) -> None:
        while True:
            try:
                self._arrivals.get_nowait()
            except queue.Empty:
                break
        for act in self._active:
            self._busy.discard(act.worker_idx)
        self._active.clear()
        for pend in self._pending_join:
            if pend.pres is not None:
                pend.pres.release_pages()
            if pend.kind == "restore":
                # abandon the victim's slab entry (its decode never
                # resumes) — no stranded host bytes after stop()
                self.spill_pool.spill_pop(pend.request.req_id,
                                          restored=False)
        self._pending_join.clear()

    def _iteration(self) -> None:
        self._iter += 1
        self._bump("iterations")
        self._drain_arrivals()
        self._try_joins()
        t_step = self._decode_step()
        self._run_chunks(t_step)

    def _drain_arrivals(self) -> None:
        while True:
            try:
                req = self._arrivals.get_nowait()
            except queue.Empty:
                return
            self._start_prefill(req)

    def _start_prefill(self, req: ServingRequest,
                       tokens_override: Optional[np.ndarray] = None,
                       resume_emitted: Optional[list] = None) -> None:
        """Route to the free worker with the deepest pool residency for
        this prompt (Conductor-style cache-aware routing, loop-local);
        every worker busy → round-robin pile-up is fine, generators are
        cheap until advanced. ``tokens_override``/``resume_emitted``
        replay a preempted victim through the recompute-restore arm."""
        toks = req.tokens if tokens_override is None else tokens_override
        idle = [i for i in range(len(self.pws)) if i not in self._busy]
        cand = idle if idle else list(range(len(self.pws)))
        best, best_depth = cand[0], -1
        for i in cand:
            pw = self.pws[i]
            ids = pw.hasher.hash_ids(toks, session=req.session)
            depth = pw.pool.plan_fetch(ids).n_resident
            if depth > best_depth:
                best, best_depth = i, depth
        cp = self.pws[best].start(toks, session=req.session)
        self._active.append(_Active(req, cp, best, emitted=resume_emitted))
        self._busy.add(best)
        if req.req_id not in self.outputs:
            self.outputs[req.req_id] = RequestOutput(
                req_id=req.req_id, priority=req.priority)

    # ---- page headroom + preemption ------------------------------------
    def _obtainable_pages(self) -> int:
        p = self.page_pool.pressure()
        return p["free"] + p["evictable"]

    def _stage_headroom_ok(self, n_pages: int) -> bool:
        """``PrefillWorker.stage_guard``: staging a finished prefill must
        leave the active slots' reserved growth obtainable, or the staged
        pin turns into a mid-decode alloc OOM that no deferral can fix."""
        if self.page_pool is None or self.dw.n_active == 0:
            return True
        return self._obtainable_pages() - n_pages >= \
            self.dw.reserved_growth_pages()

    def _pend_geometry(self, pend: _Pending) -> tuple[int, int, int]:
        """(join depth, tokens still to emit, pages already held)."""
        extra = pend.request.max_new - \
            (len(pend.emitted) if pend.emitted is not None else 0)
        held = len(pend.pres.pages or ()) if pend.pres is not None else 0
        return pend.n_tokens, extra, held

    def _headroom_ok(self, T: int, extra: int, held: int) -> bool:
        """Admitting a request joining at depth ``T`` with ``extra``
        tokens to go must leave every active slot's worst-case growth
        obtainable — a join that eats the last free pages turns into a
        mid-decode alloc OOM a few steps later, which no amount of
        deferring can fix (pinned pages of pending joins never release
        themselves)."""
        pp = self.page_pool
        if pp is None or self.dw.n_active == 0:
            return True
        cand = max(pp.pages_for(T + extra) - held, 0) + 1
        return self._obtainable_pages() >= \
            self.dw.reserved_growth_pages() + cand

    def _pick_victim(self, priority: int) -> Optional[int]:
        """Victim slot for a priority-``priority`` join: strictly lower
        priority only (equal classes defer, they never preempt each
        other — no cycles), lowest class first, shallowest progress
        breaking ties (least work to redo, fewest bytes to move)."""
        best, key = None, None
        for i, s in enumerate(self.dw.slots):
            if s is None or s.request.priority >= priority:
                continue
            k = (s.request.priority, len(s.emitted), i)
            if key is None or k < key:
                best, key = i, k
        return best

    def _spill(self, slot: int) -> None:
        """Preempt one slot: export its run to the spill slab and queue a
        restore entry (same priority it joined with)."""
        run = self.dw.preempt(slot)
        rid = run.request.req_id
        self.spill_pool.spill_put(rid, run.k, run.v, run.n_tokens)
        self._bump("preemptions")
        self._bump("pages_spilled", self.page_pool.pages_for(run.n_tokens))
        out = self.outputs.get(rid)
        if out is not None:
            out.preemptions += 1
        self._seq += 1
        self._pending_join.append(_Pending(
            request=run.request, pres=None, n_tokens=run.n_tokens,
            seq=self._seq, kind="restore", emitted=run.emitted))

    def _can_preempt(self, priority: int) -> bool:
        return (self.preempt and self.dw.substrate == "paged"
                and any(s is not None and s.request.priority < priority
                        for s in self.dw.slots))

    def _preempt_until(self, pend: _Pending) -> bool:
        """Spill victims until ``pend`` has a free slot AND page headroom;
        False once no eligible victim remains (spills stick — the freed
        pages serve whichever join lands first)."""
        while True:
            T, extra, held = self._pend_geometry(pend)
            if self.dw.has_free_slot and self._headroom_ok(T, extra, held):
                return True
            victim = self._pick_victim(pend.request.priority)
            if victim is None:
                return False
            self._spill(victim)

    # ---- restore arms ---------------------------------------------------
    def _combined_tokens(self, pend: _Pending) -> np.ndarray:
        """prompt + already-decoded tokens whose KV exists (all emitted
        but the last — the pending input's KV was never written)."""
        toks = np.asarray(pend.request.tokens)
        tail = pend.emitted[:-1]
        if not tail:
            return toks
        return np.concatenate([toks, np.asarray(tail, dtype=toks.dtype)])

    def _pick_restore_mode(self, pend: _Pending) -> str:
        emas = [pw._t_block_ema for pw in self.pws
                if pw._t_block_ema is not None]
        plan = plan_restore(
            pend.n_tokens,
            reload_s_per_block=self._t_reload_ema,
            recompute_s_per_block=min(emas) if emas else None,
            mode=self.restore_mode)
        return plan.mode

    def _stage_spilled(self, pend: _Pending) -> Optional[PrefillResult]:
        """Reload arm: stage the slab bytes back into device pages through
        the ordinary ``stage_run`` path — full blocks of the combined
        (prompt + decoded) sequence re-register/adopt, the tail stays
        private. None = the pool can't fit the run right now."""
        rid = pend.request.req_id
        k, v, T = self.spill_pool.spill_get(rid)
        hash_ids = self.pws[0].hasher.hash_ids(self._combined_tokens(pend))
        t0 = time.monotonic()
        pages = stage_run(self.page_pool, hash_ids, k, v, T)
        if pages is None:
            return None
        per_block = (time.monotonic() - t0) / max(-(-T // BLOCK_TOKENS), 1)
        self._t_reload_ema = per_block if self._t_reload_ema is None \
            else 0.7 * self._t_reload_ema + 0.3 * per_block
        return PrefillResult(
            first_token=int(pend.emitted[-1]), kv_k=k, kv_v=v,
            prompt_len=T, reused_blocks=0, new_blocks=0,
            hash_ids=hash_ids, pages=pages, page_pool=self.page_pool,
            page_gens=self.page_pool.gens_of(pages))

    def _reroute_recompute(self, pend: _Pending) -> None:
        """Recompute arm: drop the slab bytes and replay prompt + decoded
        tokens through chunked prefill; the finished result comes back as
        an ordinary pending join carrying ``emitted``."""
        rid = pend.request.req_id
        combined = self._combined_tokens(pend)
        self.spill_pool.spill_pop(rid)
        self._bump("restores_recompute")
        self.outputs[rid].restores.append("recompute")
        self._start_prefill(pend.request, tokens_override=combined,
                            resume_emitted=pend.emitted)

    # ---- joins -----------------------------------------------------------
    def _try_joins(self) -> None:
        if not self._pending_join:
            return
        pending = self._pending_join
        # highest priority first, FIFO within a class (stable on seq)
        pending.sort(key=lambda p: (-p.request.priority, p.seq))
        self._pending_join = []     # _spill() appends freshly-preempted
        for pend in pending:        # victims here for the NEXT pass
            if not self._try_admit_one(pend):
                self._pending_join.append(pend)

    def _try_admit_one(self, pend: _Pending) -> bool:
        """Try to put one pending unit into the decode batch. True =
        consumed (joined, or rerouted through a recompute prefill)."""
        dw = self.dw
        req = pend.request
        T, extra, held = self._pend_geometry(pend)
        ok = dw.has_free_slot and self._headroom_ok(T, extra, held)
        if not ok and self._can_preempt(req.priority):
            ok = self._preempt_until(pend)
        if not ok:
            if dw.has_free_slot:
                self._bump("join_oom")
            return False
        if pend.kind == "restore" and pend.pres is None:
            if self._pick_restore_mode(pend) == "recompute":
                self._reroute_recompute(pend)
                return True
            pres = self._stage_spilled(pend)
            if pres is None:
                self._bump("join_oom")
                if dw.n_active == 0:
                    raise RuntimeError(
                        f"request {req.req_id}'s spilled run cannot fit "
                        f"the device page pool even with an empty decode "
                        f"batch")
                return False
            pend.pres = pres
        try:
            dw.join(req, pend.pres, resume_emitted=pend.emitted)
        except MemoryError:
            # device pages exhausted by live slots: wait for decodes
            # to finish and release pages, then retry. With no active
            # decode there is nothing to wait for — fail loudly
            # instead of spinning.
            self._bump("join_oom")
            if dw.n_active == 0:
                raise RuntimeError(
                    f"request {req.req_id} cannot fit the device page "
                    f"pool even with an empty decode batch") from None
            return False
        self._bump("joined")
        out = self.outputs[req.req_id]
        if pend.emitted is None:
            out.tokens.append(pend.pres.first_token)
            out.token_t.append(time.monotonic())
        elif pend.kind == "restore":
            self._bump("restores_reload")
            out.restores.append("reload")
        if pend.kind == "restore":
            self.spill_pool.spill_pop(req.req_id)
        return True

    def _decode_step(self) -> float:
        """One continuous-batching decode iteration; returns its wall
        seconds (0.0 when no slot is active)."""
        if self.dw.n_active == 0:
            return 0.0
        t0 = time.monotonic()
        emitted = self.dw.step()
        dt = time.monotonic() - t0
        self._bump("decode_steps")
        self._t_step_ema = dt if self._t_step_ema is None \
            else 0.7 * self._t_step_ema + 0.3 * dt
        now = time.monotonic()
        for rid, tok, fin in emitted:
            out = self.outputs[rid]
            out.tokens.append(tok)
            out.token_t.append(now)
            if fin:
                out.done = True
                out.completed_iter = self._iter
                self._bump("completed")
        return dt

    def _advance_one(self) -> bool:
        """Advance the round-robin prefill one chunk; True if any ran."""
        if not self._active:
            return False
        self._rr %= len(self._active)
        act = self._active[self._rr]
        done = act.cp.advance()
        self._bump("prefill_chunks")
        if done:
            self._active.pop(self._rr)
            self._busy.discard(act.worker_idx)
            self._seq += 1
            self._pending_join.append(_Pending(
                request=act.request, pres=act.cp.result,
                n_tokens=act.cp.result.prompt_len, seq=self._seq,
                kind="join", emitted=act.emitted))
        else:
            self._rr += 1
        return True

    def _run_chunks(self, t_step: float) -> None:
        """Interleave prefill chunks into the post-step slack.

        Budget mode: the TBT budget leaves ``tbt_budget_s − step_ema``
        seconds of slack per iteration; fit chunks by the workers' chunk
        EMA, guaranteeing ≥ 1 so prefill can't starve. No active decode →
        run chunks until one prefill completes (nothing to delay).
        Deterministic mode: exactly ``chunks_per_iter`` chunks."""
        if not self._active:
            return
        if self.dw.n_active == 0:
            # decode is idle: chunk until a prefill finishes so the next
            # iteration has something to join (TTFT over unused slack)
            while self._active and not self._pending_join:
                self._advance_one()
            return
        if self.tbt_budget_s is None:
            for _ in range(self.chunks_per_iter):
                if not self._advance_one():
                    return
            return
        step_ema = self._t_step_ema if self._t_step_ema is not None else t_step
        slack = self.tbt_budget_s - step_ema
        deadline = time.monotonic() + max(slack, 0.0)
        ran = 0
        while self._active:
            chunk_s = max(pw.est_chunk_s() for pw in self.pws)
            if ran > 0 and time.monotonic() + chunk_s > deadline:
                break
            self._advance_one()
            ran += 1

    # ---- reporting -----------------------------------------------------
    def stats(self) -> dict:
        """Unified snapshot (cross-component ``stats()`` protocol: taken
        under the loop lock, plain dict, stable key names): lifetime
        counters, the spill-slab gauge, and inter-token-gap percentiles
        over every emitted token (the former ``tbt_stats()``, folded in
        under ``tbt_*`` keys)."""
        with self._lock:
            out = dict(self._counters)
        out["spill_depth"] = self.spill_pool.spill_depth()
        gaps: list[float] = []
        for o in list(self.outputs.values()):
            ts = o.token_t
            gaps += [b - a for a, b in zip(ts, ts[1:])]
        if gaps:
            g = np.sort(np.asarray(gaps))
            out.update(tbt_n=len(g), tbt_p50_s=float(np.percentile(g, 50)),
                       tbt_p99_s=float(np.percentile(g, 99)),
                       tbt_max_s=float(g[-1]))
        else:
            out.update(tbt_n=0, tbt_p50_s=0.0, tbt_p99_s=0.0, tbt_max_s=0.0)
        return out
