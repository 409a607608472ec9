"""Discrete-event cluster simulator — Mooncake's evaluation rig (§8); the
port's own copy of the reference's ``core/simulator.py``.

The paper's own results come from replaying traces against a dummy model;
we do the same: the simulator replays a trace against per-instance cost
models (prefill superlinear in input length, decode memory-bound — Figure
2), priced by ``core.costmodel`` on an H100 node unless the scenario's
``ClusterSpec.inst_spec`` says otherwise.

Two cluster types:

  * ``MooncakeCluster`` — disaggregated prefill/decode pools + Conductor
    (Algorithm 1) + Messenger + overload admission (§7). Layer-wise prefill
    (§5.2) makes the KVCache stream to the decode node DURING prefill, so
    the decode-side arrival is max(prefill_done, transfer_done) with the
    transfer enqueued layer-by-layer — effectively overlapped unless the
    sender link is congested.
  * ``CoupledCluster`` — the vLLM-style baseline: prefill inlined into the
    decode engine; a long prefill blocks every active decode for its whole
    duration (the TBT disruption of §8.1.2).

Time unit: SECONDS, simulated. Request timestamps (ms) are converted on
entry. Every decision and record equals the reference's under the same
``Hardware`` values (``tests/test_torch_simulator.py``).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import CacheTierSpec, ClusterSpec, ModelConfig
from repro_torch.core.cache import CachePool
from repro_torch.core.conductor import (Conductor, DecodeInstance,
                                        PrefillInstance)
from repro_torch.core.costmodel import CostModel, InstanceSpec
from repro_torch.core.messenger import Messenger
from repro_torch.core.policies import AdmissionPolicy
from repro_torch.core.trace import BLOCK_TOKENS, Request


@dataclass
class ReqRecord:
    req: Request
    arrival: float
    accepted: bool = False
    reject_stage: str = ""         # "admission" | "decode_doublecheck" | ""
    reject_reason: str = ""        # Decision.reject_reason (detailed)
    prefill_start: float = -1.0
    ttft: float = -1.0             # first token latency (s)
    tbts: list = field(default_factory=list)  # per-token gaps (s)
    done: float = -1.0
    prefix_blocks: int = 0
    ssd_blocks: int = 0            # prefix blocks loaded from local SSD
    peer_ssd_blocks: int = 0       # prefix blocks fetched off a peer's SSD
    ssd_load_time: float = 0.0     # seconds spent on the SSD read channel

    @property
    def completed(self) -> bool:
        return self.done >= 0

    def tbt_p(self, q: float) -> float:
        return float(np.percentile(self.tbts, q)) if self.tbts else 0.0


@dataclass
class SimResult:
    records: list
    duration: float
    load_samples: list              # (t, prefill_load, decode_load)
    n_migrations: int = 0
    n_ssd_loads: int = 0            # compute-vs-load chose 'load'
    n_peer_ssd_loads: int = 0       # global pool chose a peer-SSD fetch

    # ---- aggregates ----
    def completed(self):
        return [r for r in self.records if r.completed]

    def rejected(self):
        return [r for r in self.records if not r.accepted]

    def reject_breakdown(self) -> dict:
        """Rejected-request counts by detailed reason (falling back to the
        stage when a reason wasn't recorded), most frequent first."""
        counts: dict = {}
        for r in self.records:
            if r.accepted:
                continue
            key = r.reject_reason or r.reject_stage
            if not key:
                continue
            counts[key] = counts.get(key, 0) + 1
        return dict(sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])))

    def ttft_p90(self) -> float:
        c = [r.ttft for r in self.completed()]
        return float(np.percentile(c, 90)) if c else float("nan")

    def tbt_p90(self) -> float:
        """P90 over requests of each request's P90 token gap."""
        c = [r.tbt_p(90) for r in self.completed() if r.tbts]
        return float(np.percentile(c, 90)) if c else float("nan")

    def slo_ok_count(self, ttft_slo: float, tbt_slo: float) -> int:
        """Completed requests meeting both SLOs (§2: only fully completed
        requests count)."""
        return len([r for r in self.completed()
                    if r.ttft <= ttft_slo and r.tbt_p(90) <= tbt_slo])

    def goodput(self, ttft_slo: float, tbt_slo: float,
                window: float | None = None) -> float:
        """SLO-meeting completions per second. ``window`` defaults to the
        run's makespan; pass a common window when comparing configurations
        (the makespan moves with the last request's completion, which is
        noise for A/B comparisons)."""
        window = self.duration if window is None else window
        return self.slo_ok_count(ttft_slo, tbt_slo) / window if window \
            else 0.0

    def slo_attainment(self, ttft_slo: float, tbt_slo: float):
        c = self.completed()
        if not c:
            return 0.0, 0.0
        ttft_ok = np.mean([r.ttft <= ttft_slo for r in c])
        tbt_ok = np.mean([r.tbt_p(90) <= tbt_slo for r in c])
        return float(ttft_ok), float(tbt_ok)

    def avg_ttft(self) -> float:
        c = [r.ttft for r in self.completed()]
        return float(np.mean(c)) if c else float("nan")


# ---------------------------------------------------------------------------
# event engine
# ---------------------------------------------------------------------------

class _Events:
    def __init__(self) -> None:
        self._h: list = []
        self._c = itertools.count()

    def push(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._h, (t, next(self._c), fn))

    def pop(self):
        t, _, fn = heapq.heappop(self._h)
        return t, fn

    def __bool__(self) -> bool:
        return bool(self._h)


# ---------------------------------------------------------------------------
# Mooncake (disaggregated) cluster
# ---------------------------------------------------------------------------

class _DecodeEngine:
    """Continuous-batching decode loop for one DecodeInstance."""

    def __init__(self, inst: DecodeInstance, events: _Events,
                 sim: "MooncakeCluster") -> None:
        self.inst = inst
        self.events = events
        self.sim = sim
        self.batch: list[ReqRecord] = []
        self.ticking = False

    def join(self, rec: ReqRecord, now: float) -> None:
        self.batch.append(rec)
        self.inst.active += 1
        self.inst.kv_tokens += rec.req.input_length
        self.inst.pending -= 1
        self.inst.pending_tokens -= rec.req.input_length + rec.req.output_length
        rec._last_tok = now       # type: ignore[attr-defined]
        rec._emitted = 1          # prefill produced the first token
        if not self.ticking:
            self.ticking = True
            self.events.push(now, lambda: self.tick(now))

    def tick(self, now: float) -> None:
        if not self.batch:
            self.ticking = False
            return
        dt = self.inst.cost.decode_iter_time(
            len(self.batch), self.inst.kv_tokens / len(self.batch))
        t2 = now + dt
        done_recs = []
        for rec in self.batch:
            rec.tbts.append(t2 - rec._last_tok)   # type: ignore[attr-defined]
            rec._last_tok = t2                    # type: ignore[attr-defined]
            rec._emitted += 1                     # type: ignore[attr-defined]
            self.inst.kv_tokens += 1
            if rec._emitted >= rec.req.output_length:  # type: ignore
                done_recs.append(rec)
        for rec in done_recs:
            self.batch.remove(rec)
            self.inst.active -= 1
            self.inst.kv_tokens -= rec.req.input_length + rec._emitted  # type: ignore
            rec.done = t2
        self.events.push(t2, lambda: self.tick(t2))


_UNSET = object()   # sentinel: distinguishes "not passed" from None defaults


class MooncakeCluster:
    """Disaggregated cluster. The scenario is a ``ClusterSpec``:

        MooncakeCluster.from_spec(cfg, ClusterSpec(n_prefill=8, ...))

    The flat-kwarg constructor (``MooncakeCluster(cfg, n_prefill=8, ...)``)
    is a deprecated shim kept for existing callers; it builds the same
    ``ClusterSpec`` internally (``cache_capacity_blocks``/``cache_policy``
    fold into a flat ``CacheTierSpec`` unless ``cache_spec`` is given).
    """

    def __init__(self, cfg: ModelConfig, spec: Optional[ClusterSpec] = None,
                 *, n_prefill: int = _UNSET, n_decode: int = _UNSET,
                 inst_spec: InstanceSpec = _UNSET,
                 ttft_slo: float = _UNSET, tbt_slo: float = _UNSET,
                 cache_capacity_blocks: Optional[int] = _UNSET,
                 cache_policy: str = _UNSET,
                 cache_spec: Optional[CacheTierSpec] = _UNSET,
                 strategy: str = _UNSET,
                 admission: str = _UNSET,
                 balancing_threshold: float = _UNSET,
                 layerwise_prefill: bool = _UNSET,
                 t_d: float = _UNSET, seed: int = _UNSET) -> None:
        legacy = {k: v for k, v in dict(
            n_prefill=n_prefill, n_decode=n_decode, inst_spec=inst_spec,
            ttft_slo=ttft_slo, tbt_slo=tbt_slo, strategy=strategy,
            admission=admission, balancing_threshold=balancing_threshold,
            layerwise_prefill=layerwise_prefill, t_d=t_d,
            seed=seed).items() if v is not _UNSET}
        if spec is not None:
            if legacy or cache_spec is not _UNSET \
                    or cache_capacity_blocks is not _UNSET \
                    or cache_policy is not _UNSET:
                raise ValueError("pass either a ClusterSpec or legacy "
                                 "kwargs, not both")
        else:
            if cache_spec is not _UNSET and cache_spec is not None:
                legacy["cache"] = cache_spec
            elif cache_capacity_blocks is not _UNSET \
                    or cache_policy is not _UNSET:
                legacy["cache"] = CacheTierSpec(
                    dram_blocks=20000 if cache_capacity_blocks is _UNSET
                    else cache_capacity_blocks,
                    dram_policy="lru" if cache_policy is _UNSET
                    else cache_policy)
            spec = ClusterSpec(**legacy)

        self.cfg = cfg
        self.spec = spec
        inst = spec.inst_spec if spec.inst_spec is not None else InstanceSpec()
        cost = lambda: CostModel(cfg, inst)
        self.cache_spec = spec.cache
        self.prefills = [PrefillInstance(
            iid=i, pool=spec.cache.make_pool(),
            cost=cost()) for i in range(spec.n_prefill)]
        self.decodes = [DecodeInstance(iid=1000 + i, cost=cost())
                        for i in range(spec.n_decode)]
        node_ids = [p.iid for p in self.prefills] + [d.iid for d in self.decodes]
        self.messenger = Messenger(node_ids, bw=inst.hw.net_bw)
        if spec.cache.tiered:
            for p in self.prefills:
                self.messenger.add_ssd_channel(p.iid, inst.hw.ssd_read_bw)
        # the Figure-3 global pool: one directory spanning every prefill
        # instance's tiers, so a block demoted on node A proposes a
        # peer-SSD fetch arm for a request routed to node B
        self.directory = None
        if spec.cache.tiered and spec.global_pool:
            from repro_torch.core.directory import GlobalBlockDirectory
            self.directory = GlobalBlockDirectory()
            for p in self.prefills:
                self.directory.bind(p.iid, p.pool)
        import random
        self.conductor = Conductor(
            self.prefills, self.decodes, self.messenger,
            ttft_slo=spec.ttft_slo, tbt_slo=spec.tbt_slo,
            balancing_threshold=spec.balancing_threshold,
            strategy=spec.strategy, decode_policy=spec.decode_policy,
            rng=random.Random(spec.seed), directory=self.directory)
        # forward spec knobs any registered admission policy declares
        # (predictive's t_d, and user policies subclassing it)
        import inspect
        from repro_torch.core.policies import get_policy
        adm_cls = get_policy("admission", spec.admission)
        kw = {"t_d": spec.t_d} if "t_d" in inspect.signature(
            adm_cls.__init__).parameters else {}
        self.admission: AdmissionPolicy = adm_cls(self.conductor, **kw)
        self.ttft_slo = spec.ttft_slo
        self.tbt_slo = spec.tbt_slo
        self.layerwise = spec.layerwise_prefill
        self.admission_name = spec.admission

    @classmethod
    def from_spec(cls, cfg: ModelConfig, spec: ClusterSpec) \
            -> "MooncakeCluster":
        """Build a cluster from a declarative scenario spec."""
        return cls(cfg, spec)

    def run(self, requests: list[Request], *, speedup: float = 1.0,
            load_sample_dt: float = 10.0) -> SimResult:
        events = _Events()
        records = [ReqRecord(req=r, arrival=r.timestamp / 1000.0 / speedup)
                   for r in requests]
        engines = {d.iid: _DecodeEngine(d, events, self) for d in self.decodes}
        load_samples: list = []

        def arrive(rec: ReqRecord):
            now = rec.arrival
            dec = self.admission.schedule(rec.req, now)
            if not dec.accepted:
                rec.reject_stage = "admission"
                rec.reject_reason = dec.reject_reason
                return
            rec.accepted = True
            rec.prefix_blocks = dec.prefix_blocks
            rec.ssd_blocks = dec.ssd_blocks
            rec.peer_ssd_blocks = dec.peer_ssd_blocks
            rec.ssd_load_time = dec.ssd_load_time
            p, d = dec.prefill, dec.decode
            # prefill completion (the conductor queued the work already;
            # any SSD prefix load overlapped the queue wait, so compute
            # start already reflects max(queue drained, load landed))
            t_done = p.queue_free_at
            rec.prefill_start = t_done - dec.compute_time

            # KVCache transfer to the decode node (§5.2 layer-wise overlap):
            # streaming starts when prefill starts, so completion is
            # max(prefill_done, stream_done); without layer-wise it is
            # prefill_done + full transfer.
            nbytes = p.cost.kv_bytes(rec.req.input_length)
            if self.layerwise:
                t_stream = self.messenger.enqueue(p.iid, nbytes,
                                                  rec.prefill_start)
                t_ready = max(t_done, t_stream)
            else:
                t_ready = self.messenger.enqueue(p.iid, nbytes, t_done)

            def finish_prefill():
                rec.ttft = t_done - rec.arrival
                self.admission.on_decode_join(d.iid, t_done)

            events.push(t_done, finish_prefill)

            def join_decode():
                # §3 step 4: the local scheduler double-checks the SLO with
                # the REAL (post-lag) state; under the baseline policy the
                # pre-selection was stale, so this can reject a request
                # whose prefill is already paid for — the §7.2 waste.
                tokens = rec.req.input_length + rec.req.output_length
                over_tbt = d.predicted_tbt(
                    1, tokens, include_pending=False) > self.tbt_slo
                over_vram = not d.vram_ok(tokens, include_pending=False)
                if self.admission.decode_double_check and (over_tbt or over_vram):
                    rec.accepted = False
                    rec.reject_stage = "decode_doublecheck"
                    rec.reject_reason = "decode double-check (%s)" % (
                        "VRAM" if over_vram else "TBT")
                    d.pending -= 1
                    d.pending_tokens -= tokens
                    return
                engines[d.iid].join(rec, t_ready)

            events.push(t_ready, join_decode)

        for rec in records:
            events.push(rec.arrival, lambda rec=rec: arrive(rec))

        # periodic load sampling (Figure 9)
        horizon = max(r.arrival for r in records) + 120.0

        def sample(t: float):
            load_samples.append((t, self.admission.prefill_load(t),
                                 self.admission.decode_load(t)))
            if t < horizon:
                events.push(t + load_sample_dt,
                            lambda: sample(t + load_sample_dt))

        events.push(0.0, lambda: sample(0.0))

        while events:
            t, fn = events.pop()
            fn()
        t_end = max([r.done for r in records if r.completed]
                    + [r.arrival for r in records])
        return SimResult(records=records, duration=t_end,
                         load_samples=load_samples,
                         n_migrations=self.conductor.n_migrations,
                         n_ssd_loads=self.conductor.n_ssd_loads,
                         n_peer_ssd_loads=self.conductor.n_peer_ssd_loads)


# ---------------------------------------------------------------------------
# Coupled (vLLM-style) baseline cluster
# ---------------------------------------------------------------------------

class _CoupledInstance:
    """Prefill inlined into the decode engine. Local prefix cache only."""

    def __init__(self, iid: int, cfg: ModelConfig, inst_spec: InstanceSpec,
                 cache_capacity, cache_policy: str) -> None:
        self.iid = iid
        self.cost = CostModel(cfg, inst_spec)
        self.pool = CachePool(cache_capacity, cache_policy)
        self.batch: list[ReqRecord] = []
        self.waiting: list[ReqRecord] = []
        self.kv_tokens = 0.0
        self.ticking = False
        self.queued_prefill_s = 0.0   # admission-visible backlog

    def load(self) -> float:
        return len(self.batch) + len(self.waiting)


class CoupledCluster:
    """vLLM-[N×M]: N instances, each coupling prefill + decode. Long-context
    prefills block the whole batch (no chunked prefill), reproducing the
    §8.1.2 TBT disruption. Requests go to the least-loaded instance."""

    def __init__(self, cfg: ModelConfig, *, n_instances: int,
                 inst_spec: InstanceSpec = InstanceSpec(),
                 ttft_slo: float = 30.0, tbt_slo: float = 0.1,
                 cache_capacity_blocks: Optional[int] = 20000,
                 cache_policy: str = "lru",
                 max_batch: int = 256, admit_load: float = 1e9) -> None:
        self.cfg = cfg
        self.insts = [_CoupledInstance(i, cfg, inst_spec,
                                       cache_capacity_blocks, cache_policy)
                      for i in range(n_instances)]
        self.ttft_slo = ttft_slo
        self.tbt_slo = tbt_slo
        self.max_batch = max_batch
        self.admit_load = admit_load

    def run(self, requests: list[Request], *, speedup: float = 1.0,
            load_sample_dt: float = 10.0) -> SimResult:
        events = _Events()
        records = [ReqRecord(req=r, arrival=r.timestamp / 1000.0 / speedup)
                   for r in requests]

        def tick(inst: _CoupledInstance, now: float):
            if not inst.batch and not inst.waiting:
                inst.ticking = False
                return
            # vLLM-v0 scheduling (the paper's baseline, §8.1.2): PREFILL
            # PRIORITY — every waiting prefill runs (whole, unchunked)
            # before decode resumes, VRAM permitting (coupled nodes
            # reserve prefill activation space — kv_frac 0.5 vs 0.8 on a
            # dedicated decode node). Long-context arrivals therefore
            # stall the whole decode batch for their full prefill time.
            cap = inst.cost.decode_capacity_tokens(kv_frac=0.5)
            dt = 0.0
            while inst.waiting and len(inst.batch) < self.max_batch and \
                    inst.kv_tokens + inst.waiting[0].req.input_length \
                    + inst.waiting[0].req.output_length <= cap:
                rec = inst.waiting.pop(0)
                n = inst.pool.lookup(rec.req.hash_ids)
                inst.pool.insert(rec.req.hash_ids[n:], start_pos=n)
                t_pf = inst.cost.prefill_time(rec.req.input_length,
                                              n * BLOCK_TOKENS)
                inst.queued_prefill_s -= t_pf
                dt += t_pf
                rec.ttft = now + dt - rec.arrival
                rec.prefix_blocks = n
                rec._last_tok = now + dt      # type: ignore
                rec._emitted = 1              # type: ignore
                inst.batch.append(rec)
                inst.kv_tokens += rec.req.input_length
            if inst.batch:
                dt += inst.cost.decode_iter_time(
                    len(inst.batch), inst.kv_tokens / len(inst.batch))
            t2 = now + dt
            done_recs = []
            for rec in inst.batch:
                if rec._emitted == 1 and rec.ttft + rec.arrival > now:
                    pass  # this request's first token was in this gap
                rec.tbts.append(t2 - rec._last_tok)  # type: ignore
                rec._last_tok = t2                   # type: ignore
                rec._emitted += 1                    # type: ignore
                inst.kv_tokens += 1
                if rec._emitted >= rec.req.output_length:  # type: ignore
                    done_recs.append(rec)
            for rec in done_recs:
                inst.batch.remove(rec)
                inst.kv_tokens -= rec.req.input_length + rec._emitted  # type: ignore
                rec.done = t2
            events.push(t2, lambda: tick(inst, t2))

        def arrive(rec: ReqRecord):
            now = rec.arrival
            inst = min(self.insts, key=lambda i: i.load())
            if inst.load() >= self.admit_load:
                rec.reject_stage = "admission"
                rec.reject_reason = "instance load limit"
                return
            rec.accepted = True
            inst.waiting.append(rec)
            inst.queued_prefill_s += inst.cost.prefill_time(
                rec.req.input_length, 0)
            if not inst.ticking:
                inst.ticking = True
                events.push(now, lambda: tick(inst, now))

        for rec in records:
            events.push(rec.arrival, lambda rec=rec: arrive(rec))

        while events:
            t, fn = events.pop()
            fn()
        t_end = max([r.done for r in records if r.completed]
                    + [r.arrival for r in records])
        return SimResult(records=records, duration=t_end, load_samples=[])
