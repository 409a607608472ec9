"""One run of a cell: the port's serving stack built at the cell's sizes,
driven by the cell's traffic for a warm phase and the measured window,
drained, and recorded.

The served entry is ``repro_torch.serving.loop.ServingLoop`` over one
``PrefillWorker`` (on a DRAM ``HostKVPool``) and one ``DecodeWorker`` (on
a ``DevicePagePool``), built as ``launch/serve.py``'s ``serve()`` builds
them but with the cell's sizes; ``run`` runs on its own thread, requests
arrive through ``submit`` from a feeder thread.

The model comes from the configuration's family (``bench/families/``):
the port's config, the weights, the kernels built in set-up and the
counts the metrics read.

Spans come from this file: the calls into each layer are wrapped on the
program's objects (the loop's iteration, the prefill worker's start,
chunk, prefix load, staging and store-back, the decode worker's join and
step), each recording (name, start, end, what it did) on the host clock.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from bench import families, generator

WARM_RID = 10 ** 9         # request id of the set-up request
DRAIN_S = 30.0             # open loop: the longest wait for first tokens
JOIN_S = 120.0             # the engine thread's last chance to end


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    info: Optional[dict] = None


@dataclass
class Record:
    """One request as the client saw it."""
    rid: int
    prompt_len: int
    max_new: int
    due: float                  # host monotonic
    sent: Optional[float] = None
    accepted: Optional[bool] = None
    reused_blocks: int = 0
    tokens: list = field(default_factory=list)
    token_t: list = field(default_factory=list)
    done: bool = False
    cut: bool = False           # ended early by the harness at the close


@dataclass
class RunData:
    """Everything a metric reader or the check reads."""
    cell: object
    arch: object               # the family's counts
    window: tuple
    setup_s: float
    records: dict
    spans: list
    deltas: dict
    trace: Optional[object] = None
    lateness_p99_s: float = 0.0
    memory_peak_bytes: int = 0
    prompts: dict = field(default_factory=dict)
    closed_at: float = 0.0
    host_speed_s: float = 0.0
    reserved_peak_bytes: int = 0

    def spans_named(self, name: str, lo: float, hi: float) -> list:
        return [s for s in self.spans if s.name == name
                and s.t0 >= lo and s.t1 <= hi]


def process_start() -> float:
    """This process's start on the monotonic clock (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - start_ticks
                                   / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def touch_host(gib: float) -> None:
    """Write one byte in every page of ``gib`` GiB of fresh host memory,
    in 1 GiB pieces held together, then free it."""
    pieces = []
    for _ in range(int(gib)):
        a = np.empty(1 << 30, np.uint8)
        a[::4096] = 1
        pieces.append(a)
    del pieces


def host_speed() -> float:
    """Seconds of a fixed piece of pure Python: the host's pace in this
    run, beside the run's host-clock numbers."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return time.perf_counter() - t0


def host_counts() -> dict:
    """This process's CPU seconds, page faults and context switches."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return dict(user_s=r.ru_utime, system_s=r.ru_stime,
                minor_faults=r.ru_minflt, major_faults=r.ru_majflt,
                voluntary_switches=r.ru_nvcsw,
                involuntary_switches=r.ru_nivcsw)


def allocator_counts(device) -> dict:
    """The caching allocator's retries, device allocations and frees."""
    if device.type != "cuda":
        return {}
    import torch
    st = torch.cuda.memory_stats(device)
    return {k: st.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                      "num_device_free",
                                      "num_sync_all_streams")}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Harness:
    """Builds the stack, drives the traffic, records spans and requests."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, cfg=None, t_start: Optional[float] = None) -> None:
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.traced = trace
        self.device = device
        self.t_start = process_start() if t_start is None else t_start
        self.family = families.of(cell.config)
        self.cfg = cfg if cfg is not None else \
            self.family.port_config(cell.config)
        self.wl = cell.workload
        self.spans: list = []
        self.records: dict = {}
        self._by_tokens: dict = {}
        self._done_q: "queue.Queue[int]" = queue.Queue()
        self._stop_feed = threading.Event()
        self._error: list = []
        self.tracer = None

    # ---- the stack ------------------------------------------------------------
    def build(self) -> None:
        from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                                PrefillWorker)
        from repro_torch.serving.loop import ServingLoop
        from repro_torch.serving.paged_cache import DevicePagePool
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            for name in self.family.KERNELS:
                _build.library(name)
        lw, cfg = self.wl["loop"], self.cfg
        self.host_speed_s = host_speed()
        self.params = self.family.draw(cfg, self.seed, self.device)
        self.pool = HostKVPool(capacity_blocks=lw["host_pool_blocks"])
        self.page_pool = DevicePagePool(
            cfg, n_pages=lw["page_pool_pages"],
            page_tokens=self.cell.config["serving"]["page_tokens"],
            device=self.device)
        self.pw = PrefillWorker(self.params, cfg, self.pool,
                                prefill_chunk=lw["prefill_chunk"],
                                page_pool=self.page_pool)
        self.dw = DecodeWorker(self.params, cfg, max_batch=lw["max_batch"],
                               max_len=self.cell.config["serving"]["max_len"],
                               page_pool=self.page_pool)
        self.loop = ServingLoop([self.pw], self.dw,
                                chunks_per_iter=lw["chunks_per_iter"],
                                max_queue=lw["max_queue"],
                                admission=lw["admission"], preempt=True)
        self._wrap()

    def _span(self, name: str, t0: float, info=None) -> None:
        self.spans.append(Span(name, t0, time.monotonic(), info))

    def _wrap(self) -> None:
        pw, dw, loop = self.pw, self.dw, self.loop
        tm = time.monotonic

        def timed(obj, attr, name, info=None):
            orig = getattr(obj, attr)

            def wrapped(*a, **k):
                t0 = tm()
                r = orig(*a, **k)
                self._span(name, t0, info(*a, **k) if info else None)
                return r
            setattr(obj, attr, wrapped)

        timed(pw, "_chunk_extend", "prefill_chunk",
              lambda t, caches, lo, hi: {"lo": lo, "hi": hi,
                                         "S": int(t.shape[1])})
        timed(pw, "_set_blocks", "prefix_load",
              lambda caches, ids, lo, hi: {"blocks": hi - lo})
        timed(pw, "_stage", "stage")
        timed(self.pool, "put", "store_back")
        timed(dw, "join", "join")

        start = pw.start

        def start_wrapped(tokens, session=None):
            cp = start(tokens, session=session)
            rec = self._by_tokens.get(id(tokens))
            adv = cp.advance

            def advance():
                t0 = tm()
                done = adv()
                if done and rec is not None:
                    rec.reused_blocks = cp.result.reused_blocks
                self._span("prefill_advance", t0)
                return done
            cp.advance = advance
            return cp
        pw.start = start_wrapped

        step = dw.step

        def step_wrapped():
            active = [i for i, s in enumerate(dw.slots) if s is not None]
            keys = int(sum(int(dw.seq_lens[i]) + 1 for i in active))
            t0 = tm()
            out = step()
            self._span("decode_step", t0, {"batch": len(active),
                                           "keys": keys})
            for rid, _, fin in out:
                if fin:
                    self._done_q.put(rid)
            return out
        dw.step = step_wrapped

        iteration = loop._iteration

        def iteration_wrapped():
            if self.tracer is not None:
                self.tracer.tick(tm())
            t0 = tm()
            iteration()
            self._span("loop_iteration", t0)
        loop._iteration = iteration_wrapped

    # ---- set-up -----------------------------------------------------------------
    def warm_up(self) -> None:
        """Host memory touched once (``host_warm_gib``: what the host
        pool and the prompts' copies will hold), so that a process's
        first large allocations do not pay the machine's first touch of
        its pages inside the window; then one request through the whole
        stack, alone, at the cell's shapes: a chunk and a tail chunk,
        staging, a join and decode steps; the profiler opened once for a
        traced run."""
        from repro_torch.serving.request import ServingRequest
        touch_host(float(self.wl.get("host_warm_gib", 0.0)))
        rng = np.random.default_rng([self.seed % (1 << 32), 99])
        n = self.wl["loop"]["prefill_chunk"] + 64
        toks = rng.integers(0, self.cell.config["vocab_size"], n,
                            dtype=np.int64).astype(np.int32)
        self.loop.submit(ServingRequest(req_id=WARM_RID, tokens=toks,
                                        max_new=8))
        while not self.loop.idle:
            self.loop.iterate()
        _sync(self.device)
        if self.traced and self.device.type == "cuda":
            from bench.tracing import Tracer
            Tracer.warm(self.device)

    # ---- the client -----------------------------------------------------------------
    def _submit(self, turn, due: float) -> None:
        from repro_torch.serving.request import ServingRequest
        rec = Record(rid=turn.rid, prompt_len=len(turn.tokens),
                     max_new=turn.max_new, due=due)
        self.records[turn.rid] = rec
        req = ServingRequest(req_id=turn.rid, tokens=turn.tokens,
                             max_new=turn.max_new, session=turn.session)
        self._by_tokens[id(req.tokens)] = rec
        self._requests[turn.rid] = req
        rec.sent = time.monotonic()
        rec.accepted = self.loop.submit(req)

    def _open_feeder(self, turns: list, t0: float, until: float) -> None:
        try:
            for turn in turns:
                due = t0 + turn.due
                if due >= until:
                    break
                wait = due - time.monotonic()
                if wait > 0 and self._stop_feed.wait(wait):
                    break
                self._submit(turn, due)
        except BaseException as e:           # surfaced by run()
            self._error.append(e)

    def _closed_clients(self, clients: list, t0: float, until: float) -> None:
        """Client c sends its first turn at ``t0 + c · ramp_s / clients``,
        then each next turn when its previous one completes."""
        try:
            n = len(clients)
            ramp = float(self.wl["load"].get("ramp_s", 0.0))
            starts = [t0 + ramp * c / n for c in range(n)]
            waiting = list(range(n))
            nxt = [0] * n
            owner: dict = {}

            def send(c: int) -> None:
                while nxt[c] < len(clients[c]) and time.monotonic() < until:
                    turn = clients[c][nxt[c]]
                    nxt[c] += 1
                    owner[turn.rid] = c
                    self._submit(turn, time.monotonic())
                    if self.records[turn.rid].accepted:
                        return
            while not self._stop_feed.is_set():
                now = time.monotonic()
                while waiting and starts[waiting[0]] <= now:
                    send(waiting.pop(0))
                wait = 0.05 if not waiting else \
                    min(0.05, max(starts[waiting[0]] - now, 0.001))
                try:
                    rid = self._done_q.get(timeout=wait)
                except queue.Empty:
                    continue
                if rid in owner and time.monotonic() < until:
                    send(owner[rid])
        except BaseException as e:
            self._error.append(e)

    # ---- the run ------------------------------------------------------------------
    def run(self) -> RunData:
        load, mix = self.wl["load"], self.cell.traffic
        warm_s = float(self.wl["warm_s"])
        vocab = self.cell.config["vocab_size"]
        if load["loop"] == "open":
            turns = generator.open_loop(mix, load, warm_s + self.seconds,
                                        vocab, self.seed)
        else:
            clients = generator.closed_loop(mix, load, vocab, self.seed)
        self._requests: dict = {}
        self.warm_up()

        t0 = time.monotonic()
        w0, w1 = t0 + warm_s, t0 + warm_s + self.seconds
        if self.traced and self.device.type == "cuda":
            from bench.tracing import Tracer
            slice_s = min(float(self.wl["trace_s"]), self.seconds)
            self.tracer = Tracer(w1 - slice_s, w1, self.device)
        engine = threading.Thread(target=self._engine, name="bench-engine")
        if load["loop"] == "open":
            feeder = threading.Thread(target=self._open_feeder,
                                      args=(turns, t0, w1), name="bench-feeder")
        else:
            feeder = threading.Thread(target=self._closed_clients,
                                      args=(clients, t0, w1),
                                      name="bench-clients")
        engine.start()
        feeder.start()
        try:
            self._sleep_until(w0)
            before = self._counters()
            setup_s = time.monotonic() - self.t_start
            self._sleep_until(w1)
            after = self._counters()
            if load["loop"] == "open":
                feeder.join()
                self._drain(w1, w1 + DRAIN_S)
            self._stop_feed.set()
            feeder.join()
            self._close()
            engine.join(JOIN_S)
            if engine.is_alive():
                raise RuntimeError("the serving loop did not end")
        finally:
            self._stop_feed.set()
            self.loop.stop()
        if self._error:
            raise self._error[0]
        self.pool.close()
        return self._collect(w0, w1, setup_s, before, after)

    def _engine(self) -> None:
        """The loop's thread; it also closes the traced slice, since the
        profiler it opened can be stopped only from this thread."""
        try:
            self.loop.run()
        except BaseException as e:
            self._error.append(e)
            self._stop_feed.set()
        finally:
            if self.tracer is not None:
                self.tracer.close()

    def _sleep_until(self, t: float) -> None:
        while True:
            if self._error:
                raise self._error[0]
            wait = t - time.monotonic()
            if wait <= 0:
                return
            time.sleep(min(wait, 0.05))

    def _counters(self) -> dict:
        st = self.loop.stats()
        return dict(loop=st, prefill=dict(self.pw.counters),
                    decode=dict(self.dw.counters),
                    pages=self.page_pool.stats(), pool=self.pool.stats(),
                    host=host_counts(),
                    allocator=allocator_counts(self.device))

    def _drain(self, w1: float, until: float) -> None:
        """Open loop: wait (at most until ``until``) until every accepted
        request due before ``w1`` has its first token."""
        while time.monotonic() < until and not self._error:
            outs = self.loop.outputs
            if all(not r.accepted or r.due >= w1 or (
                    r.rid in outs and outs[r.rid].tokens)
                   for r in list(self.records.values())):
                return
            time.sleep(0.02)

    def _close(self) -> None:
        """Stop the loop: queued and mid-prefill work is dropped and the
        decodes still running end at their next token (the client
        cancels them), so nothing runs past the close."""
        self.closed_at = time.monotonic()
        self.loop.stop()
        for s in list(self.dw.slots):
            if s is not None:
                s.request.max_new = max(len(s.emitted), 1)

    def _collect(self, w0, w1, setup_s, before, after) -> RunData:
        outs = self.loop.outputs
        for rid, rec in self.records.items():
            o = outs.get(rid)
            if o is None:
                continue
            rec.tokens = list(o.tokens)
            rec.token_t = list(o.token_t)
            rec.done = bool(o.done)
            rec.cut = rec.done and len(rec.tokens) < rec.max_new
        deltas = {k: {kk: after[k][kk] - before[k][kk]
                      for kk in after[k]
                      if isinstance(after[k][kk], (int, float))
                      and kk in before[k]}
                  for k in after}
        lateness = [r.sent - r.due for r in self.records.values()
                    if r.sent is not None and w0 <= r.due < w1]
        peak = reserved = 0
        if self.device.type == "cuda":
            import torch
            peak = int(torch.cuda.max_memory_allocated(self.device))
            reserved = int(torch.cuda.max_memory_reserved(self.device))
        trace = self.tracer.collect() if self.tracer is not None else None
        prompts = {rid: req.tokens for rid, req in self._requests.items()}
        return RunData(cell=self.cell,
                       arch=self.family.counts(self.cell.config),
                       window=(w0, w1), setup_s=setup_s,
                       records=self.records, spans=self.spans, deltas=deltas,
                       trace=trace,
                       lateness_p99_s=float(np.percentile(lateness, 99))
                       if lateness else 0.0,
                       memory_peak_bytes=peak, prompts=prompts,
                       closed_at=self.closed_at,
                       host_speed_s=self.host_speed_s,
                       reserved_peak_bytes=reserved)

    def free(self) -> None:
        """Drop the program's state (the weights stay, for the reference)."""
        for name in ("loop", "pw", "dw", "page_pool", "pool"):
            if hasattr(self, name):
                delattr(self, name)
        import gc
        gc.collect()
        if self.device.type == "cuda":
            import torch
            torch.cuda.empty_cache()
