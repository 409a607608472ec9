"""The program's own spans and byte counters over a traced run, read into
the numbers of the loop's phases, the copies and the device's idle time:

    python3 -m bench.program_spans --workload <cell> --seeds 1,2 \
        --seconds 51 [--out FILE]

runs the cell as ``python3 -m bench.run --trace 1`` does, with
``repro_torch.serving.spans`` recording from the run's start to its
close, and prints one JSON line a run: the result line as ``bench.run``
gives it, and under ``program`` each reading below (None where there is
nothing to read), the traced slice's idle time by the innermost program
span open at each gap's midpoint, and the check of the shared clock.

Spans are on ``time.monotonic_ns()``, the clock the harness's spans and
the device trace (through its marker kernel) are on. A span counts in
the window when it starts and ends inside it, as the harness's do. The
marker leaves the trace a few milliseconds off the host's clock, so the
idle labels take the trace's shift from the program's own token copies
(``clock_fit``) and are given both before and after it.

``recording()`` turns the recorder on by patching ``harness.Harness.run``
from outside, and ``main`` repeats ``bench.run``'s set-up: both stand in
for the harness turning the recorder on in a traced run itself, and go
when it does; the readers stay.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import statistics
import sys
from collections import defaultdict

from bench import harness, run

NS = 1e-9
DISPATCH = ("decode.dispatch", "prefill.chunk_dispatch")
OUTSIDE = "outside_program_spans"
SYNCS_A_PIECE = 10      # token syncs that fit one piece of the shift
REACH_S = 0.1           # the farthest shift a fit tries


def in_window(data, spans: list, name: str) -> list:
    w0, w1 = data.window
    return [s for s in spans if s.name == name
            and w0 <= s.t0 * NS and s.t1 * NS <= w1]


def _ms(xs: list):
    return 1e3 * sum(xs) / len(xs) if xs else None


def decode_dispatch_ms(data, spans: list):
    """Mean over the window's decode steps of the host time spent
    enqueueing the step (its ``decode.dispatch`` children), in ms."""
    steps = {s.sid for s in in_window(data, spans, "decode.step")}
    per: dict = defaultdict(float)
    for s in in_window(data, spans, "decode.dispatch"):
        if s.parent in steps:
            per[s.parent] += (s.t1 - s.t0) * NS
    return _ms([per[sid] for sid in steps])


def decode_sync_wait_ms(data, spans: list):
    """Mean ``decode.token_sync`` span in the window (``nxt.cpu()``: the
    wait for the device to finish the step), in ms."""
    return _ms([(s.t1 - s.t0) * NS
                for s in in_window(data, spans, "decode.token_sync")])


def _gbps(sel: list):
    t = sum(s.t1 - s.t0 for s in sel)
    return sum(s.nbytes for s in sel) / t if sel and t else None


def kv_offload_gbps(data, spans: list):
    """Bytes over seconds of the window's ``prefill.offload`` spans (a
    finished prompt's whole KV to host memory), in GB/s."""
    return _gbps(in_window(data, spans, "prefill.offload"))


def stage_gbps(data, spans: list):
    """The same over the ``prefill.stage`` spans that wrote pages."""
    return _gbps([s for s in in_window(data, spans, "prefill.stage")
                  if s.nbytes])


def prefix_load_gbps(data, spans: list):
    """The same over the ``prefill.prefix_load`` spans."""
    return _gbps(in_window(data, spans, "prefill.prefix_load"))


def pieces(spans: list) -> tuple:
    """The engine thread's timeline cut where the innermost open span
    changes: (starts, ends, names) in seconds, sorted; the thread's spans
    nest, so a stack walk over them by start gives it. The engine thread
    is the one that ran most loop iterations (the warm-up request runs
    its own on the harness's thread)."""
    per: dict = defaultdict(int)
    for s in spans:
        if s.name == "loop.iteration":
            per[s.thread] += 1
    if not per:
        return [], [], []
    engine = max(per, key=per.get)
    mine = sorted((s for s in spans if s.thread == engine),
                  key=lambda s: (s.t0, -s.t1))
    out: list = []
    stack: list = []
    cursor = None

    def emit(end, name):
        if cursor is not None and end > cursor:
            out.append((cursor * NS, end * NS, name))

    for s in mine:
        while stack and stack[-1].t1 <= s.t0:
            top = stack.pop()
            emit(top.t1, top.name)
            cursor = top.t1
        if stack:
            emit(s.t0, stack[-1].name)
        cursor = s.t0
        stack.append(s)
    while stack:
        top = stack.pop()
        emit(top.t1, top.name)
        cursor = top.t1
    return ([a for a, _, _ in out], [b for _, b, _ in out],
            [n for _, _, n in out])


def idle_by_span(data, spans: list, fit=None) -> dict:
    """Idle seconds of the traced slice by the innermost program span open
    at each gap's midpoint (``OUTSIDE`` where none is), the trace moved by
    ``fit``'s shift (as ``clock_fit`` gives it) where one is given."""
    starts, ends, names = pieces(spans)
    idle: dict = defaultdict(float)
    for a, b in data.trace.gaps():
        mid = 0.5 * (a + b)
        if fit:
            mid += fit[1][bisect.bisect_right(fit[0], mid) - 1]
        i = bisect.bisect_right(starts, mid) - 1
        idle[names[i] if i >= 0 and ends[i] > mid else OUTSIDE] += b - a
    return dict(idle)


def dispatch_idle_share(data, spans: list, fit=None):
    """Share of the traced slice that is idle while a decode step's or a
    chunk's enqueueing is the innermost open program span, in %."""
    tr = data.trace
    if tr is None or tr.window_s <= 0 or not spans:
        return None
    idle = idle_by_span(data, spans, fit)
    return 100.0 * sum(idle.get(n, 0.0) for n in DISPATCH) / tr.window_s


def _token_syncs(data, spans: list) -> tuple:
    """The slice's ``decode.token_sync`` spans, (start, end) in seconds by
    start, and the ends of its device-to-host copies, sorted."""
    tr = data.trace
    sync = sorted((s.t0 * NS, s.t1 * NS) for s in spans
                  if s.name == "decode.token_sync"
                  and tr.t0 <= s.t0 * NS and s.t1 * NS <= tr.t1)
    return sync, sorted(o.t1 for o in tr.ops if "DtoH" in o.name)


def _best_shift(sync: list, ends: list) -> float:
    """The shift of the trace that puts a copy's end inside the most of
    ``sync``: each span and each copy end e within ``REACH_S`` allow the
    shifts [a - e, b - e]; a sweep over them finds the intervals of shift
    the most spans allow, and of those the nearest to 0 (steps that come
    at a steady pace allow shifts a step apart) gives its middle."""
    events = []
    for a, b in sync:
        lo = bisect.bisect_left(ends, a - REACH_S)
        hi = bisect.bisect_right(ends, b + REACH_S)
        merged: list = []       # a span counts once
        for x, y in sorted((a - e, b - e) for e in ends[lo:hi]):
            if merged and x <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], y)
            else:
                merged.append([x, y])
        for x, y in merged:
            events += [(x, 1), (y, -1)]
    events.sort(key=lambda ev: (ev[0], -ev[1]))
    best, cur, at = 0, 0, 0.0
    for (x, d), nxt in zip(events, events[1:]):
        cur += d
        mid = 0.5 * (x + nxt[0])
        if cur > best or (cur == best and abs(mid) < abs(at)):
            best, at = cur, mid
    return at


def clock_fit(data, spans: list):
    """The trace's shift onto the host's clock, fitted piece by piece: the
    host returns from ``nxt.cpu()`` only after the token copy ends, so
    each ``decode.token_sync`` span must hold a device-to-host copy's
    end. The slice's syncs are cut into pieces of about
    ``SYNCS_A_PIECE``, each given the shift that aligns the most of its
    own; a piece starts where its first sync does (the first at the
    slice's start). ([host starts], [shifts in s]), or None where the
    slice holds no sync or no copy."""
    if data.trace is None:
        return None
    sync, ends = _token_syncs(data, spans)
    if not sync or not ends:
        return None
    k = max(1, round(len(sync) / SYNCS_A_PIECE))
    cut = [len(sync) * i // k for i in range(k + 1)]
    starts = [data.trace.t0] + [sync[c][0] for c in cut[1:-1]]
    return starts, [_best_shift(sync[lo:hi], ends)
                    for lo, hi in zip(cut, cut[1:])]


def _nearest(sync: list, ends: list, fit=None) -> list:
    """For each span, the seconds from the nearest copy's end (the trace
    moved by ``fit``) to the span's end (above 0: the copy ended first),
    and whether that end lies inside the span."""
    out = []
    for a, b in sync:
        shift = fit[1][bisect.bisect_right(fit[0], a) - 1] if fit else 0.0
        i = bisect.bisect_right(ends, b - shift)
        e = min(ends[max(i - 1, 0):i + 1], key=lambda x: abs(x + shift - b))
        out.append((b - e - shift, a <= e + shift <= b))
    return out


def _quartiles_us(xs: list):
    if len(xs) < 2:
        return [1e6 * x for x in xs * 3]
    q = statistics.quantiles(xs, n=4)
    return [1e6 * q[0], 1e6 * statistics.median(xs), 1e6 * q[2]]


def clock_check(data, spans: list, fit=None):
    """The shared clock, checked on the ``decode.token_sync`` spans of the
    slice: the share that hold a device-to-host copy's end as the trace
    is mapped (%), and with ``fit`` applied; after the fit, the median
    from that copy's end to the span's end over the spans that hold one
    (us), and the quartiles of the nearest copy's end before the span's
    end over all of them (us), which are the fit's scatter; the fit's
    shifts (us; above 0 moves the trace later)."""
    if data.trace is None:
        return None
    sync, ends = _token_syncs(data, spans)
    if not sync or not ends:
        return None
    before, after = _nearest(sync, ends), _nearest(sync, ends, fit)
    held = [r for r, inside in after if inside]
    return {"spans": len(sync),
            "share_pct": 100.0 * sum(i for _, i in before) / len(sync),
            "aligned_share_pct": 100.0 * len(held) / len(sync),
            "median_us": 1e6 * statistics.median(held) if held else None,
            "nearest_end_us": _quartiles_us([r for r, _ in after]),
            "shifts_us": [1e6 * x for x in fit[1]] if fit else None}


def prefills_in_flight(data, spans: list):
    from bench.metrics import reader
    return reader("prefills_in_flight")(data)


READINGS = (decode_dispatch_ms, decode_sync_wait_ms, kv_offload_gbps,
            stage_gbps, prefix_load_gbps, prefills_in_flight,
            dispatch_idle_share)


def _top(idle: dict) -> list:
    return [[k, v] for k, v in
            sorted(idle.items(), key=lambda kv: -kv[1])[:run.TOP]]


def readings(data, spans: list, dropped: int = 0) -> dict:
    """Each reading; the idle labels and ``dispatch_idle_share`` as the
    trace is mapped (as the harness's breakdown labels its gaps) and, as
    ``_aligned``, after the clock fit, whose check says how far to trust
    it."""
    out = {f.__name__: f(data, spans) for f in READINGS}
    if data.trace is not None:
        fit = clock_fit(data, spans)
        out["dispatch_idle_share_aligned"] = \
            dispatch_idle_share(data, spans, fit) if fit else None
        out["idle_by_program_span"] = _top(idle_by_span(data, spans))
        out["idle_by_program_span_aligned"] = \
            _top(idle_by_span(data, spans, fit)) if fit else None
        out["clock_check"] = clock_check(data, spans, fit)
    out["spans"] = len(spans)
    out["dropped"] = dropped
    return out


@contextlib.contextmanager
def recording(kept: list):
    """Each ``harness.Harness.run`` inside records the program's spans;
    (its RunData, the spans, the recorder's drop count) lands in
    ``kept``."""
    from repro_torch.serving import spans
    orig = harness.Harness.run

    def recorded(self):
        spans.take()
        spans.enable()
        try:
            data = orig(self)
        finally:
            spans.disable()
        kept.append((data, spans.take(), spans.dropped))
        return data

    harness.Harness.run = recorded
    try:
        yield kept
    finally:
        harness.Harness.run = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.keep_host_pages()
    run.use_checkout_caches()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = run.ALLOC_CONF
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("bench.program_spans runs on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        kept: list = []
        torch.cuda.reset_peak_memory_stats()
        with recording(kept):
            res = run.execute(cell, seed, args.seconds, True,
                              torch.device("cuda", 0), diag=True)
        data, spans, dropped = kept.pop()
        res.update(workload=args.workload, seed=seed, seconds=args.seconds,
                   program=readings(data, spans, dropped))
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del data, spans
        gc.collect()
        torch.cuda.empty_cache()
    bad = run.forbidden_modules()
    if bad:
        print(f"bench.program_spans: JAX modules loaded: {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
