"""``bench/program_spans.py``: the program's spans read over a run. A
traced rehearsal of each committed cell with the recorder on reports
every reading a CPU run can give (the device-trace ones need the
profiler's slice); an untraced run leaves the recorder off; the idle
labels and the clock check read as placed on a hand-built trace."""
import threading
from types import SimpleNamespace

import pytest
import torch

from bench import program_spans, run, spec
from bench.tracing import DeviceOp, Trace
from conftest import CELLS, reuses
from repro_torch.serving import spans

ON_CPU = ("decode_dispatch_ms", "decode_sync_wait_ms", "kv_offload_gbps",
          "stage_gbps", "prefills_in_flight")


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_reads_the_program(tiny_cell, name):
    cell, cfg = tiny_cell(name)
    kept: list = []
    with program_spans.recording(kept):
        out = run.execute(cell, 2 ** 32 + 11, 3.0, True, torch.device("cpu"),
                          cfg=cfg, log=lambda s: None)
    assert spans.span("after") is spans.span("run")     # off again
    assert out["correct"]
    data, ps, dropped = kept.pop()
    got = program_spans.readings(data, ps, dropped)
    want = ON_CPU + (("prefix_load_gbps",) if reuses(name) else ())
    assert all(got[k] is not None and got[k] > 0 for k in want), got
    assert got["dispatch_idle_share"] is None          # no device trace
    assert got["spans"] > 0 and got["dropped"] == 0
    listed = [m["name"] for m in spec.benchmark()["per_layer"]
              if m["name"].startswith("prefills_in_flight.")
              and name in m.get("workloads", ())]
    assert [k for k in out["metrics"] if k in listed] == listed


def test_untraced_rehearsal_records_no_program_span(tiny_cell):
    cell, cfg = tiny_cell(CELLS[0])
    spans.take()
    out = run.execute(cell, 2 ** 32 + 13, 3.0, False, torch.device("cpu"),
                      cfg=cfg, log=lambda s: None)
    assert out["correct"] and spans.take() == []


def _span(sid, name, t0, t1, parent=None, thread=None, nbytes=None):
    return spans.Span(sid, name, int(t0 * 1e9), int(t1 * 1e9), parent,
                      thread or threading.get_ident(), None, nbytes)


def test_idle_labels_and_clock_check_on_a_hand_built_trace():
    """One gap inside ``decode.dispatch``, one outside it; one token copy
    inside a ``decode.token_sync`` span, one span without a copy. The
    warm-up's iteration, on another thread, labels nothing."""
    trace = Trace(t0=0.0, t1=1.0, ops=[
        DeviceOp("gemm", 0.0, 0.2),
        DeviceOp("Memcpy DtoH (Device -> Pageable)", 0.45, 0.46),
        DeviceOp("gemm", 0.6, 0.65), DeviceOp("gemm", 0.65, 1.0)])
    ps = [_span(9, "loop.iteration", -0.5, 0.99, thread=-1),
          _span(1, "loop.iteration", 0.0, 1.0),
          _span(6, "loop.iteration", 1.0, 1.2),
          _span(2, "decode.step", 0.1, 0.5, 1),
          _span(3, "decode.dispatch", 0.15, 0.4, 2),
          _span(4, "decode.token_sync", 0.42, 0.47, 2),
          _span(5, "decode.token_sync", 0.7, 0.8, 1)]
    data = SimpleNamespace(trace=trace, window=(0.0, 1.0))
    idle = program_spans.idle_by_span(data, ps)
    assert idle == pytest.approx({"decode.dispatch": 0.25,
                                  "loop.iteration": 0.14})
    share = program_spans.dispatch_idle_share(data, ps)
    assert share == pytest.approx(25.0)
    assert share <= 100.0 * (1 - trace.busy_s() / trace.window_s)
    check = program_spans.clock_check(data, ps)
    assert check["share_pct"] == pytest.approx(50.0) and check["spans"] == 2
    assert check["median_us"] == pytest.approx(1e4)
    assert check["nearest_end_us"][1] == pytest.approx(1.75e5)   # 10, 340 ms
    assert program_spans.decode_dispatch_ms(data, ps) == pytest.approx(250.0)
    assert program_spans.decode_sync_wait_ms(data, ps) == pytest.approx(75.0)


def _steps(n, lag, drift=0.0):
    """``n`` decode steps 0.1 s apart on the host: each enqueues for 60 ms
    (the card idle), waits 0.2 ms for its tokens, whose copy ends 50 us
    before the wait does; the trace is mapped ``lag`` s early, ``drift``
    s more by the slice's end."""
    ops, ps = [], [_span(1, "loop.iteration", 0.0, 0.1 * n + 0.05)]
    for i in range(n):
        t = 0.1 * i + 0.01
        early = lag + drift * t / (0.1 * n)
        done = t + 0.0602 - 5e-5 - early
        ops += [DeviceOp("gemm", done - 0.005, done - 1e-5),
                DeviceOp("Memcpy DtoH (Device -> Pageable)", done - 1e-5,
                         done)]
        sid = 10 * i + 10
        ps += [_span(sid, "decode.step", t, t + 0.0603, 1),
               _span(sid + 1, "decode.dispatch", t, t + 0.06, sid),
               _span(sid + 2, "decode.token_sync", t + 0.06, t + 0.0602,
                     sid)]
    return SimpleNamespace(trace=Trace(t0=0.0, t1=0.1 * n + 0.05, ops=ops),
                           window=(0.0, 0.1 * n + 0.05),
                           deltas={"loop": {}}), ps


@pytest.mark.parametrize("lag,drift", [(0.004, 0.0), (-0.03, 0.0),
                                       (0.008, 0.0003)])
def test_clock_fit_recovers_the_traces_shift(lag, drift):
    """A trace mapped off the host's clock, by a fixed amount or one that
    drifts over the slice by less than a sync span a piece of the fit:
    the fit puts every token copy's end back inside its sync span, and
    the idle time of each step's enqueue back under ``decode.dispatch``."""
    data, ps = _steps(40, lag, drift)
    fit = program_spans.clock_fit(data, ps)
    check = program_spans.clock_check(data, ps, fit)
    assert check["share_pct"] == 0.0 and check["aligned_share_pct"] == 100.0
    assert check["median_us"] == pytest.approx(50.0, abs=100.0)
    assert max(map(abs, check["nearest_end_us"])) < 200.0
    assert all(abs(x - 1e6 * lag) <= 1e6 * drift + 200.0
               for x in check["shifts_us"])
    aligned = program_spans.idle_by_span(data, ps, fit)
    assert aligned["decode.dispatch"] > 0.95 * sum(aligned.values())
    got = program_spans.readings(data, ps)
    assert got["clock_check"]["aligned_share_pct"] == 100.0
    assert got["dispatch_idle_share_aligned"] == pytest.approx(
        program_spans.dispatch_idle_share(data, ps, fit))
    assert got["dispatch_idle_share_aligned"] >= got["dispatch_idle_share"]
