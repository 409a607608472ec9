"""One reader per metric: ``bench/metrics/<name>.py`` with
``read(data) -> float | None`` over a run's ``harness.RunData``. The
part of a metric's name after the first dot names the cell family it is
reported for (``prefill_chunk_ms.backlog``) and selects the same reader.
A reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""
from __future__ import annotations

import importlib

import numpy as np


def reader(name: str):
    return importlib.import_module(f"bench.metrics.{name.split('.')[0]}").read


def in_window(data, t: float) -> bool:
    return data.window[0] <= t < data.window[1]


def due_in_window(data) -> list:
    return [r for r in data.records.values() if in_window(data, r.due)]


def ttft(data) -> list:
    """Due time to first token of every request due in the window; one
    that failed (rejected, or no first token by the close) counts as
    waiting until the close."""
    return [r.token_t[0] - r.due if r.accepted and r.token_t
            else data.closed_at - r.due for r in due_in_window(data)]


def pct(xs, q: float):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def spans(data, name: str, lo=None, hi=None) -> list:
    w0, w1 = data.window
    return data.spans_named(name, w0 if lo is None else lo,
                            w1 if hi is None else hi)


def traced_spans(data, name: str) -> list:
    """Spans inside the traced slice (whole iterations)."""
    return spans(data, name, data.trace.t0, data.trace.t1)
