"""95th percentile of every gap between a request's consecutive token
stamps, over the gaps that end in the window, in ms."""
from bench.metrics import in_window, pct


def read(data):
    gaps = [b - a for r in data.records.values()
            for a, b in zip(r.token_t, r.token_t[1:]) if in_window(data, b)]
    v = pct(gaps, 95)
    return None if v is None else v * 1e3
