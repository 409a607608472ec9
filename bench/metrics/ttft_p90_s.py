"""90th percentile, over every request due in the window, of due time
to first token (failed requests wait until the close)."""
from bench.metrics import pct, ttft


def read(data):
    return pct(ttft(data), 90)
