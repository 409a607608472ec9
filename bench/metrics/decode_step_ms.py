"""Mean host time of a decode step in the window (``DecodeWorker.step``,
which ends copying the tokens to the host), in ms."""
from bench.metrics import spans


def read(data):
    s = spans(data, "decode_step")
    return 1e3 * sum(x.t1 - x.t0 for x in s) / len(s) if s else None
