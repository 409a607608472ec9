"""Mean host time of a prefill chunk in the window (``_chunk_extend``,
which ends in a synchronise), in ms."""
from bench.metrics import spans


def read(data):
    s = spans(data, "prefill_chunk")
    return 1e3 * sum(x.t1 - x.t0 for x in s) / len(s) if s else None
