"""The paged decode kernel's bound over its device time in the traced
slice, in %. The bound of each launch (one a layer a step) is from the
step's live lengths at the published heads; device time is every
``paged_decode_kernel`` in the profiler's trace."""
from bench.counts import bound_s, paged_attention_call
from bench.metrics import traced_spans


def read(data):
    if data.trace is None:
        return None
    t, n = data.trace.time_of(lambda k: "paged_decode_kernel" in k)
    if not n or not t:
        return None
    b = sum(data.arch.layers * bound_s(*paged_attention_call(
        data.arch, x.info["batch"], x.info["keys"]))
        for x in traced_spans(data, "decode_step"))
    return 100.0 * b / t if b else None
