"""The prefill attention kernel's bound over its device time in the
traced slice, in %. The bound of each launch (one a layer a chunk) is
from the chunk's queries and causal keys at the published heads; device
time is every ``flash_prefill`` kernel (the split pass and its combine)
in the profiler's trace."""
from bench.counts import bound_s, flash_prefill_call
from bench.metrics import traced_spans


def read(data):
    if data.trace is None:
        return None
    t, n = data.trace.time_of(lambda k: "flash_prefill" in k)
    if not n or not t:
        return None
    b = sum(data.arch.layers * bound_s(*flash_prefill_call(
        data.arch, x.info["lo"], x.info["hi"]))
        for x in traced_spans(data, "prefill_chunk"))
    return 100.0 * b / t if b else None
