"""Every model operation of the window (prefill chunks and decode steps
that ended in it, at the published sizes, as the family's counts give
them) over the window, as a share of the card's bf16 peak, in %."""
from bench.counts import PEAK_FLOPS
from bench.metrics import spans


def read(data):
    w0, w1 = data.window
    a = data.arch
    f = sum(a.chunk_flops(x.info["lo"], x.info["hi"],
                          x.info["hi"] == x.info["S"])
            for x in spans(data, "prefill_chunk"))
    f += sum(a.decode_flops(x.info["batch"], x.info["keys"])
             for x in spans(data, "decode_step"))
    return 100.0 * f / (w1 - w0) / PEAK_FLOPS if f else None
