"""Every model operation of the window (prefill chunks and decode steps
that ended in it, at the published sizes) over the window, as a share of
the card's bf16 peak, in %."""
from bench.counts import PEAK_FLOPS, chunk_flops, decode_flops
from bench.metrics import spans


def read(data):
    w0, w1 = data.window
    f = sum(chunk_flops(data.arch, x.info["lo"], x.info["hi"],
                        x.info["hi"] == x.info["S"])
            for x in spans(data, "prefill_chunk"))
    f += sum(decode_flops(data.arch, x.info["batch"], x.info["keys"])
             for x in spans(data, "decode_step"))
    return 100.0 * f / (w1 - w0) / PEAK_FLOPS if f else None
