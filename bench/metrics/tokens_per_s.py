"""Prompt tokens made ready in the window (computed by a chunk or
restored from the host pool, counted when that call ends) plus output
tokens emitted in the window, over the window."""
from bench.generator import BLOCK
from bench.metrics import in_window, spans


def read(data):
    w0, w1 = data.window
    n = sum(s.info["hi"] - s.info["lo"] for s in spans(data, "prefill_chunk"))
    n += sum(s.info["blocks"] * BLOCK for s in spans(data, "prefix_load"))
    n += sum(1 for r in data.records.values() for t in r.token_t
             if in_window(data, t))
    return n / (w1 - w0)
