"""Prompt tokens restored from the host pool over all prompt tokens the
prefill worker finished in the window (its ``reused_blocks`` and
``computed_tokens`` counters), in %."""
from bench.generator import BLOCK


def read(data):
    d = data.deltas["prefill"]
    reused = d.get("reused_blocks", 0) * BLOCK
    total = reused + d.get("computed_tokens", 0)
    return 100.0 * reused / total if total else None
