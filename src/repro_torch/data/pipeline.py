"""Token realisation of trace requests (own copy of the reference's
``data/pipeline.realize_request_tokens``): equal hash ids yield equal
512-token blocks, so engine-level prefix caching reproduces the trace's
prefix-sharing structure exactly. numpy only, so both packages produce
the same payloads from the same trace."""
from __future__ import annotations

import numpy as np

from repro_torch.core.trace import BLOCK_TOKENS, Request


def realize_request_tokens(req: Request, vocab: int) -> np.ndarray:
    blocks = []
    for h in req.hash_ids:
        rng = np.random.default_rng(h)
        blocks.append(rng.integers(0, vocab, BLOCK_TOKENS, dtype=np.int64))
    flat = np.concatenate(blocks) if blocks else np.empty(0, np.int64)
    n = req.input_length
    if len(flat) < n:
        rng = np.random.default_rng((req.req_id, n))
        flat = np.concatenate(
            [flat, rng.integers(0, vocab, n - len(flat), dtype=np.int64)])
    return flat[:n].astype(np.int32)
