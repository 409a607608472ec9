"""Data pipeline of the port (own copy of the reference's
``data/pipeline.py``, numpy only, so both packages produce the same
arrays from the same seed):

* ``SyntheticLM``: deterministic, seekable synthetic training batches —
  a skewed unigram stream with injected bigram structure, so the loss
  has signal to descend;
* ``realize_request_tokens``: token realisation of trace requests —
  equal hash ids yield equal 512-token blocks, so engine-level prefix
  caching reproduces the trace's prefix-sharing structure exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace import BLOCK_TOKENS, Request


@dataclass
class BatchSpec:
    batch: int
    seq: int
    vocab: int
    frontend: str = "none"      # none | patch | audio
    frontend_tokens: int = 0
    d_model: int = 0


class SyntheticLM:
    """Deterministic, seekable synthetic token stream.

    Tokens follow a skewed unigram distribution with short-range structure
    (a degree-2 Markov mix) so the training loss has signal to descend —
    a pure-uniform stream trains to log(V) and nothing moves.
    """

    def __init__(self, spec: BatchSpec, seed: int = 0) -> None:
        self.spec = spec
        self.seed = seed
        rng = np.random.default_rng(seed)
        v = spec.vocab
        self._uni = rng.zipf(1.3, size=4 * v) % v   # skewed unigram pool
        self._shift = rng.integers(1, v, size=64)

    def batch(self, step: int) -> dict:
        """One training batch of numpy arrays: tokens and next-token
        labels (B, S) int32, and the stub frontend's patches or frames
        (B, F, d_model) float32 where the config has one."""
        spec = self.spec
        rng = np.random.default_rng((self.seed, step))
        pool = self._uni
        base = pool[rng.integers(0, len(pool),
                                 size=(spec.batch, spec.seq + 1))]
        # inject predictable bigram structure: x[t+1] = (x[t] + s) % V for
        # a per-row shift s on half the positions
        s = self._shift[rng.integers(0, len(self._shift), size=(spec.batch, 1))]
        mask = rng.random((spec.batch, spec.seq + 1)) < 0.5
        seq = base.copy()
        for t in range(1, spec.seq + 1):
            seq[:, t] = np.where(mask[:, t],
                                 (seq[:, t - 1] + s[:, 0]) % spec.vocab,
                                 seq[:, t])
        out = {"tokens": seq[:, :-1].astype(np.int32),
               "labels": seq[:, 1:].astype(np.int32)}
        if spec.frontend in ("patch", "audio"):
            key = "patches" if spec.frontend == "patch" else "frames"
            out[key] = rng.standard_normal(
                (spec.batch, spec.frontend_tokens, spec.d_model),
                dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batch_spec_for(cfg: ModelConfig, batch: int, seq: int) -> BatchSpec:
    return BatchSpec(batch=batch, seq=seq, vocab=cfg.vocab_size,
                     frontend=cfg.frontend,
                     frontend_tokens=cfg.frontend_tokens,
                     d_model=cfg.d_model)


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
