"""Request traces — the Mooncake open-trace format (§4) plus a generator
that reproduces the paper's workload statistics.

Open format (JSONL), one request per line::

    {"timestamp": 27482, "input_length": 6955, "output_length": 52,
     "hash_ids": [46, 47, ..., 2354]}

* ``timestamp``      — relative arrival time in milliseconds (0 .. 3,600,000)
* ``input_length``   — number of input tokens
* ``output_length``  — number of output tokens
* ``hash_ids``       — prefix-chained block hashes (block = 512 tokens);
                       identical ids ⇒ identical token block *and* prefix,
                       hence KVCache-reusable (Figure 3).

The generator targets the paper's §4.2 statistics:
  avg input ≈ 7,590 tokens; avg output ≈ 182 tokens; ~23.6k requests/hour;
  >50% of blocks never reused while hot blocks (system prompts) are hit
  tens of thousands of times (Figure 6); max theoretical reuse ≈ 50%
  (Table 1 ∞-capacity hit rate ≈ 0.51).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

BLOCK_TOKENS = 512  # the paper's trace block size


@dataclass
class Request:
    req_id: int
    timestamp: int          # ms
    input_length: int       # tokens
    output_length: int      # tokens
    hash_ids: list[int]     # prefix-chained block ids, len == ceil(in/512)
    priority: int = 0       # 0 = normal; higher = more important (§10)

    @property
    def n_blocks(self) -> int:
        return len(self.hash_ids)

    def to_json(self) -> str:
        return json.dumps(dict(timestamp=self.timestamp,
                               input_length=self.input_length,
                               output_length=self.output_length,
                               hash_ids=self.hash_ids))


def load_trace(path: str, limit: Optional[int] = None) -> list[Request]:
    """Load the Mooncake open JSONL trace format verbatim."""
    out: list[Request] = []
    with open(path) as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(Request(req_id=i, timestamp=int(d["timestamp"]),
                               input_length=int(d["input_length"]),
                               output_length=int(d["output_length"]),
                               hash_ids=list(d["hash_ids"])))
    out.sort(key=lambda r: r.timestamp)
    return out


def save_trace(requests: Iterable[Request], path: str) -> None:
    with open(path, "w") as f:
        for r in requests:
            f.write(r.to_json() + "\n")


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

@dataclass
class TraceSpec:
    n_requests: int = 23_608
    duration_ms: int = 3_600_000
    seed: int = 0
    # workload mixture — fractions sum to 1
    frac_chat: float = 0.36          # short multi-turn chat
    frac_doc: float = 0.22           # long-document sessions (Kimi-style)
    frac_oneshot: float = 0.42       # cold one-shot requests, no reuse
    # length parameters (tokens)
    chat_turn_mu: float = 6.2        # lognormal of per-turn new input
    chat_turn_sigma: float = 0.8
    doc_len_mu: float = 8.9          # lognormal of document length
    doc_len_sigma: float = 0.7
    out_mu: float = 4.7              # lognormal of output length (mean ≈ 182)
    out_sigma: float = 1.0
    # session structure
    n_system_prompts: int = 24       # hot shared prefixes
    system_prompt_blocks: tuple = (1, 13)   # uniform range
    zipf_s: float = 2.0              # popularity skew of system prompts
    chat_session_turns: tuple = (1, 6)
    doc_session_turns: tuple = (1, 3)
    max_input_tokens: int = 131_072


def generate_trace(spec: TraceSpec = TraceSpec()) -> list[Request]:
    """Synthesise a trace matching the paper's §4 statistics.

    Structure: sessions draw a (hot, Zipf-weighted) system prompt prefix;
    successive turns in a session extend the same hash chain (previous input
    + previous output + new input), which is exactly how real multi-turn
    reuse produces identical prefix hash ids.
    """
    rng = np.random.default_rng(spec.seed)
    next_hash = 0

    def fresh(n: int) -> list[int]:
        nonlocal next_hash
        ids = list(range(next_hash, next_hash + n))
        next_hash += n
        return ids

    # hot system prompts — Zipf popularity (Figure 6's heavy head)
    sys_prompts = [fresh(int(rng.integers(*spec.system_prompt_blocks)))
                   for _ in range(spec.n_system_prompts)]
    zipf_w = 1.0 / np.arange(1, spec.n_system_prompts + 1) ** spec.zipf_s
    zipf_w /= zipf_w.sum()

    requests: list[Request] = []
    rid = 0

    def out_len() -> int:
        return int(np.clip(rng.lognormal(spec.out_mu, spec.out_sigma), 1, 4096))

    def emit(ts: int, chain: list[int], in_tokens: int) -> Request:
        nonlocal rid
        in_tokens = min(in_tokens, spec.max_input_tokens)
        n_blocks = max(math.ceil(in_tokens / BLOCK_TOKENS), 1)
        # extend the chain with fresh tail blocks to cover the input
        if n_blocks > len(chain):
            chain = chain + fresh(n_blocks - len(chain))
        r = Request(req_id=rid, timestamp=ts, input_length=in_tokens,
                    output_length=out_len(), hash_ids=chain[:n_blocks])
        rid += 1
        requests.append(r)
        return r

    n = spec.n_requests
    kinds = rng.choice(3, size=n, p=[spec.frac_chat, spec.frac_doc,
                                     spec.frac_oneshot])
    # sessions arrive as Poisson process; turns follow with think-time gaps
    budget = {0: int((kinds == 0).sum()), 1: int((kinds == 1).sum()),
              2: int((kinds == 2).sum())}

    def session_start() -> int:
        return int(rng.uniform(0, spec.duration_ms * 0.97))

    # --- chat sessions ---
    left = budget[0]
    while left > 0:
        turns = min(int(rng.integers(*spec.chat_session_turns)), left)
        left -= turns
        ts = session_start()
        sp = sys_prompts[rng.choice(spec.n_system_prompts, p=zipf_w)]
        chain = list(sp)
        total_in = len(chain) * BLOCK_TOKENS
        for _ in range(turns):
            new_in = int(np.clip(rng.lognormal(spec.chat_turn_mu,
                                               spec.chat_turn_sigma), 16, 32768))
            total_in += new_in
            r = emit(ts, chain, total_in)
            chain = list(r.hash_ids)
            # next turn context = this turn's input + its output
            total_in = r.input_length + r.output_length
            ts += int(rng.exponential(45_000)) + r.output_length * 40

    # --- long-document sessions ---
    left = budget[1]
    while left > 0:
        turns = min(int(rng.integers(*spec.doc_session_turns)), left)
        left -= turns
        ts = session_start()
        sp = sys_prompts[rng.choice(spec.n_system_prompts, p=zipf_w)]
        doc = int(np.clip(rng.lognormal(spec.doc_len_mu, spec.doc_len_sigma),
                          2048, spec.max_input_tokens))
        chain = list(sp)
        total_in = len(chain) * BLOCK_TOKENS + doc
        for _ in range(turns):
            r = emit(ts, chain, total_in)
            chain = list(r.hash_ids)
            total_in = r.input_length + r.output_length \
                + int(rng.lognormal(5.5, 0.8))  # follow-up question
            ts += int(rng.exponential(60_000)) + r.output_length * 40

    # --- one-shot cold requests ---
    for _ in range(budget[2]):
        ts = session_start()
        L = int(np.clip(rng.lognormal(7.6, 1.3), 32, spec.max_input_tokens))
        emit(ts, [], L)

    # session turns can run past the window; the trace is a 1-hour sample
    requests = [r for r in requests if r.timestamp <= spec.duration_ms]
    requests.sort(key=lambda r: r.timestamp)
    for i, r in enumerate(requests):
        r.req_id = i
    return requests


def simulated_requests(n: int, input_len: int, output_len: int = 512,
                       cache_ratio: float = 0.5, rps: float = 1.0,
                       seed: int = 0) -> list[Request]:
    """§8.1.2 simulated data: fixed lengths, fixed prefix-cache ratio,
    Poisson arrivals at ``rps`` requests/second."""
    rng = np.random.default_rng(seed)
    n_blocks = math.ceil(input_len / BLOCK_TOKENS)
    shared_blocks = int(n_blocks * cache_ratio)
    gaps = rng.exponential(1000.0 / max(rps, 1e-9), size=n)
    ts = np.cumsum(gaps).astype(int)
    out: list[Request] = []
    next_hash = 10**9  # disjoint from generator ids
    # requests pair-share prefixes so cache_ratio of blocks hit on 2nd use
    shared_pool: list[list[int]] = []
    for i in range(n):
        if shared_blocks and shared_pool and rng.random() < 0.5:
            prefix = shared_pool[int(rng.integers(len(shared_pool)))]
        else:
            prefix = list(range(next_hash, next_hash + shared_blocks))
            next_hash += shared_blocks
            if shared_blocks:
                shared_pool.append(prefix)
        tail = list(range(next_hash, next_hash + n_blocks - shared_blocks))
        next_hash += n_blocks - shared_blocks
        out.append(Request(req_id=i, timestamp=int(ts[i]),
                           input_length=input_len, output_length=output_len,
                           hash_ids=prefix + tail))
    return out


def trace_stats(requests: list[Request]) -> dict:
    ins = np.array([r.input_length for r in requests])
    outs = np.array([r.output_length for r in requests])
    all_blocks: dict[int, int] = {}
    for r in requests:
        for h in r.hash_ids:
            all_blocks[h] = all_blocks.get(h, 0) + 1
    counts = np.array(list(all_blocks.values()))
    return dict(
        n=len(requests),
        avg_input=float(ins.mean()),
        avg_output=float(outs.mean()),
        p50_input=float(np.percentile(ins, 50)),
        p99_input=float(np.percentile(ins, 99)),
        n_unique_blocks=len(all_blocks),
        frac_blocks_single_use=float((counts == 1).mean()),
        max_block_hits=int(counts.max()),
        # upper bound on reuse: hits beyond first use / total block touches
        max_reuse=float((counts - 1).sum() / counts.sum()),
    )
