"""Quickstart of the port — the counterpart of the reference's
``examples/quickstart.py``:

1. Generate a paper-statistics trace and inspect it (§4).
2. Reproduce the Table-1 cache-policy comparison on it.
3. Schedule requests through the Conductor (Algorithm 1) and compare the
   scheduling strategies of Figure 8 on a small simulated cluster, priced
   on an 8-GPU H100 node.
4. Run a real prefill with prefix reuse through the serving engine
   (``PrefillWorker``, 128-token chunks) on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--requests 3000]
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Sections 1–3 are host code; section 4 serves ``smollm-360m.reduced()``
with random weights from seed 0 on ``--device`` (a missing GPU raises,
nothing falls back to the CPU). ``simulator_sections`` and
``engine_section`` are the bodies, for callers that bring their own
instance hardware, weights, config and device.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ClusterSpec, ModelConfig, get_config
from repro_torch.core import (MooncakeCluster, TraceSpec, cache_hit_analysis,
                              generate_trace, list_policies, trace_stats)
from repro_torch.core.costmodel import InstanceSpec
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import HostKVPool, PrefillResult, PrefillWorker

RULE = "=" * 70


def simulator_sections(requests: int,
                       inst_spec: Optional[InstanceSpec] = None,
                       log=print) -> list:
    """Sections 1–3 (trace, Table 1, Figure 8), priced on ``inst_spec``
    (``None``: the default H100 node). Returns the trace."""
    log(RULE)
    log("1. Mooncake-format trace with the paper's workload statistics")
    trace = generate_trace(TraceSpec(n_requests=requests, seed=0))
    stats = trace_stats(trace)
    log(f"   {stats['n']} requests | avg input {stats['avg_input']:.0f} "
        f"tok (paper: 7,590) | avg output {stats['avg_output']:.0f} "
        f"(paper: 182)")
    log(f"   single-use blocks {stats['frac_blocks_single_use']:.0%} "
        f"(paper: >50%) | reuse ceiling {stats['max_reuse']:.0%} "
        f"(paper: ~50%)")
    log(f"   sample: {trace[0].to_json()[:100]}...")

    log(RULE)
    log("2. Cache eviction policies (Table 1): block hit rate")
    for policy in ("lru", "lfu", "length_aware"):
        rates = [cache_hit_analysis(trace, policy, cap)
                 for cap in (None, 10_000, 1_000)]
        log(f"   {policy:13s} inf={rates[0]:.2f} 10k={rates[1]:.2f} "
            f"1k={rates[2]:.2f}")

    log(RULE)
    log("3. Conductor scheduling strategies on a 4P+4D cluster (Fig 8)\n"
        "   (every policy in the registry — including any you add)")
    cfg = get_config("llama2-70b")   # the paper's dummy model
    for strategy in list_policies("prefill"):
        spec = ClusterSpec(n_prefill=4, n_decode=4, strategy=strategy,
                           inst_spec=inst_spec)
        res = MooncakeCluster.from_spec(cfg, spec).run(trace)
        log(f"   {strategy:13s} avg TTFT {res.avg_ttft():6.3f}s  "
            f"P90 {res.ttft_p90():6.3f}s  migrations={res.n_migrations}")
    return trace


def engine_section(params: dict, cfg: ModelConfig, device,
                   log=print) -> tuple[PrefillResult, PrefillResult]:
    """Section 4: two prompts sharing a 1024-token document through one
    ``PrefillWorker`` (128-token chunks); the second reuses the
    document's two blocks and computes only its 64-token tail."""
    dev = resolve_device(device)
    label = (f"reduced {cfg.name.split('-')[0]}"
             if cfg.name.endswith("-reduced") else cfg.name)
    log(RULE)
    log(f"4. Executable engine: chunked prefill with prefix reuse "
        f"({label}, {'CPU' if dev.type == 'cpu' else 'GPU'})")
    pool = HostKVPool()
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=128)
    rng = np.random.default_rng(0)
    doc = rng.integers(0, cfg.vocab_size, 1024)       # shared document
    q1 = np.concatenate([doc, rng.integers(0, cfg.vocab_size, 64)])
    q2 = np.concatenate([doc, rng.integers(0, cfg.vocab_size, 64)])
    r1 = pw(q1)
    r2 = pw(q2)
    log(f"   request 1: {r1.prompt_len} tokens, reused "
        f"{r1.reused_blocks} blocks (cold)")
    log(f"   request 2: {r2.prompt_len} tokens, reused "
        f"{r2.reused_blocks} blocks -> computed only "
        f"{r2.prompt_len - BLOCK_TOKENS * r2.reused_blocks} tokens")
    return r1, r2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.quickstart",
        description="trace, Table 1, Figure 8 on the simulator, and a "
                    "prefill with prefix reuse on the GPU")
    ap.add_argument("--requests", type=int, default=3000,
                    help="trace size for the simulator sections")
    ap.add_argument("--device", default="cuda",
                    help="device of section 4's engine (cuda or cpu)")
    return ap


def main(argv=None, inst_spec: Optional[InstanceSpec] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    simulator_sections(args.requests, inst_spec)
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    engine_section(params, cfg, device)
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
