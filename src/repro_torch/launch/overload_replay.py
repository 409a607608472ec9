"""Overload-scenario replay (§7/§8.2) — the counterpart of the reference's
``examples/overload_replay.py``: the three admission policies handle a
sped-up trace replay on an 8P+8D simulated cluster — rejected counts,
wasted prefill, goodput, and the anti-phase load fluctuation that
prediction-based early rejection damps (Figures 9/10, Table 3). Priced
on 8-GPU H100 nodes unless the caller passes another ``InstanceSpec``.

    PYTHONPATH=src python -m repro_torch.launch.overload_replay \\
        [--requests 4000] [--speedup 4]

``replay`` is the body; it returns each policy's ``SimResult``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

from repro_torch.configs.base import ClusterSpec, get_config
from repro_torch.core import (MooncakeCluster, TraceSpec, generate_trace,
                              list_policies)
from repro_torch.core.costmodel import InstanceSpec


def sparkline(vals, width=60):
    bars = " ▁▂▃▄▅▆▇█"
    if not len(vals):
        return ""
    vals = np.asarray(vals, dtype=float)
    idx = np.linspace(0, len(vals) - 1, width).astype(int)
    v = vals[idx]
    hi = max(v.max(), 1e-9)
    return "".join(bars[int(min(x / hi, 1.0) * (len(bars) - 1))] for x in v)


def replay_trace(requests: int) -> list:
    """The replay's trace: seed 2, long outputs (out_mu 5.9)."""
    return generate_trace(TraceSpec(n_requests=requests, seed=2,
                                    out_mu=5.9))


def replay(reqs: list, speedup: float,
           inst_spec: Optional[InstanceSpec] = None, log=print) -> dict:
    """Replay ``reqs`` at ``speedup`` under every registered admission
    policy (8P+8D, TTFT SLO 30 s, TBT SLO 0.1 s, t_d 20 s); prints each
    policy's lines and returns ``{policy: SimResult}``."""
    cfg = get_config("llama2-70b")
    log(f"replaying {len(reqs)} requests at {speedup}x on 8P+8D\n")
    out = {}
    for adm in list_policies("admission"):
        spec = ClusterSpec(n_prefill=8, n_decode=8, ttft_slo=30,
                           tbt_slo=0.1, admission=adm, t_d=20.0,
                           inst_spec=inst_spec)
        res = MooncakeCluster.from_spec(cfg, spec).run(
            reqs, speedup=speedup, load_sample_dt=5.0)
        waste = sum(1 for r in res.records
                    if r.reject_stage == "decode_doublecheck")
        dload = [d for _, _, d in res.load_samples]
        pload = [p for _, p, _ in res.load_samples]
        log(f"--- {adm} ---")
        log(f"rejected {len(res.rejected())} "
            f"(after prefill: {waste}) | completed "
            f"{len(res.completed())} | goodput "
            f"{res.goodput(30, .1):.2f} req/s")
        log(f"rejects by reason: {res.reject_breakdown()}")
        log(f"prefill load |{sparkline(pload)}|")
        log(f"decode load  |{sparkline(dload)}|  "
            f"std={np.std(dload):.2f}\n")
        out[adm] = res
    return out


def main(argv=None, inst_spec: Optional[InstanceSpec] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.overload_replay",
        description="the three admission policies on a sped-up replay")
    ap.add_argument("--requests", type=int, default=4000)
    ap.add_argument("--speedup", type=float, default=4.0)
    args = ap.parse_args(argv)
    replay(replay_trace(args.requests), args.speedup, inst_spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
