"""Runs that set the cells' numbers, several in one process on one card:

    python3 -m bench.probe --workload <cell> --seeds 1,2,3 --seconds 20 \
        [--rates 0.1,0.2] [--control] [--faults A,B] [--trace] [--out FILE]

``--rates`` sweeps an open-loop cell's session rate (the knee is the
highest rate the system sustains: every request due in the window done
within the drain, and the backlog not growing); ``--control`` reads, for
each seed, the program's widest served-token gap and the fp8 control's
at the same positions (``check.py``), for the limit of
``workloads/<cell>.json``, and whether the control comes out correct;
``--faults`` runs every seed once with each of the named
``faults.points(cell)`` planted in the program. One JSON line per run.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import sys

from bench import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.keep_host_pages()
    run.use_checkout_caches()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = run.ALLOC_CONF
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("bench.probe runs on a CUDA card", file=sys.stderr)
        return 2
    base = spec.find_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    planted = [f for f in args.faults.split(",") if f] or [None]
    out = open(args.out, "a") if args.out else None
    for rate, fault, seed in ((r, f, int(s)) for r in rates for f in planted
                              for s in args.seeds.split(",")):
        cell = copy.copy(base)
        if rate is not None:
            cell.workload = copy.deepcopy(base.workload)
            cell.workload["load"]["session_rate"] = rate
        torch.cuda.reset_peak_memory_stats()
        with faults.plant(fault, cell) if fault else \
                contextlib.nullcontext():
            res = run.execute(cell, seed, args.seconds, args.trace,
                              torch.device("cuda", 0),
                              control=args.control, diag=True)
        res.update(workload=args.workload, seed=seed, rate=rate,
                   seconds=args.seconds, fault=fault)
        line = json.dumps(res)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    bad = run.forbidden_modules()
    if bad:
        print(f"bench.probe: JAX modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
