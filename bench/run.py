"""One run of one cell on one card:

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

from the root of a checkout. Builds the port's kernels from the build
cache under ``build/``, draws the weights on the card from the seed,
warms up, drives the cell's traffic through ``repro_torch``'s
``ServingLoop`` for a warm phase and ``--seconds`` of measured window,
drains, checks a sample of the served tokens against the plain
reference, and prints one JSON line last on standard output. With
``--trace 0`` its metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, the device's busy and traced
seconds and a breakdown of the traced slice.

It refuses (exit 2, no result) without a CUDA card or with fewer cards
than the cell asks for, and (exit 3) if ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` is loaded in this process when the window has
closed.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}
#: host spans that can be open while the card idles, innermost first
GAP_LABELS = ("prefix_load", "stage", "store_back", "prefill_chunk", "join",
              "decode_step", "prefill_advance", "loop_iteration")
TOP = 10
#: the caching allocator grows segments in place: prompts of every length
#: come and go, and fixed segments fragment the card
ALLOC_CONF = "expandable_segments:True"
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4      # glibc's mallopt parameters


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def keep_host_pages() -> None:
    """glibc serves every host allocation from its heap and never gives
    freed memory back: the prompts' KV copies and the host pool reuse
    pages already touched (the set-up's ``host_warm_gib``) instead of
    mapping and faulting fresh ones in for every block."""
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(M_MMAP_MAX, 0)
    libc.mallopt(M_TRIM_THRESHOLD, -1)


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "bench-cache" / sub)


def breakdown(data) -> dict:
    """The traced slice's device operations that took most time, and its
    idle time by the host span open at the time (innermost first)."""
    tr = data.trace
    by_op: dict = defaultdict(float)
    for o in tr.ops:
        by_op[o.name] += o.t1 - o.t0
    starts = {}
    for name in GAP_LABELS:
        ss = sorted((s.t0, s.t1) for s in data.spans if s.name == name)
        starts[name] = ([a for a, _ in ss], [b for _, b in ss])
    idle: dict = defaultdict(float)
    for a, b in tr.gaps():
        mid = 0.5 * (a + b)
        label = "between_iterations"
        for name in GAP_LABELS:
            t0s, t1s = starts[name]
            i = bisect.bisect_right(t0s, mid) - 1
            if i >= 0 and t1s[i] > mid:
                label = name
                break
        idle[label] += b - a
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def _counts(data) -> tuple:
    """(attempted, failed). Open loop: requests due in the window; failed
    are those rejected or with no first token by the close. Closed loop:
    requests sent in the window; failed are those rejected (the close
    cuts the rest, which the clients stop waiting for)."""
    w0, w1 = data.window
    due = [r for r in data.records.values() if w0 <= r.due < w1]
    if data.cell.workload["load"]["loop"] == "closed":
        return len(due), sum(1 for r in due if not r.accepted)
    return len(due), sum(1 for r in due if not (r.accepted and r.token_t))


def diagnostics(data) -> dict:
    """What the knee sweep and the bound reading look at besides the
    metrics: token-gap and TTFT percentiles, requests finished and cut."""
    import numpy as np
    from bench.metrics import in_window, ttft
    gaps = [b - a for r in data.records.values()
            for a, b in zip(r.token_t, r.token_t[1:]) if in_window(data, b)]
    t = ttft(data)
    q = (50, 75, 90, 95, 99)
    recs = data.records.values()
    w0, w1 = data.window
    span_s: dict = defaultdict(lambda: [0, 0.0])
    for s in data.spans:
        if w0 <= s.t0 and s.t1 <= w1:
            span_s[s.name][0] += 1
            span_s[s.name][1] += s.t1 - s.t0
    return {"gap_ms": dict(zip(map(str, q), (np.percentile(gaps, q) * 1e3)
                               .tolist())) if gaps else {},
            "ttft_s": dict(zip(map(str, q), np.percentile(t, q).tolist()))
            if t else {},
            "n_gaps": len(gaps), "n_ttft": len(t),
            "finished": sum(1 for r in recs if r.done and not r.cut),
            "cut": sum(1 for r in recs if r.cut),
            "drain_s": data.closed_at - data.window[1],
            "host_speed_s": data.host_speed_s,
            "iterations": data.deltas["loop"].get("iterations"),
            "spans_n_s": dict(span_s), "host": data.deltas.get("host"),
            "allocator": data.deltas.get("allocator"),
            "reserved_peak_bytes": data.reserved_peak_bytes}


def execute(cell, seed: int, seconds: float, trace: bool, device,
            cfg=None, log=None, control: bool = False,
            diag: bool = False) -> dict:
    """The run; returns the result line as a dict (``check`` last) and,
    under ``control``, the control's reading. ``device`` may be the CPU
    only for the rehearsal at a reduced size (``cfg``)."""
    from bench import check, harness
    from bench.metrics import reader
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    h = harness.Harness(cell, seed, seconds, trace, device, cfg=cfg)
    h.build()
    data = h.run()
    params = h.params
    h.free()
    ref = h.family.reference(params, h.cfg)
    ctl = h.family.reference(params, h.cfg, control=True) if control else None
    t_ref = time.monotonic()
    verdict = check.decide(data, ref, seed, device, control=ctl)
    t_ref = time.monotonic() - t_ref
    attempted, failed = _counts(data)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = reader(m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": int(cell.entry["chips"]),
           "memory_peak_bytes": data.memory_peak_bytes}
    out = {"correct": check.passes(verdict["numbers"]),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if trace and data.trace is not None:
        dev["busy_s"] = data.trace.busy_s()
        dev["window_s"] = data.trace.window_s
        out["breakdown"] = breakdown(data)
    out["check"] = verdict["numbers"]
    d = data.deltas
    log(f"window {seconds:.0f} s: {attempted} attempted, {failed} failed; "
        f"generator lateness p99 {data.lateness_p99_s * 1e3:.3f} ms; "
        f"setup {data.setup_s:.2f} s; loop iterations "
        f"{d['loop'].get('iterations')}, decode steps "
        f"{d['loop'].get('decode_steps')}, prefill chunks "
        f"{d['loop'].get('prefill_chunks')}, rejected "
        f"{d['loop'].get('rejected')}, preemptions "
        f"{d['loop'].get('preemptions')}; prefix reused blocks "
        f"{d['prefill'].get('reused_blocks')}, computed tokens "
        f"{d['prefill'].get('computed_tokens')}; peak "
        f"{data.memory_peak_bytes} B; reference check {t_ref:.2f} s over "
        f"{len(verdict['per_request'])} requests, "
        f"{verdict['sampled_tokens']} served tokens "
        f"({verdict['reused_in_sample']} with pool prefixes)")
    log(f"diag {json.dumps(diagnostics(data))}")
    if control:
        out["control_gap"] = verdict["control_gap"]
        out["control_correct"] = check.passes(verdict["control_numbers"])
        out["per_request"] = verdict["per_request"]
    if diag:
        out["diag"] = diagnostics(data)
    return out


def _device_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(device)


def check_lines(numbers: dict) -> list:
    return [f"check {k}: {v['value']!r} "
            f"({'at least' if v.get('at_least') else 'at most'} "
            f"{v['limit']!r})" for k, v in numbers.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    keep_host_pages()
    use_checkout_caches()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF
    sys.path.insert(0, str(ROOT / "src"))
    from bench import spec
    cell = spec.find_cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    for line in check_lines(out["check"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
