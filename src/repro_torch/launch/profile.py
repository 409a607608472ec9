"""Where a serving step's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile

Prefills the launcher's workload (8 requests of the generated trace,
prompts capped at 1536 tokens) into a full decode batch at full width
(random weights, seed 0), then, under ``torch.profiler``, runs five decode
steps and five 256-token prefill chunks at offset 1280. For each it prints
the host wall time (synchronised), the device busy time (the sum of the
kernels' device time), the device's idle share, the kernel count, and
the kernels that took the most device time. GPU only.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import MAX_LEN, make_payloads
from repro_torch.models.transformer import decode_step, init_caches, init_params
from repro_torch.serving.engine import DecodeWorker, HostKVPool, PrefillWorker
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest

STEPS = 5      # profiled calls of each kind
TOP = 12       # kernels listed per kind


def _kernels(prof) -> list:
    """(name, device µs, count) of every device kernel, most time first."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def _wall_us(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e6 / n


def _report(name: str, fn, n: int, top: int) -> dict:
    fn()                                    # warm
    wall_us = _wall_us(fn, n)               # without the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_us = _wall_us(fn, n)
    ks = _kernels(prof)
    busy_us = sum(r[1] for r in ks) / n
    launches = sum(r[2] for r in ks) / n
    print(f"{name}: wall {wall_us / 1e3:.3f} ms ({prof_wall_us / 1e3:.3f} "
          f"under the profiler), device busy {busy_us / 1e3:.3f} ms, device "
          f"idle share {1 - busy_us / wall_us:.3f}, {launches:.0f} kernels "
          f"per call")
    for k, us, c in ks[:top]:
        print(f"  {us / n / 1e3:8.4f} ms  {c / n:6.1f}x  {k[:96]}")
    return dict(wall_us=wall_us, busy_us=busy_us, launches=launches)


def main() -> int:
    device = resolve_device("cuda")
    cfg = get_config("smollm-360m")
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    pool = HostKVPool()
    pp = DevicePagePool(cfg, n_pages=1 + 9 * (MAX_LEN // 64), page_tokens=64,
                        device=device)
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=256, page_pool=pp)
    dw = DecodeWorker(params, cfg, max_batch=8, max_len=MAX_LEN, page_pool=pp)
    payloads = make_payloads(12, cfg.vocab_size, max_new=MAX_LEN, seed=0)
    for rid, toks, _, sess in payloads[:8]:
        dw.join(ServingRequest(rid, toks, MAX_LEN - len(toks)), pw(toks))
    lens = [len(t) for _, t, _, _ in payloads[:8]]
    print(f"{cfg.name}: decode batch of {dw.n_active} slots at depths {lens}; "
          f"{torch.cuda.get_device_name(0)}")
    _report("decode step (paged, 8 slots)", dw.step, STEPS, TOP)

    toks = torch.as_tensor(np.asarray(payloads[0][1][:1536], np.int64)[None],
                           device=device)
    caches = init_caches(cfg, 1, 1536, device=device)
    caches = caches._replace(length=1280)
    _report("prefill chunk (256 tokens at offset 1280)",
            lambda: decode_step(params, toks[:, 1280:1536], caches, cfg),
            STEPS, TOP)
    return 0


if __name__ == "__main__":
    sys.exit(main())
