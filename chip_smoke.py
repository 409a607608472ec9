#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. the build of every hand-written kernel (one nvcc per source, all at
     once) and what ptxas reports for each kernel (registers, static
     shared memory, spills), with the paged kernel's dynamic shared
     memory per head_dim;
  3. the paged decode kernel against its plain PyTorch version and its
     plain split decomposition on the card at the serving path's shapes
     (smollm-360m: B=8 slots, 16 padded query heads over 5 KV heads,
     D=64, 64-token pages, 32-page tables, ragged lengths, a poisoned null
     page), a grouped D=128 case, a forced 8-split case with 1-token
     slots (clusters of mostly empty splits) and one KV head serving 16
     query heads at D=128;
  4. the chunked-prefill kernel against its plain version and its plain
     split-over-keys decomposition (256-token chunks at offsets
     0/256/1280 against a 1536-token cache, a ragged 131-token tail chunk,
     and five forced key splits at offset 0, where splits hold no key for
     some rows);
  5. end to end: the launcher's body serves the generated workload at the
     full width of smollm-360m (32 layers, random weights from seed 0)
     through the serving loop with predictive admission, and every kernel
     launch is counted; then one request is teacher-forced through the
     kernel path and through the plain versions on the card;
  6. the SSD-scan kernel against its plain version: the serving call of
     mamba2-2.7b (b=1, s=512, 80 heads, p=64, n=128, chunk 256, with an
     incoming state; there each of the four passes' outputs against its
     plain pass too), a ragged 96-token tail chunk, and the mixer shape of
     mamba2-2.7b.reduced();
  7. the batched-over-layers paged decode kernel through its op entry at
     smollm-360m's full width (32 layers of phase 3's case), against 32
     per-layer launches and the plain version;
  8. end to end at mamba2-2.7b's full width (64 layers, random weights
     from seed 0): nine requests through one StateCheckpointWorker (the
     launcher's first 8 plus one that shares the first's 1024-token
     prefix, so a checkpoint restore runs), each then decoded greedily
     with decode_step; SSD-scan launches counted; the restored request's
     first token against a cold prefill; one request teacher-forced
     through the kernel path and the plain path on the card;
  9. the storage hierarchy at smollm-360m's full width (phase 5's
     weights): the launcher with a DRAM tier of 4 blocks over a
     file-backed SSD tier of 64 serves the workload cold into a fresh
     store directory, then again on the same directory after the restart
     (prefixes come off disk through the overlapped load-vs-recompute
     path), each run's kernel launches counted from zero; one request's
     prefix is loaded off a copy of the cold run's store by a fresh
     PrefillWorker, the bytes set into the cache arena held bit for bit
     against the stored bytes and against a cold flat-pool prefill of the
     same prompt, and its teacher-forced logits against a cold prefill
     (4 bf16 ulps), again after every slot of another copy
     is corrupted (recompute replaces what is lost); last, a run on a
     fresh directory fetches blocks off the first store as a peer's
     through the global directory;
 10. the Conductor and the wire at smollm-360m's full width (phase 5's
     weights): the H100 ``Hardware``'s calibrated terms measured again
     (pinned host-to-device, a llama2-70b prefill GEMM's share of the
     bf16 peak, a device copy's share of the HBM rate); the cluster
     launcher's Conductor lane (2 prefill + 2 decode workers over one
     page pool, kvcache routing of the 24-request trace, a served request
     teacher-forced through the kernel and plain paths); its global-pool
     lane (random routing, blocking loads under a DRAM tier of 8 over SSD
     64, peer blocks fetched, the store's read time fed to the cost
     model); its 3-process lane (every node bit-exact against the
     single-process oracle, 2 peer blocks a node over the wire) and its
     chaos lane (node 0 SIGKILLed mid-fetch, survivors bit-exact, the
     degradation accounted, node 0's directory claims dropped), each
     lane's kernel launches counted from zero;
 11. the simulator on H100 prices (phase 5's weights, phase 10's
     calibration): the cost model of smollm-360m on one calibrated H100
     against a synchronised 256-token prefill chunk at offset 1280 and a
     paged decode step of 8 slots (a reading); the quickstart's sections
     1-3 at 3000 requests priced on a calibrated 8-GPU node, and its
     section 4 (chunked prefill with prefix reuse) at full width with
     flash_prefill launches counted from zero and the KV held against
     the plain path; the overload replay of 4000 requests at 4 to 128x
     under each admission policy, its invariants gated; the
     Figure-12 scenario, Mooncake 2P+2D against the coupled baseline x4.
Then one JSON line of per-kernel numbers, the nvidia-smi line, and the
result line. Times are CUDA-event times with the L2 cache flushed before
every launch; bounds use the H100 SXM peaks (3.35 TB/s, 989 TFLOP/s bf16).
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
BF16_FLOP_S = 989e12        # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2                  # kernel vs plain, bf16 (tests/test_kernels.py)
# SSD scan, kernel vs plain: both compute in fp32 and differ only in the
# order of their sums, so the reference's fp32 scan tolerance (5e-3,
# tests/test_kernels.py:155), taken relative to the output's scale
SSD_TOL = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"\n=== {name} ===")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean CUDA-event time of one call, L2 flushed before each call.

    The GPU is first parked on a spin long enough for the host to queue
    every timed call, so the events measure device time and not the
    Python wrapper's host time between them. The spin is sized from the
    host time of queueing one call (a plain version issues tens of
    launches), with a floor of ~25 ms."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        queue_s = time.monotonic() - t0
        torch.cuda.synchronize()
        # ~2e9 spin cycles a second at H100 clocks; 1.5x the queueing time
        torch.cuda._sleep(int(max(50_000_000, 3e9 * queue_s * iters)))
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def ptxas_by_kernel(report: str) -> list:
    """(kernel, "spills; registers and static shared memory") for each
    entry function in an ``-Xptxas -v`` report, names demangled to
    ``name<template int>``."""
    rows, fn, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn, spill = short_name(m.group(1)), ""
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "Used" in line and "registers" in line:
            rows.append((fn, f"{spill}; {line.split(':', 1)[1].strip()}"))
            fn = None
    return rows


def short_name(mangled: str) -> str:
    """``_ZN12_GLOBAL__N_119paged_decode_kernelILi64EEEv...`` ->
    ``paged_decode_kernel<64>`` (the innermost name and a leading int
    template argument)."""
    rest = re.sub(r"^_ZN?", "", mangled)
    name = mangled
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    t = re.match(r"ILi(\d+)E", rest)
    return f"{name}<{t.group(1)}>" if t else name


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_S, n_flops / BF16_FLOP_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 3: paged decode
# ---------------------------------------------------------------------------

def paged_case(torch, *, B, H, KV, D, page, max_pages, P, lens, qh2kv, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
    kp = torch.randn(P, page, KV, D, generator=g, device=dev).bfloat16()
    vp = torch.randn(P, page, KV, D, generator=g, device=dev).bfloat16()
    kp[0] = 1e4                       # poison the null page
    vp[0] = -1e4
    return (q, kp, vp) + paged_table(torch, lens=lens, page=page,
                                     max_pages=max_pages, P=P, qh2kv=qh2kv,
                                     seed=seed)


def paged_table(torch, *, lens, page, max_pages, P, qh2kv, seed):
    """Block table of distinct random pages (never the null page 0) for
    ragged lengths; (table, lengths, head map or None) on the card."""
    dev = "cuda"
    table = torch.zeros(len(lens), max_pages, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(seed))
    nxt = 0
    for b, n in enumerate(lens):
        live = -(-n // page)
        table[b, :live] = perm[nxt:nxt + live] + 1
        nxt += live
    table = table.to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    m = None if qh2kv is None else torch.tensor(qh2kv, dtype=torch.int32,
                                                device=dev)
    return table, lens_t, m


def check_paged(torch, timer, name, case, main: bool, n_splits=None):
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ops import grouped_map
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_attention_splits_ref)
    q, kp, vp, table, lens, m = case
    B, H, D = q.shape
    KV = kp.shape[2]
    mk = m if m is not None else grouped_map(H, KV, q.device)
    out = paged_attention(q, kp, vp, table, lens, mk, n_splits=n_splits)
    torch.cuda.synchronize()
    splits = paged_attention.last_splits
    ref = paged_attention_ref(q, kp, vp, table, lens, qh2kv=m)
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    # the plain split decomposition with the kernel's split count
    split_ref = paged_attention_splits_ref(q, kp, vp, table, lens, qh2kv=m,
                                           n_splits=splits)
    err_split = (out.float() - split_ref.float()).abs().max().item()
    log(f"paged[{name}]: B={B} H={H} KV={KV} D={D} lens={lens.tolist()} "
        f"n_splits={splits} max_abs_err={err:.3e} (vs the plain split "
        f"decomposition {err_split:.3e}; tol {TOL}) finite={finite}")
    if not (err <= TOL and err_split <= TOL and finite):
        raise AssertionError(f"paged decode kernel disagrees ({name})")
    if n_splits is not None and splits != n_splits:
        raise AssertionError(f"paged ran {splits} splits, not {n_splits}")
    if not main:
        return None
    ms = timer.ms(lambda: paged_attention(q, kp, vp, table, lens, mk))
    sweep = {ns: timer.ms(lambda: paged_attention(q, kp, vp, table, lens, mk,
                                                  n_splits=ns))
             for ns in (1, 2, 4, 8)}
    log(f"paged[{name}]: forced splits " + ", ".join(
        f"{ns}: {t:.4f} ms" for ns, t in sweep.items())
        + f" (the chooser took {splits})")
    # the fixed cost: the same call with no live token in any slot, and
    # one trivial kernel launch under the same timer
    no_tok = torch.zeros_like(lens)
    empty_ms = timer.ms(lambda: paged_attention(q, kp, vp, table, no_tok, mk))
    one = torch.zeros(1, device=q.device)
    launch_ms = timer.ms(lambda: one.fill_(1.0))
    log(f"paged[{name}]: fixed cost: {empty_ms:.4f} ms with no live token, "
        f"{launch_ms:.4f} ms for one trivial kernel launch")
    plain_ms = timer.ms(lambda: paged_attention_ref(q, kp, vp, table, lens,
                                                    qh2kv=m))
    # library yardstick: SDPA on pre-gathered, head-expanded KV (the
    # gather is excluded from its time)
    S = table.shape[1] * kp.shape[1]
    kx = kp[table.long()].reshape(B, S, KV, D)[:, :, mk.long()]
    vx = vp[table.long()].reshape(B, S, KV, D)[:, :, mk.long()]
    kx, vx = kx.transpose(1, 2).contiguous(), vx.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None].long())
    mask = mask[:, None, None, :]
    qx = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer.ms(lambda: sdpa(qx, kx, vx, attn_mask=mask))
    toks = int(lens.sum())
    n_bytes = (q.numel() + out.numel()) * 2 + toks * KV * D * 2 * 2 \
        + (table.numel() + lens.numel() + mk.numel()) * 4
    n_flops = 4.0 * D * H * toks
    b_ms, b_by = bound(n_bytes, n_flops)
    log(f"paged[{name}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (SDPA, gather excluded) {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
        f"{n_flops / 1e9:.3f} GFLOP)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase 4: chunked prefill
# ---------------------------------------------------------------------------

def check_prefill(torch, timer, name, *, Sq, Sk, q_offset, H, KV, D, qh2kv,
                  seed, main: bool, n_splits=None):
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import (flash_prefill_ref,
                                                       flash_prefill_split_ref)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, Sq, H, D, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, Sk, KV, D, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, Sk, KV, D, generator=g, device="cuda").bfloat16()
    k[:, q_offset + Sq:] = 1e4        # keys past the chunk: never read
    v[:, q_offset + Sq:] = -1e4
    m = torch.tensor(qh2kv, dtype=torch.int32, device="cuda")
    out = flash_prefill(q, k, v, m, q_offset=q_offset, n_splits=n_splits)
    torch.cuda.synchronize()
    splits = flash_prefill.last_splits
    ref = flash_prefill_ref(q, k, v, q_offset=q_offset, qh2kv=m)
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    # the plain split-over-keys decomposition with the kernel's split count
    split_ref = flash_prefill_split_ref(q, k, v, q_offset=q_offset, qh2kv=m,
                                        n_splits=splits)
    err_split = (out.float() - split_ref.float()).abs().max().item()
    log(f"prefill[{name}]: Sq={Sq} Sk={Sk} q_offset={q_offset} H={H} KV={KV} "
        f"D={D} n_splits={splits} max_abs_err={err:.3e} (vs the plain split "
        f"decomposition {err_split:.3e}; tol {TOL}) finite={finite}")
    if not (err <= TOL and err_split <= TOL and finite):
        raise AssertionError(f"prefill kernel disagrees ({name})")
    if n_splits is not None and splits != n_splits:
        raise AssertionError(f"prefill ran {splits} splits, not {n_splits}")
    if not main:
        return None
    ms = timer.ms(lambda: flash_prefill(q, k, v, m, q_offset=q_offset))
    plain_ms = timer.ms(lambda: flash_prefill_ref(q, k, v, q_offset=q_offset,
                                                  qh2kv=m))
    ml = m.long()
    qx = q.transpose(1, 2).contiguous()
    kx = k[:, :, ml].transpose(1, 2).contiguous()
    vx = v[:, :, ml].transpose(1, 2).contiguous()
    qpos = q_offset + torch.arange(Sq, device="cuda")
    mask = (qpos[:, None] >= torch.arange(Sk, device="cuda")[None, :])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer.ms(lambda: sdpa(qx, kx, vx, attn_mask=mask))
    keys = min(Sk, q_offset + Sq)
    pairs = sum(min(Sk, q_offset + i + 1) for i in range(Sq))
    n_bytes = (q.numel() + out.numel()) * 2 + keys * KV * D * 2 * 2 \
        + m.numel() * 4
    n_flops = 4.0 * D * H * pairs
    b_ms, b_by = bound(n_bytes, n_flops)
    log(f"prefill[{name}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (SDPA, head expansion excluded) {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
        f"{n_flops / 1e9:.3f} GFLOP)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase 5: end to end
# ---------------------------------------------------------------------------

def teacher_forced(torch, params, cfg, prompt, stream, chunk=256, page=64,
                   kv=None):
    """Logits of every position a served stream was sampled from: the
    first token's (chunked prefill) and each decode step's (paged). With
    ``kv`` — host (k, v) of the prompt from another path, such as a
    tiered prefill — the prompt's KV but its last token's comes from
    there, and the first token's logits from a one-token extend."""
    from repro_torch.models.transformer import (decode_step,
                                                decode_step_paged,
                                                init_caches)
    from repro_torch.serving.engine import stage_run
    from repro_torch.serving.paged_cache import DevicePagePool
    dev = params["embed"].device
    S = len(prompt)
    t = torch.as_tensor(prompt[None, :].astype("int64"), device=dev)
    caches = init_caches(cfg, 1, S, device=dev)
    if kv is None:
        for lo in range(0, S, chunk):
            logits, caches = decode_step(params, t[:, lo:lo + chunk], caches,
                                         cfg)
    else:
        caches.kv.k[:, 0, :S - 1] = kv[0][:, :S - 1].to(dev)
        caches.kv.v[:, 0, :S - 1] = kv[1][:, :S - 1].to(dev)
        logits, caches = decode_step(params, t[:, S - 1:],
                                     caches._replace(length=S - 1), cfg)
    rows = [logits[0, -1]]
    n_tok = S + len(stream)
    pp = DevicePagePool(cfg, n_pages=2 + -(-n_tok // page), page_tokens=page,
                        device=dev)
    pages = stage_run(pp, [], caches.kv.k[:, 0], caches.kv.v[:, 0], S)
    pages += pp.alloc(pp.pages_for(n_tok) - len(pages))
    table = torch.tensor([pages], dtype=torch.int32, device=dev)
    for i, tok in enumerate(stream[:-1]):
        lens = torch.tensor([S + i], dtype=torch.int32, device=dev)
        tk = torch.tensor([[tok]], dtype=torch.int64, device=dev)
        logits, _, _ = decode_step_paged(params, tk, pp.k_pages, pp.v_pages,
                                         table, lens, cfg)
        rows.append(logits[0, -1])
    return torch.stack(rows)


def e2e_smollm(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.transformer import init_params
    cfg = get_config("smollm-360m")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"smollm-360m full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}->{cfg.padded_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads, head_dim {cfg.head_dim}; params built "
        f"in {time.monotonic() - t0:.1f} s")
    # a 12-request window of the generated workload holds 8 requests
    paged_attention.launches = 0
    flash_prefill.launches = 0
    s = serve(cfg, "cuda", params=params, requests=12, max_batch=8,
              max_new=16, admission="predictive", seed=0, log=log)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "flash_prefill": flash_prefill.launches}
    log(f"e2e: {s['completed']}/{s['submitted']} requests completed, "
        f"{s['new_tokens']} tokens in {s['seconds']:.3f} s, decode "
        f"{s['decode_tok_s']:.2f} tok/s, TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} "
        f"ms, TBT p50 {s['tbt_p50_s'] * 1e3:.2f} ms p99 "
        f"{s['tbt_p99_s'] * 1e3:.2f} ms")
    log(f"e2e launches: paged_attention {launches['paged_attention']} "
        f"(= {cfg.n_layers} x {s['paged_calls']} paged step calls), "
        f"flash_prefill {launches['flash_prefill']} (= {cfg.n_layers} x "
        f"{s['prefill_chunks']} prefill chunks)")
    if s["submitted"] != 8 or s["completed"] != s["submitted"]:
        raise AssertionError("not every request completed")
    if launches["paged_attention"] != cfg.n_layers * s["paged_calls"] \
            or launches["flash_prefill"] != cfg.n_layers * s["prefill_chunks"]:
        raise AssertionError("kernel launches do not match layers x steps")
    if not (launches["paged_attention"] and launches["flash_prefill"]):
        raise AssertionError("a kernel of the path never launched")
    for rid, toks, mn, _ in s["payloads"]:
        out = s["outputs"][rid]
        if len(out) != mn or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"request {rid}: bad stream {out}")

    rid, prompt, _, _ = s["payloads"][0]
    stream = s["outputs"][rid]
    lk = teacher_forced(torch, params, cfg, prompt, stream)
    with plain_attention():
        lp = teacher_forced(torch, params, cfg, prompt, stream)
    torch.cuda.synchronize()
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    # logits are bf16 products at the end of a 32-layer bf16 stack; the
    # kernels keep fp32 probabilities where the plain path rounds them to
    # bf16, so allow 4 bf16 ulps of the largest logit
    tol = 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    served = (lk.argmax(-1).cpu().tolist() == stream)
    finite = bool(torch.isfinite(lk).all())
    log(f"teacher forcing (request {rid}, prompt {len(prompt)}, "
        f"{len(stream)} positions): kernel vs plain logits max_abs_err "
        f"{err:.4f} (max |logit| {scale:.3f}; tol {tol:.4f} = 4 bf16 ulps), "
        f"greedy agreement {agree:.4f}, kernel argmax == served stream: "
        f"{served}")
    if not finite or err > tol:
        raise AssertionError("kernel path and plain path disagree")
    return launches, params


def bf16_ulps(n: int, scale: float) -> float:
    """``n`` bf16 ulps (8 significand bits) of a value of size ``scale``."""
    return n * 2.0 ** (math.floor(math.log2(scale)) - 7)


# ---------------------------------------------------------------------------
# phase 6: SSD scan
# ---------------------------------------------------------------------------

def ssd_case(torch, *, b, s, h, p, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    x = torch.randn(b, s, h, p, generator=g, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=g, device=dev))
    A = -torch.exp(0.5 * torch.randn(h, generator=g, device=dev))
    B = torch.randn(b, s, n, generator=g, device=dev).bfloat16()
    C = torch.randn(b, s, n, generator=g, device=dev).bfloat16()
    h0 = torch.randn(b, h, p, n, generator=g, device=dev)
    return x, dt, A, B, C, h0


def check_ssd(torch, timer, name, *, b, s, h, p, n, chunk, seed, main):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import (chunk_cb, chunk_state,
                                                  ssd_chunked, state_pass)
    x, dt, A, B, C, h0 = ssd_case(torch, b=b, s=s, h=h, p=p, n=n, seed=seed)
    y, hT, got = ssd_scan(x, dt, A, B, C, h0, chunk=chunk, passes=True)
    torch.cuda.synchronize()
    y_r, h_r = ssd_chunked(x, dt, A, B, C, chunk, h0=h0)
    pairs = [("y", y, y_r), ("hT", hT, h_r)]
    if main:
        # each pass's output against its plain pass on the same inputs, so
        # that a fault shows in the pass that made it
        cb = chunk_cb(B, C, chunk)
        tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                    device="cuda"))
        cum, states = chunk_state(x, dt, A, B, chunk)
        h_in, _ = state_pass(states, cum, h0)
        pairs = [("cb (lower triangle)", got["cb"] * tri, cb * tri),
                 ("cum", got["cum"], cum), ("states", got["states"], states),
                 ("h_in", got["h_in"], h_in)] + pairs
    errs = []
    for what, o, r in pairs:
        err = (o - r).abs().max().item()
        tol = SSD_TOL * max(1.0, r.abs().max().item())
        finite = bool(torch.isfinite(o).all())
        log(f"ssd[{name}]: b={b} s={s} h={h} p={p} n={n} chunk={chunk} "
            f"{what} max_abs_err={err:.3e} (tol {tol:.3e} = {SSD_TOL} x "
            f"max(1, max|ref|)) finite={finite}")
        if not (err <= tol and finite):
            raise AssertionError(f"SSD scan kernel disagrees ({name}, {what})")
        errs.append(err)
    if not main:
        return None
    ms = timer.ms(lambda: ssd_scan(x, dt, A, B, C, h0, chunk=chunk))
    plain_ms = timer.ms(lambda: ssd_chunked(x, dt, A, B, C, chunk, h0=h0))
    # bytes: every input read once, y and hT written once (fp32)
    n_bytes = x.numel() * 2 + dt.numel() * 4 + A.numel() * 4 \
        + (B.numel() + C.numel()) * 2 + h0.numel() * 4 \
        + y.numel() * 4 + hT.numel() * 4
    # operations the function needs: C·Bᵀ once per chunk (B, C are shared
    # by every head; causal half), and per head the masked product with
    # x·dt (causal half), the incoming-state term and the state update
    c = s // chunk
    tri = chunk * (chunk + 1) / 2
    n_flops = b * c * (2.0 * tri * n + h * (2.0 * tri * p
                                            + 2 * 2.0 * chunk * n * p))
    b_ms, b_by = bound(n_bytes, n_flops)
    log(f"ssd[{name}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"none (no single PyTorch call computes the scan), bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
        f"{n_flops / 1e9:.3f} GFLOP)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# phase 7: paged decode, all layers in one launch
# ---------------------------------------------------------------------------

def check_paged_layers(torch, timer, *, L, B, H, KV, D, page, max_pages, P,
                       lens, qh2kv, seed):
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention, paged_attention_layers)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention_layers)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_layers_ref)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    qs = torch.randn(L, B, H, D, generator=g, device=dev).bfloat16()
    kp = torch.randn(L, P, page, KV, D, generator=g, device=dev).bfloat16()
    vp = torch.randn(L, P, page, KV, D, generator=g, device=dev).bfloat16()
    kp[:, 0] = 1e4                       # poison every layer's null page
    vp[:, 0] = -1e4
    table, lens_t, m = paged_table(torch, lens=lens, page=page,
                                   max_pages=max_pages, P=P, qh2kv=qh2kv,
                                   seed=seed)
    # this phase's path: the op entry, counted from zero
    paged_attention_layers.launches = 0
    out = paged_decode_attention_layers(qs, kp, vp, table, lens_t, qh2kv=m)
    torch.cuda.synchronize()
    launches = paged_attention_layers.launches
    per_layer = torch.stack([paged_attention(qs[l], kp[l], vp[l], table,
                                             lens_t, m) for l in range(L)])
    ref = paged_attention_layers_ref(qs, kp, vp, table, lens_t, qh2kv=m)
    torch.cuda.synchronize()
    exact = torch.equal(out, per_layer)
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    log(f"paged_layers: L={L} B={B} H={H} KV={KV} D={D} lens={lens} "
        f"launches={launches}; == {L} per-layer launches: {exact}; vs plain "
        f"max_abs_err={err:.3e} (tol {TOL}) finite={finite}")
    if launches != 1 or not exact or not (err <= TOL and finite):
        raise AssertionError("paged layers kernel disagrees")
    ms = timer.ms(lambda: paged_attention_layers(qs, kp, vp, table, lens_t, m))
    chosen = paged_attention_layers.last_splits
    sweep = {ns: timer.ms(lambda: paged_attention_layers(
        qs, kp, vp, table, lens_t, m, n_splits=ns)) for ns in (1, 2, 4, 8)}
    log("paged_layers: forced splits " + ", ".join(
        f"{ns}: {t:.4f} ms" for ns, t in sweep.items())
        + f" (the chooser took {chosen})")
    per_ms = timer.ms(lambda: [paged_attention(qs[l], kp[l], vp[l], table,
                                               lens_t, m) for l in range(L)])
    plain_ms = timer.ms(lambda: paged_attention_layers_ref(
        qs, kp, vp, table, lens_t, qh2kv=m), iters=5, warmup=1)
    # library yardstick: SDPA with the layers folded into the batch, on
    # pre-gathered, head-expanded KV (the gather is excluded)
    S = table.shape[1] * page
    ml, tl = m.long(), table.long()
    kx = kp[:, tl].reshape(L * B, S, KV, D)[:, :, ml].transpose(1, 2)
    vx = vp[:, tl].reshape(L * B, S, KV, D)[:, :, ml].transpose(1, 2)
    kx, vx = kx.contiguous(), vx.contiguous()
    mask = torch.arange(S, device=dev)[None, :] < lens_t[:, None].long()
    mask = mask.repeat(L, 1)[:, None, None, :]
    qx = qs.reshape(L * B, H, 1, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer.ms(lambda: sdpa(qx, kx, vx, attn_mask=mask))
    del kx, vx
    toks = int(lens_t.sum())
    n_bytes = L * ((qs[0].numel() + out[0].numel()) * 2
                   + toks * KV * D * 2 * 2) \
        + (table.numel() + lens_t.numel() + m.numel()) * 4
    n_flops = 4.0 * D * H * toks * L
    b_ms, b_by = bound(n_bytes, n_flops)
    log(f"paged_layers: one launch {ms:.4f} ms, {L} per-layer launches "
        f"{per_ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA, layers "
        f"folded into the batch, gather excluded) {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
        f"{n_flops / 1e9:.3f} GFLOP)")
    return launches, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase 8: end to end, mamba2-2.7b
# ---------------------------------------------------------------------------

def mamba_teacher_forced(torch, params, cfg, prompt, stream, block=512):
    """Logits of every position a served stream was sampled from: the
    prompt prefilled in the worker's 512-token blocks, then one
    ``decode_step`` per stream token."""
    from repro_torch.models.transformer import decode_step, prefill
    t = torch.as_tensor(prompt[None, :].astype("int64"), device="cuda")
    lg, caches = prefill(params, t[:, :block], cfg)
    for lo in range(block, len(prompt), block):
        lg, caches = decode_step(params, t[:, lo:lo + block], caches, cfg)
        lg = lg[:, -1]
    rows = [lg[0]]
    for tok in stream[:-1]:
        tk = torch.tensor([[tok]], dtype=torch.int64, device="cuda")
        lg, caches = decode_step(params, tk, caches, cfg)
        rows.append(lg[0, -1])
    return torch.stack(rows)


def e2e_mamba(torch):
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.core.cache import ssm_state_bytes
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.launch.serve import make_payloads
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)
    from repro_torch.serving.engine import StateCheckpointWorker
    cfg = get_config("mamba2-2.7b")
    s = cfg.ssm
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in [params["embed"], params["final_ln"]]
                + list(params["mamba"].values()))
    log(f"mamba2-2.7b full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {s.n_heads(cfg.d_model)} SSM heads of {s.head_dim}, "
        f"d_state {s.d_state}, d_inner {s.d_inner(cfg.d_model)}, chunk "
        f"{s.chunk}, vocab {cfg.vocab_size}; {n_par / 1e9:.3f} B params "
        f"built on the card in {time.monotonic() - t0:.1f} s; one checkpoint "
        f"{ssm_state_bytes(cfg) / 1e6:.1f} MB")

    payloads = make_payloads(12, cfg.vocab_size, max_new=16, seed=0)[:8]
    first = payloads[0][1]
    if len(first) < 1024:
        raise AssertionError("the first request is shorter than 1024 tokens")
    suffix = np.random.default_rng(0).integers(0, cfg.vocab_size, 64)
    shared = np.concatenate([first[:1024], suffix]).astype(first.dtype)
    # 15 distinct checkpoints among the 8 requests evict the first
    # request's from an 8-checkpoint store before the last request, so the
    # sharing request is submitted right after the first
    reqs = [(payloads[0][0], payloads[0][1])] + [(100, shared)] \
        + [(rid, toks) for rid, toks, _, _ in payloads[1:]]
    max_new = 16

    worker = StateCheckpointWorker(params, cfg, capacity_checkpoints=8)
    ssd_scan.launches = 0
    outputs, ttft, tpot, restored = {}, {}, [], {}
    for rid, toks in reqs:
        before = worker.counters["restored_tokens"]
        t_submit = time.monotonic()
        tok, caches = worker(toks)          # argmax syncs the device
        ttft[rid] = time.monotonic() - t_submit
        restored[rid] = worker.counters["restored_tokens"] - before
        stream = [tok]
        while len(stream) < max_new:
            t1 = time.monotonic()
            lg, caches = decode_step(
                params, torch.tensor([[stream[-1]]], device="cuda"), caches,
                cfg)
            stream.append(int(torch.argmax(lg[0, -1])))
            tpot.append(time.monotonic() - t1)
        outputs[rid] = stream
    torch.cuda.synchronize()
    launches = ssd_scan.launches
    st = worker.stats()
    log("e2e mamba: TTFT per request (ms): " + ", ".join(
        f"{rid}:{len(t)}tok/{ttft[rid] * 1e3:.1f}" for rid, t in reqs))
    log(f"e2e mamba: decode {np.mean(tpot) * 1e3:.2f} ms/token mean, "
        f"{np.percentile(tpot, 50) * 1e3:.2f} p50, "
        f"{np.percentile(tpot, 99) * 1e3:.2f} p99 over {len(tpot)} steps; "
        f"restored_tokens {st['restored_tokens']} computed_tokens "
        f"{st['computed_tokens']}, {st['checkpoints']} checkpoints held, "
        f"{worker.meta.evictions} evicted; restored per request "
        f"{restored}")
    log(f"e2e mamba launches: ssd_scan {launches} (= {cfg.n_layers} x "
        f"{worker.scan_calls} worker calls that reach the scan)")
    if launches != cfg.n_layers * worker.scan_calls or not launches:
        raise AssertionError("ssd_scan launches do not match layers x calls")
    if st["restored_tokens"] < 1024 or restored[100] < 1024:
        raise AssertionError("no checkpoint restore of >= 1024 tokens ran")
    for rid, out in outputs.items():
        if len(out) != max_new or not all(0 <= t < cfg.vocab_size
                                          for t in out):
            raise AssertionError(f"request {rid}: bad stream {out}")

    # the restored request's first token against a cold prefill
    t = torch.as_tensor(shared[None].astype("int64"), device="cuda")
    cold, _ = prefill(params, t, cfg)
    top2 = torch.topk(cold[0], 2).values
    log(f"restore vs cold: first token {outputs[100][0]} (restored "
        f"{restored[100]} tokens) vs cold prefill {int(cold[0].argmax())}; "
        f"cold top-2 gap {(top2[0] - top2[1]).item():.4f}")
    if outputs[100][0] != int(cold[0].argmax()):
        raise AssertionError("restored first token differs from cold prefill")

    rid, prompt = reqs[0]
    stream = outputs[rid]
    lk = mamba_teacher_forced(torch, params, cfg, prompt, stream)
    with plain_attention():
        lp = mamba_teacher_forced(torch, params, cfg, prompt, stream)
    torch.cuda.synchronize()
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    tol = 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(lk).all())
    log(f"teacher forcing (request {rid}, prompt {len(prompt)}, "
        f"{len(stream)} positions, logits {tuple(lk.shape)}): kernel vs plain "
        f"max_abs_err {err:.4f} (max |logit| {scale:.3f}; tol {tol:.4f} = 4 "
        f"bf16 ulps), greedy agreement {agree:.4f}, kernel argmax == served "
        f"stream: {lk.argmax(-1).cpu().tolist() == stream}")
    if not finite or err > tol or lk.shape != (max_new, cfg.padded_vocab):
        raise AssertionError("SSM kernel path and plain path disagree")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the storage hierarchy, end to end
# ---------------------------------------------------------------------------

def corrupt_every_slot(d: str) -> int:
    """Overwrite four payload bytes of every slot of the store in ``d``
    (as ``tests/test_ssd_store.py`` corrupts a store); returns the slots."""
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    slot, hdr = meta["slot_size"], 16 + 4 * meta["shape"][0]
    path = os.path.join(d, "kvblocks.dat")
    n = os.path.getsize(path) // slot
    with open(path, "r+b") as f:
        for i in range(n):
            f.seek(i * slot + hdr + 11)
            f.write(b"\xde\xad\xbe\xef")
    return n


def tiered_serve(torch, cfg, name, **kw):
    """One launcher run with its kernel launches counted from zero and
    held to layers × paged calls and layers × prefill chunks."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.launch.serve import serve
    paged_attention.launches = 0
    flash_prefill.launches = 0
    s = serve(cfg, "cuda", requests=12, max_batch=8, max_new=16,
              pool_blocks=4, ssd_blocks=64, ssd_mode="overlap", seed=0,
              log=log, **kw)
    torch.cuda.synchronize()
    pa, fp = paged_attention.launches, flash_prefill.launches
    st = s.get("store", {})
    log(f"{name}: {s['completed']}/{s['submitted']} requests, TTFT p50 "
        f"{s['ttft_p50_s'] * 1e3:.2f} ms, TBT p50 {s['tbt_p50_s'] * 1e3:.2f} "
        f"ms p99 {s['tbt_p99_s'] * 1e3:.2f} ms, decode "
        f"{s['decode_tok_s']:.2f} tok/s over {s['seconds']:.3f} s; reused "
        f"{s['reused_blocks']} blocks, {s['ssd_loaded_blocks']} loaded, "
        f"{s['overlapped_requests']} overlapped prefills, "
        f"{s['fallback_blocks']} fell back, {s['peer_blocks_fetched']} "
        f"peer blocks ({s['peer_fetch_failures']} failures); store "
        f"{st.get('bytes_written', 0)} B written, {st.get('bytes_read', 0)} "
        f"B read, {st.get('read_failures', 0)} read failures, "
        f"{st.get('blocks', 0)} blocks on disk, {st.get('n_flushes', 0)} "
        f"write-back flushes taking {st.get('flush_s', 0.0) * 1e3:.1f} ms")
    log(f"{name} launches: paged_attention {pa} (= {cfg.n_layers} x "
        f"{s['paged_calls']} paged step calls), flash_prefill {fp} (= "
        f"{cfg.n_layers} x {s['prefill_chunks']} prefill chunks)")
    for i, plan in enumerate(s["overlap_plans"]):
        log(f"  {name} overlap plan {i}: {json.dumps(plan)}")
    if s["submitted"] != 8 or s["completed"] != s["submitted"]:
        raise AssertionError(f"{name}: not every request completed")
    if pa != cfg.n_layers * s["paged_calls"] \
            or fp != cfg.n_layers * s["prefill_chunks"] or not (pa and fp):
        raise AssertionError(f"{name}: launches do not match layers x steps")
    for rid, _, mn, _ in s["payloads"]:
        out = s["outputs"][rid]
        if len(out) != mn or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"{name}: request {rid}: bad stream {out}")
    return s


def tiered_prefill(torch, params, cfg, d, prompt):
    """A fresh overlapped PrefillWorker over a pool that recovers the
    store in ``d``; returns (result, its overlap plan, the pool's stats,
    the worker's counters)."""
    from repro_torch.serving.engine import HostKVPool, PrefillWorker
    pool = HostKVPool(capacity_blocks=4, ssd_capacity_blocks=64, ssd_dir=d)
    try:
        pw = PrefillWorker(params, cfg, pool, prefill_chunk=256,
                           ssd_mode="overlap")
        pres = pw(prompt)
        torch.cuda.synchronize()
        plan = pw.overlap_plans[-1] if pw.overlap_plans else None
        return pres, plan, pool.stats(), dict(pw.counters)
    finally:
        pool.close()


def e2e_tiers(torch, params):
    import shutil
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.core.cache import kv_block_bytes
    from repro_torch.serving.engine import (HostKVPool, PrefillWorker,
                                            prefix_hash_ids)
    from repro_torch.serving.ssd_store import SSDBlockStore
    cfg = get_config("smollm-360m")
    block_bytes = kv_block_bytes(cfg)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="tiers-", dir=os.path.join(ROOT, "build"))
    try:
        d1, d2 = os.path.join(root, "d1"), os.path.join(root, "d2")
        d1_cold = os.path.join(root, "d1-after-cold")
        log(f"smollm-360m full width, DRAM tier 4 blocks over an SSD tier of "
            f"64 (one block {block_bytes} B), stores in {root}")
        cold = tiered_serve(torch, cfg, "cold run", params=params, ssd_dir=d1)
        shutil.copytree(d1, d1_cold)    # the bytes the cold run stored
        warm = tiered_serve(torch, cfg, "restart run", params=params,
                            ssd_dir=d1)
        if not (warm["ssd_loaded_blocks"] > 0
                and warm["overlapped_requests"] > 0
                and warm["store"]["read_failures"] == 0):
            raise AssertionError("the restart run did not serve prefixes "
                                 "off disk through the overlapped path")

        # worker level: one request whose prefix sits on the cold run's disk
        check = os.path.join(root, "check")
        shutil.copytree(d1_cold, check)
        probe = SSDBlockStore(check)
        try:
            keys = set(probe.keys())
            rid, prompt = max(
                ((r, p) for r, p, _, _ in cold["payloads"]),
                key=lambda rp: sum(h in keys for h in prefix_hash_ids(rp[1])))
            ids = prefix_hash_ids(prompt)
            stored = {h: probe.read_block(h) for h in ids if h in keys}
            read_s = probe.read_s_ema
        finally:
            probe.close()
        log(f"worker check: request {rid}, prompt {len(prompt)}, "
            f"{len(stored)} of its {len(ids)} blocks on the cold run's disk; "
            f"measured blocking read {read_s * 1e3:.3f} ms a block "
            f"({block_bytes / read_s / 1e9:.2f} GB/s)")
        pres, plan, pst, pc = tiered_prefill(torch, params, cfg, check,
                                             prompt)
        log(f"worker check plan: {json.dumps(plan)}; {pres.ssd_blocks} "
            f"blocks loaded, {pres.reused_blocks} reused")
        if plan is None or pres.ssd_blocks == 0:
            raise AssertionError("the worker check loaded nothing off disk")
        for i in range(plan["split"], plan["split"] + plan["loaded_tail"]):
            sl = slice(i * 512, (i + 1) * 512)
            k, v = stored[ids[i]]
            if not (torch.equal(pres.kv_k[:, sl].view(torch.int16),
                                k.view(torch.int16))
                    and torch.equal(pres.kv_v[:, sl].view(torch.int16),
                                    v.view(torch.int16))):
                raise AssertionError(f"block {i}: the bytes set into the "
                                     f"arena differ from the stored bytes")
        # ... and equal to what a cold prefill computes for those blocks
        flat = HostKVPool()
        try:
            cres = PrefillWorker(params, cfg, flat, prefill_chunk=256)(prompt)
            torch.cuda.synchronize()
        finally:
            flat.close()
        for i in range(plan["split"], plan["split"] + plan["loaded_tail"]):
            sl = slice(i * 512, (i + 1) * 512)
            if not (torch.equal(pres.kv_k[:, sl].view(torch.int16),
                                cres.kv_k[:, sl].view(torch.int16))
                    and torch.equal(pres.kv_v[:, sl].view(torch.int16),
                                    cres.kv_v[:, sl].view(torch.int16))):
                raise AssertionError(f"block {i}: the bytes set into the "
                                     f"arena differ from a cold prefill's")
        log(f"worker check: blocks {plan['split']}..."
            f"{plan['split'] + plan['loaded_tail'] - 1} set into the arena "
            f"bit-equal to the cold run's stored bytes and to a cold "
            f"flat-pool prefill of the same prompt")
        stream = cold["outputs"][rid]
        lc = teacher_forced(torch, params, cfg, prompt, stream)
        lt = teacher_forced(torch, params, cfg, prompt, stream,
                            kv=(pres.kv_k, pres.kv_v))

        bad = os.path.join(root, "corrupt")
        shutil.copytree(d1_cold, bad)
        n_bad = corrupt_every_slot(bad)
        bres, bplan, bst, bc = tiered_prefill(torch, params, cfg, bad, prompt)
        lb = teacher_forced(torch, params, cfg, prompt, stream,
                            kv=(bres.kv_k, bres.kv_v))
        torch.cuda.synchronize()
        log(f"corruption: {n_bad} slots corrupted; plan {json.dumps(bplan)}; "
            f"{bst['store_read_failures']} read failures, "
            f"{bc['fallback_blocks']} blocks fell back to recompute")
        if not (bst["store_read_failures"] > 0 or bc["fallback_blocks"] > 0):
            raise AssertionError("the corrupted store was not noticed")
        scale = lc.abs().max().item()
        tol = bf16_ulps(4, scale)
        for name, lx in (("tiered", lt), ("after corruption", lb)):
            err = (lx - lc).abs().max().item()
            agree = (lx.argmax(-1) == lc.argmax(-1)).float().mean().item()
            log(f"teacher forcing ({name} vs cold prefill, request {rid}, "
                f"{len(stream)} positions): max_abs_err {err:.4f} (max "
                f"|logit| {scale:.3f}; tol {tol:.4f} = 4 bf16 ulps), greedy "
                f"agreement {agree:.4f}")
            if not bool(torch.isfinite(lx).all()) or err > tol:
                raise AssertionError(f"{name} logits disagree with a cold "
                                     f"prefill")

        peer = tiered_serve(torch, cfg, "global pool run", params=params,
                            ssd_dir=d2, peer_ssd_dir=d1)
        if peer["peer_blocks_fetched"] == 0 or peer["peer_fetch_failures"]:
            raise AssertionError("the global pool run fetched no peer block "
                                 "or a fetch failed")
        if peer["peer_blocks"] != peer["peer_blocks_fetched"]:
            raise AssertionError(
                f"the workers counted {peer['peer_blocks']} peer blocks, the "
                f"pool fetched {peer['peer_blocks_fetched']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the Conductor and the wire
# ---------------------------------------------------------------------------

def calibrate(torch, timer) -> dict:
    """The H100 ``Hardware``'s calibrated terms, measured here: host-to-
    device from pinned memory (1 GiB), a bf16 matmul at a llama2-70b
    prefill GEMM under 8-way tensor parallelism, and a 1 GiB device-to-
    device copy (its read and write bytes over the HBM rate)."""
    n = 1 << 30
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    h2d_ms = timer.ms(lambda: dev.copy_(host, non_blocking=True), iters=5,
                      warmup=1)
    src = torch.empty(n, dtype=torch.uint8, device="cuda")
    d2d_ms = timer.ms(lambda: dev.copy_(src), iters=10)
    del host, dev, src
    m, k, nn = 4096, 8192, 3584
    g = torch.Generator(device="cuda").manual_seed(10)
    a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    b = torch.randn(k, nn, generator=g, device="cuda").bfloat16()
    mm_ms = timer.ms(lambda: torch.matmul(a, b))
    return dict(dram_bw=n / (h2d_ms * 1e-3),
                mfu_prefill=2.0 * m * k * nn / (mm_ms * 1e-3) / BF16_FLOP_S,
                mbu_decode=2.0 * n / (d2d_ms * 1e-3) / HBM_BYTES_S,
                h2d_ms=h2d_ms, d2d_ms=d2d_ms, matmul_ms=mm_ms)


def cluster_lane(torch, cfg, name, **kw):
    """One ``serve_cluster`` lane with this process's kernel launches
    counted from zero and held to layers x steps; returns its summary."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.launch.serve_cluster import serve_cluster
    paged_attention.launches = 0
    flash_prefill.launches = 0
    s = serve_cluster(cfg, "cuda", log=log, **kw)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "flash_prefill": flash_prefill.launches}
    if s.get("lane") is not None:
        log(f"{name}: {s['served']} requests served, {s['rejected']} "
            f"rejected, {s['tokens']} tokens in {s['seconds']:.3f} s "
            f"({s['decode_tok_s']:.2f} tok/s); prefix reuse {s['reused']} "
            f"blocks; arms won {s.get('arms')}; migrations "
            f"{s.get('migrations')} (conductor "
            f"{s.get('conductor_migrations')}); zero-copy joins "
            f"{s.get('zero_copy_joins')}; page pool leak-free "
            f"{s.get('pages_leak_free')}")
        log(f"{name} launches: paged_attention {launches['paged_attention']} "
            f"(= {cfg.n_layers} x {s['paged_calls']} paged step calls), "
            f"flash_prefill {launches['flash_prefill']} (= {cfg.n_layers} x "
            f"{s['prefill_chunks']} prefill chunks)")
        if launches["paged_attention"] != cfg.n_layers * s["paged_calls"] \
                or launches["flash_prefill"] != \
                cfg.n_layers * s["prefill_chunks"] \
                or not (launches["paged_attention"]
                        and launches["flash_prefill"]):
            raise AssertionError(f"{name}: launches do not match layers x "
                                 f"steps, or a kernel never launched")
        if not s["served"] or not s.get("pages_leak_free"):
            raise AssertionError(f"{name}: nothing served or pages leaked")
        for rid, out in s["outputs"].items():
            if not out or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"{name}: request {rid}: bad stream")
    return s


def check_nodes(s, name, *, chaos: bool) -> None:
    """Hold a --processes lane's report: every surviving node bit-exact
    against the oracle, the prefill kernel launched in each, and the
    wire or the degradation accounted."""
    log(f"{name}: failures {s['failures']}, fallback_reasons "
        f"{s['fallback_reasons']}, directory healed {s['directory_healed']}")
    survivors = range(1 if chaos else 0, s["processes"])
    for i in survivors:
        r = s["results"].get(i)
        if r is None or not r.get("bit_exact"):
            raise AssertionError(f"{name}: node {i} not bit-exact")
        log(f"{name} node {i}: bit-exact, peer blocks {r['peer_blocks']}, "
            f"SocketPeer bw_ema {r['bw']} B/s and layers read {r['reads']}, "
            f"BlockServer frames {r['server']['frames_served']} bytes "
            f"{r['server']['bytes_served']}, launches {r['launches']}")
        for plan in r["plans"]:
            log(f"  {name} node {i} overlap plan: {json.dumps(plan)}")
        if not r["launches"]["flash_prefill"]:
            raise AssertionError(f"{name}: node {i} never launched "
                                 f"flash_prefill")
    if s["failures"]:
        raise AssertionError(f"{name}: {s['failures']} failures")
    if chaos:
        if not (s["directory_healed"] and (
                s["fallback_reasons"].get("peer_unreachable")
                or s["fallback_reasons"].get("verify_failed"))):
            raise AssertionError(f"{name}: the dead owner went unaccounted")
    elif sum(s["results"][i]["peer_blocks"] for i in survivors) \
            != 2 * len(survivors):
        raise AssertionError(f"{name}: peer blocks over the wire != 2 a node")


def e2e_cluster(torch, timer, params, smi):
    import shutil
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.core.costmodel import H100
    from repro_torch.data.pipeline import realize_request_tokens
    from repro_torch.launch.serve_cluster import make_trace
    from repro_torch.models.layers import plain_attention
    cfg = get_config("smollm-360m")
    cal = calibrate(torch, timer)
    log(f"calibration ({smi}): host-to-device from pinned memory "
        f"{cal['dram_bw'] / 1e9:.2f} GB/s (1 GiB in {cal['h2d_ms']:.3f} ms; "
        f"Hardware default {H100.dram_bw / 1e9:.2f}); bf16 matmul "
        f"4096x8192 @ 8192x3584 {cal['matmul_ms']:.4f} ms = mfu "
        f"{cal['mfu_prefill']:.4f} of 989 TFLOP/s (default "
        f"{H100.mfu_prefill:.4f}); 1 GiB device copy {cal['d2d_ms']:.4f} ms "
        f"= mbu {cal['mbu_decode']:.4f} of 3.35 TB/s (default "
        f"{H100.mbu_decode:.4f})")

    s = cluster_lane(torch, cfg, "conductor lane", params=params,
                     requests=24, strategy="kvcache")
    rid = next(r["req_id"] for r in s["records"] if r["accepted"])
    req = next(r for r in make_trace(24) if r.req_id == rid)
    prompt = realize_request_tokens(req, cfg.vocab_size)
    stream = s["outputs"][rid]
    lk = teacher_forced(torch, params, cfg, prompt, stream)
    with plain_attention():
        lp = teacher_forced(torch, params, cfg, prompt, stream)
    torch.cuda.synchronize()
    err = (lk - lp).abs().max().item()
    tol = bf16_ulps(4, lp.abs().max().item())
    log(f"conductor lane teacher forcing (request {rid}, prompt "
        f"{len(prompt)}, {len(stream)} positions): kernel vs plain "
        f"max_abs_err {err:.4f} (tol {tol:.4f} = 4 bf16 ulps), kernel "
        f"argmax == served stream: {lk.argmax(-1).cpu().tolist() == stream}")
    if not bool(torch.isfinite(lk).all()) or err > tol:
        raise AssertionError("conductor lane: kernel and plain disagree")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="cluster-", dir=os.path.join(ROOT, "build"))
    try:
        # random routing: under kvcache one instance takes every request
        # (its modelled queue drains between phase-at-a-time dispatches),
        # so nothing would ever be a peer's; blocking loads feed the read EMA
        g = cluster_lane(torch, cfg, "global-pool lane", params=params,
                         requests=24, global_pool=True, ssd_blocks=64,
                         dram_blocks=8, ssd_dir=os.path.join(root, "gp"),
                         strategy="random", ssd_mode="blocking")
        ema = g["ssd_read_ema"]
        log(f"global-pool lane: conductor SSD loads "
            f"{g['conductor_ssd_loads']}, peer-SSD arms won "
            f"{g['conductor_peer_ssd_loads']}, engine fetched "
            f"{g['peer_blocks_fetched']} peer blocks "
            f"({g['peer_fetch_failures']} failures, "
            f"{g.get('fallback_reasons')}); store read EMA "
            + (f"{ema * 1e3:.3f} ms a block, fed to "
               f"CostModel.calibrate_ssd_read" if ema else "none"))
        if not g["peer_blocks_fetched"] or g["peer_fetch_failures"] \
                or not ema:
            raise AssertionError("global-pool lane fetched no peer block, a "
                                 "fetch failed, or no read was measured")
        p3 = cluster_lane(torch, cfg, "3-process lane", processes=3,
                          ssd_dir=os.path.join(root, "p3"))
        check_nodes(p3, "3-process lane", chaos=False)
        ch = cluster_lane(torch, cfg, "chaos lane", processes=3,
                          chaos="kill-owner",
                          ssd_dir=os.path.join(root, "chaos"))
        check_nodes(ch, "chaos lane", chaos=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return cal


# ---------------------------------------------------------------------------
# phase 11: the simulator on H100 prices
# ---------------------------------------------------------------------------

def synced_ms(torch, fn, n: int = 5) -> float:
    """Median host wall time of ``fn`` in ms, synchronised around each
    call (the time a caller waits, host dispatch included)."""
    fn()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        ts.append((time.monotonic() - t0) * 1e3)
    return sorted(ts)[n // 2]


def modelled_vs_measured(torch, params, cfg, hw, device="cuda") -> None:
    """The cost model of smollm-360m on one calibrated H100 against the
    port's synchronised prefill chunk and paged decode step (phase 5's
    shapes: 256 tokens at offset 1280; 8 slots at the launcher's depths)."""
    import numpy as np

    from repro_torch.core.costmodel import CostModel, InstanceSpec
    from repro_torch.launch.serve import MAX_LEN, make_payloads
    from repro_torch.models.transformer import decode_step, init_caches
    from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                            PrefillWorker)
    from repro_torch.serving.paged_cache import DevicePagePool
    from repro_torch.serving.request import ServingRequest
    cm = CostModel(cfg, InstanceSpec(n_chips=1, hw=hw))
    pp = DevicePagePool(cfg, n_pages=1 + 9 * (MAX_LEN // 64), page_tokens=64,
                        device=device)
    pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=256,
                       page_pool=pp)
    dw = DecodeWorker(params, cfg, max_batch=8, max_len=MAX_LEN, page_pool=pp)
    payloads = make_payloads(12, cfg.vocab_size, max_new=MAX_LEN, seed=0)[:8]
    for rid, toks, _, _ in payloads:
        dw.join(ServingRequest(rid, toks, MAX_LEN - len(toks)), pw(toks))
    lens = [len(t) for _, t, _, _ in payloads]
    ema_ms = pw.est_chunk_s() * 1e3
    toks = torch.as_tensor(np.asarray(payloads[0][1][:1536], np.int64)[None],
                           device=device)
    caches = init_caches(cfg, 1, 1536, device=device)._replace(length=1280)
    chunk_ms = synced_ms(
        torch, lambda: decode_step(params, toks[:, 1280:1536], caches, cfg))
    step_ms = synced_ms(torch, dw.step)
    mean_ctx = float(np.mean(lens))
    m_pre = cm.prefill_time(1536, 1280) * 1e3
    m_dec = cm.decode_iter_time(8, mean_ctx) * 1e3
    log(f"(b) modelled, smollm-360m on one calibrated H100: prefill_time("
        f"1536, 1280) {m_pre:.4f} ms; decode_iter_time(8, {mean_ctx:.1f}) "
        f"{m_dec:.4f} ms")
    log(f"(b) measured: 256-token chunk at offset 1280 {chunk_ms:.3f} ms "
        f"(synchronised, median of 5; the worker's chunk EMA over the 8 "
        f"prefills {ema_ms:.3f} ms); paged decode step, 8 slots at depths "
        f"{lens}, {step_ms:.3f} ms")
    log(f"(b) measured / modelled: prefill {chunk_ms / m_pre:.1f}x, decode "
        f"{step_ms / m_dec:.1f}x (a reading, not a gate)")


def check_replay(results: dict, n: int, speedup: float) -> None:
    """The replay's invariants: every request completed or rejected, every
    accepted request completed, no decode double-check under the policies
    that gate on both pools at arrival."""
    import numpy as np
    for adm, res in results.items():
        waste = sum(1 for r in res.records
                    if r.reject_stage == "decode_doublecheck")
        log(f"  {speedup:g}x {adm:10s} rejected {len(res.rejected())} "
            f"(after prefill: {waste}) | completed {len(res.completed())} "
            f"| goodput {res.goodput(30, .1):.4f} req/s | decode-load std "
            f"{np.std([d for _, _, d in res.load_samples]):.4f} | "
            f"{res.reject_breakdown()}")
        if len(res.completed()) + len(res.rejected()) != n \
                or not all(r.completed for r in res.records if r.accepted):
            raise AssertionError(f"replay {speedup}x {adm}: a request was "
                                 f"lost or an accepted one did not complete")
        if adm in ("early", "predictive") and waste:
            raise AssertionError(f"replay {speedup}x {adm}: rejected after "
                                 f"prefill")


def e2e_simulator(torch, params, cal, smi, device="cuda"):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.costmodel import H100, InstanceSpec
    from repro_torch.core.simulator import CoupledCluster, MooncakeCluster
    from repro_torch.core.trace import BLOCK_TOKENS, simulated_requests
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.launch import overload_replay, quickstart
    from repro_torch.models.layers import plain_attention
    cfg = get_config("smollm-360m")
    hw = dataclasses.replace(H100, dram_bw=cal["dram_bw"],
                             mfu_prefill=cal["mfu_prefill"],
                             mbu_decode=cal["mbu_decode"])
    node = InstanceSpec(hw=hw)
    log(f"(a) calibrated Hardware ({smi}): dram_bw {hw.dram_bw / 1e9:.2f} "
        f"GB/s, mfu_prefill {hw.mfu_prefill:.4f}, mbu_decode "
        f"{hw.mbu_decode:.4f}; data sheet peak_flops {hw.peak_flops:.3g}, "
        f"hbm_bw {hw.hbm_bw:.3g}; simulated nodes of {node.n_chips} GPUs")
    modelled_vs_measured(torch, params, cfg, hw, device)

    t0 = time.monotonic()
    log("(c) quickstart sections 1-3, 3000 requests, simulated seconds "
        "priced on the calibrated H100 node:")
    quickstart.simulator_sections(3000, node, log=log)
    flash_prefill.launches = 0
    r1, r2 = quickstart.engine_section(params, cfg, device, log=log)
    torch.cuda.synchronize()
    launches = flash_prefill.launches
    computed = [r.prompt_len - BLOCK_TOKENS * r.reused_blocks
                for r in (r1, r2)]
    chunks = sum(-(-c // 128) for c in computed)
    log(f"(c) section 4 at full width: flash_prefill {launches} launches "
        f"(= {cfg.n_layers} x {chunks} chunks of 128); request 2 reused "
        f"{r2.reused_blocks} blocks, computed {computed[1]} tokens")
    if (r1.reused_blocks, r2.reused_blocks, computed[1]) != (0, 2, 64):
        raise AssertionError("section 4: request 2 did not reuse the "
                             "document's 2 blocks and compute only its tail")
    if launches != cfg.n_layers * chunks:
        raise AssertionError("section 4: flash_prefill launches do not "
                             "match layers x chunks")
    with plain_attention():
        p1, _ = quickstart.engine_section(params, cfg, device,
                                          log=lambda *_: None)
    torch.cuda.synchronize()
    err = max((r1.kv_k.float() - p1.kv_k.float()).abs().max().item(),
              (r1.kv_v.float() - p1.kv_v.float()).abs().max().item())
    scale = max(p1.kv_k.float().abs().max().item(),
                p1.kv_v.float().abs().max().item())
    tol = bf16_ulps(4, scale)
    finite = bool(torch.isfinite(r1.kv_k.float()).all()
                  and torch.isfinite(r1.kv_v.float()).all())
    log(f"(c) section 4 request 1 KV, kernel vs plain: max_abs_err {err:.4f}"
        f" (max |kv| {scale:.3f}; tol {tol:.4f} = 4 bf16 ulps); first token "
        f"{r1.first_token} vs {p1.first_token}")
    if not finite or err > tol:
        raise AssertionError("section 4: kernel and plain KV disagree")
    log(f"(c) took {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    reqs = overload_replay.replay_trace(4000)
    log(f"(d) overload replay: {len(reqs)} requests, 8P+8D, TTFT SLO 30 s, "
        f"TBT SLO 0.1 s, t_d 20 s; simulated, priced on the calibrated "
        f"H100 node")
    # 4-32x is the reference's range; 64 and 128x find where the H100
    # cluster overloads
    for speedup in (4.0, 8.0, 16.0, 32.0, 64.0, 128.0):
        results = overload_replay.replay(reqs, speedup, node,
                                         log=lambda *_: None)
        check_replay(results, len(reqs), speedup)
    log(f"(d) took {time.monotonic() - t0:.1f} s")

    reqs = simulated_requests(150, 32768, 512, cache_ratio=0.5, rps=2.0)
    big = get_config("llama2-70b")
    mc = MooncakeCluster(big, n_prefill=2, n_decode=2,
                         inst_spec=node).run(reqs)
    vl = CoupledCluster(big, n_instances=4, inst_spec=node).run(reqs)
    for name, res in (("Mooncake 2P+2D", mc), ("coupled x4", vl)):
        if len(res.completed()) + len(res.rejected()) != len(reqs):
            raise AssertionError(f"figure 12 {name}: a request was lost")
        log(f"(e) figure 12, {name}: goodput {res.goodput(30, .1):.4f} "
            f"req/s, completed {len(res.completed())}, TTFT p90 "
            f"{res.ttft_p90():.3f} s, TBT p90 {res.tbt_p90() * 1e3:.2f} ms "
            f"(simulated, calibrated H100 nodes)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"the repo's src/repro_torch is missing: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    phase("2 kernel build")
    b = _build.build_all()
    log(f"built {b['built']} in {b['seconds']:.1f} s (nvcc, sm_90a, "
        f"one process per source)")
    for name in b["built"]:
        for fn, info in ptxas_by_kernel(_build.ptxas_report(name)):
            log(f"  ptxas[{name}] {fn}: {info}")
    lib = _build.library("paged_attention")
    log("  paged_decode_kernel dynamic shared memory: " + ", ".join(
        f"D={d} {lib.paged_attention_smem_bytes(d)} B" for d in (32, 64, 128)))

    timer = Timer(torch)
    smollm_map = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 0]
    phase("3 paged decode kernel vs plain (card)")
    lens = [1, 2048, 1536, 64, 65, 700, 1537, 333]     # ragged, full table
    paged = check_paged(torch, timer, "smollm-360m", paged_case(
        torch, B=8, H=16, KV=5, D=64, page=64, max_pages=32, P=289,
        lens=lens, qh2kv=smollm_map, seed=0), main=True)
    check_paged(torch, timer, "grouped-D128", paged_case(
        torch, B=8, H=16, KV=2, D=128, page=64, max_pages=32, P=289,
        lens=[5, 2048, 640, 1, 100, 1500, 63, 1024], qh2kv=None, seed=1),
        main=False)
    # eight splits with 1-token slots: seven of each such cluster's eight
    # blocks hold no token and still take part in the merge
    check_paged(torch, timer, "8-splits-1-token-slots", paged_case(
        torch, B=8, H=16, KV=5, D=64, page=64, max_pages=32, P=289,
        lens=[1, 2048, 1, 64, 65, 700, 1537, 1], qh2kv=smollm_map, seed=2),
        main=False, n_splits=8)
    check_paged(torch, timer, "KV1-16-heads-D128", paged_case(
        torch, B=8, H=16, KV=1, D=128, page=64, max_pages=32, P=289,
        lens=[2048, 1, 333, 1024, 64, 65, 1999, 700], qh2kv=None, seed=3),
        main=False)

    phase("4 chunked-prefill kernel vs plain (card)")
    pre = None
    for off, sq, sk in ((0, 256, 1536), (256, 256, 1536), (1280, 256, 1536),
                        (1280, 131, 1411)):
        r = check_prefill(torch, timer, f"off{off}-sq{sq}", Sq=sq, Sk=sk,
                          q_offset=off, H=16, KV=5, D=64, qh2kv=smollm_map,
                          seed=off + sq, main=(off == 1280 and sq == 256))
        pre = r or pre
    # forced key splits at q_offset 0: the first query tile sees one key
    # tile, so four of its five splits hold no key for any of its rows
    check_prefill(torch, timer, "off0-sq256-5splits", Sq=256, Sk=1536,
                  q_offset=0, H=16, KV=5, D=64, qh2kv=smollm_map, seed=7,
                  main=False, n_splits=5)

    phase("5 end to end, smollm-360m full width")
    launches, smollm_params = e2e_smollm(torch)

    phase("6 SSD-scan kernel vs plain (card)")
    ssd = check_ssd(torch, timer, "mamba2-2.7b", b=1, s=512, h=80, p=64,
                    n=128, chunk=256, seed=6, main=True)
    check_ssd(torch, timer, "tail-96", b=1, s=96, h=80, p=64, n=128,
              chunk=96, seed=7, main=False)
    check_ssd(torch, timer, "reduced", b=1, s=256, h=32, p=16, n=16,
              chunk=32, seed=8, main=False)

    phase("7 paged decode, all layers in one launch, vs per layer and plain")
    layers_launches, layers = check_paged_layers(
        torch, timer, L=32, B=8, H=16, KV=5, D=64, page=64, max_pages=32,
        P=289, lens=lens, qh2kv=smollm_map, seed=0)

    phase("8 end to end, mamba2-2.7b full width")
    ssd_launches = e2e_mamba(torch)

    phase("9 the storage hierarchy, smollm-360m full width")
    e2e_tiers(torch, smollm_params)

    phase("10 the Conductor and the wire, smollm-360m full width")
    cal = e2e_cluster(torch, timer, smollm_params, smi)

    phase("11 the simulator on H100 prices")
    e2e_simulator(torch, smollm_params, cal, smi)
    del smollm_params

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:76",
             launches=launches["paged_attention"], **paged),
        dict(name="flash_prefill", route="cuda",
             source="src/repro_torch/csrc/flash_prefill.cu",
             replaces="src/repro/kernels/flash_prefill/kernel.py:83",
             launches=launches["flash_prefill"], **pre),
        dict(name="paged_attention_layers", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:157",
             launches=layers_launches, **layers),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:79",
             launches=ssd_launches, **ssd),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
