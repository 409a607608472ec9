#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. the build of every hand-written kernel (one nvcc per source, all at
     once) and what ptxas reports for each kernel (registers, static
     shared memory, spills), with the paged kernel's dynamic shared
     memory per head_dim (32, 64, 96, 128);
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
     Figure-12 scenario, Mooncake 2P+2D against the coupled baseline x4;
 12. the MoE family: (a) both attention kernels against their plain
     versions at head_dim 128 — qwen3-moe's 64 query heads over 4 KV
     heads, mixtral's 32 over 8 with its 4096-token window binding, and
     a 64-token window; (b) qwen3-moe-235b-a22b at full width, depth cut
     to 4 of 94 layers (weights drawn on the card), served by the
     launcher's body with its launches counted, then one request
     teacher-forced through the kernel and plain paths with every
     layer's routing recorded: logits held up to the first position
     where the experts that computed it differ, and at every position
     with the plain run's routing replayed in the kernel path; (c)
     mixtral-8x7b at full width, 2 of 32 layers: a 5,120-token prompt
     through prefill() and 16 paged decode steps, held the same way;
 13. the remaining families: (a) the kernels at their new shapes, each
     against its plain version, timed beside its bound, plain version
     and SDPA — flash_prefill at whisper's decoder prompt (32 heads
     padded over 20 KV, head_dim 64), at internvl2's prefill (256
     patches + a 256-token prompt, 48 over 8) and at qwen3-14b's chunk
     (48 padded over 8), paged_attention at qwen3-14b's decode, ssd_scan
     at jamba's mixer (256 heads, p 64, d_state 64, 1,024 tokens); (b)
     whisper-large-v3 at full width and depth: prefill(frames=) of four
     1500-frame stub inputs and a 64-token prompt, 64 greedy
     decode_steps, the encoder's share of the run, teacher-forced
     through the plain path; (c) internvl2-26b at full width and depth:
     prefill(patches=) of 256 stub patches and a 256-token prompt, 16
     greedy steps, teacher-forced, peak memory; (d) qwen3-14b at full
     width and depth served by the launcher's body (phase 5's workload),
     launches counted, one request teacher-forced; (e) jamba-1.5-large's
     hybrid stack at reduced width (one full-width period, 90 GB of
     bf16, exceeds the card): prefill(), an extend of the whole prompt
     and 16 steps, the kernel path under the plain run's MoE routing
     held at every position;
 14. the multi-device serving paths with every mesh position on the
     card (it has one GPU; ``make_decode_mesh`` refuses to stack
     positions, so the meshes are built from explicit device arrays):
     (a) ``paged_decode_attention_sharded`` on a (2, 2) mesh at
     llama2-70b's decode shape (64 query heads over 8 KV, head_dim 128),
     bitwise the unsharded kernel with its split count pinned, within
     2e-2 of the plain version, timed; (b) llama2-70b at full width,
     depth cut to 8 of 80 layers: PrefillWorker, the banked page pool and
     DecodeWorker on meshes (1,1), (2,1), (1,2), (2,2) — three prompts
     sharing one 512-token block, one fanned out to two slots, 16 new
     tokens each — every mesh's streams and logits held against the
     unmeshed run by phase 5's rule, COW and leak checks, step times,
     peak memory; the launcher's body on ``make_decode_mesh(1, 1)``
     serving phase 5's workload; the refusal of ``make_decode_mesh(2,
     2)`` on a one-GPU host; (c) CPP over 4 stages of 2 layers, one
     8,192-token prompt in 1,024-token chunks: 11 microsteps, 64
     flash_prefill launches, logits within 4 ulps of ``cpp_reference``
     and KV within 2e-2 of its scale, both wall times.
 15. training on the card, which launches none of the kernels (they
     are forward-only; every kernel's launch count is held at zero):
     (a) one train step's loss and gradients of smollm-360m.reduced() on
     the card against the CPU's, same weights and batch; (b) ``python -m
     repro_torch.launch.train --arch smollm-360m --steps 60 --batch 8
     --seq 512`` (full width and depth, AdamW, remat), the loss falling,
     tok/s, the model-FLOP share and peak memory; (c)
     ``launch/train_e2e.py``'s smollm-100m, 300 steps with checkpoints
     at 100/200/300 and a 20-step resume that continues the curve, the
     checkpoint read back bit for bit; (d) llama2-70b at full width, 4 of
     80 layers, Adafactor, remat, 3 steps of one 4096-token sequence;
     (e) one profiled train step of (b)'s model: device-busy time, idle
     share, kernels a step, the largest items, the plain attention's
     share.
 16. head dim 96 and the last dense configs: (a) both attention kernels
     at D=96 against their plain versions — paged at phi3-mini's decode
     (8 slots, 32 query heads over 32 KV heads, the launcher's depths, a
     poisoned null page; timed beside its bound, plain version and SDPA),
     forced splits 1/2/4/8 with 1- and 65-token slots, 16 over 4 with a
     map, a 300-token window, the layers entry over 32 layers (bitwise
     per layer, timed); prefill at Sq 256 over 1536 keys at offsets 1280
     (timed) and 0, a ragged 131-token tail, five forced key splits, a
     window; (b) phi3-mini-3.8b and (c) qwen2.5-3b (QKV bias) at full
     width and depth served by the launcher's body with phase 5's
     workload, launches = layers x calls, one request teacher-forced; (d)
     the sharded op on the (2, 2) mesh at D=96, bitwise the unsharded
     kernel.
 17. sharded training and the sharded MoE dispatch, every position of a
     (2, 2) (data, model) mesh on the card: (a) ``moe_block`` at B = 2,
     S = 4096 from ``shard_params``' slices — qwen3-moe's full-width
     layer expert-parallel (64 experts a position), mixtral's
     tensor-parallel (14,336 split in two) — against a one-device oracle
     of each position's slice within 4 bf16 ulps, timed beside the
     unsharded op; (b) ``make_prefill_step`` over 2 x 4096 tokens:
     llama2-70b at full width, 8 of 80 layers, 32 flash_prefill launches
     of 32 query heads over 4 KV, logits within 4 ulps of the unsharded
     prefill; qwen3-moe at 4 of 94 layers, 16 launches, the kernel path
     against the plain path under the plain run's routing; (c)
     smollm-360m at full width trained 10 steps of 8 x 512 on the mesh
     against 10 unsharded (step 1's loss and gradients, tok/s, peak);
     (d) qwen3-moe at full width, 1 of 94 layers, Adafactor, 3 steps of
     2 x 4096, the expert-parallel dispatch on every MoE call; no kernel
     launched in (c) or (d); (c) and (d) run the vocab-parallel
     embedding and cross-entropy (each position's stripe of the
     vocabulary).
 18. the context-parallel serve step and the tensor-parallel Mamba2
     mixer, every position of a mesh on the card: (a) ``decode_32k``'s
     sequence — llama2-70b at full width, 8 of 80 layers, batch 8 (cut
     from 128), caches of 32,768 slots at length 32,640 (random K/V) —
     ``make_serve_step`` on (1, 4) (8,192-slot stripes) and (2, 2), 16
     greedy steps fed the unsharded stream, against the unsharded
     ``decode_step``: logits within ``serve_ulps`` (4 bf16 ulps at 8
     layers, scaled with depth), argmax equal wherever the gap allows,
     step walls, peak memory; (c) ``make_prefill_step`` of mamba2-2.7b at
     full width and depth over 2 x 4096 tokens on (2, 2): 256
     ``ssd_scan`` launches on 40 of 80 heads, every layer's mixer held on
     the unsharded run's input to it (y within 2 ulps, states within a
     bf16 ulp), the free run's distance reported beside the unsharded
     stack's kernel-vs-plain one, ``ssd_scan`` at h = 40 timed; (b)
     ``long_500k`` on (2, 2), batch 1, the sequence over all four
     positions: smollm-360m at full width and depth over the wrapped
     8,192-slot ring at length 524,000, and mamba2-2.7b from (c)'s state
     (each decode mixer held per layer), 16 steps each.
 19. the dry run (``repro_torch.launch.dryrun``, host only, no jax):
     (a) smollm-360m's ``decode_32k`` on the 16x16 production mesh and
     ``train_4k`` on 2x16x16, counted on the card's host; (b) three
     steps predicted on stand-in positions, then run on the card with
     every position on ``cuda:0`` — smollm-360m's prefill of 1 x 8192 on
     1x1 (full width and depth), llama2-70b's ``decode_32k`` serve step
     (8 of 80 layers, batch 8) on (2, 2), mamba2-2.7b's prefill of 2 x
     4096 on (2, 2): the predicted argument bytes held equal to the bytes
     the step receives and the step's peak held at least those, the
     logits finite, smollm-360m's within 4 bf16 ulps of its plain path's
     (the other two shapes are held in phase 18); the predicted peak and
     roofline bound read beside the measured peak and wall, the launches
     counted into the kernels line.
 20. where mesh steps keep what they make, every position of a (2, 2)
     mesh on the card: (a) ``make_prefill_step`` over 2 x 4096 tokens of
     llama2-70b (full width, 8 of 80 layers) and mamba2-2.7b (full width
     and depth): the caches come back ``Sharded`` by ``cache_specs``,
     gathered bit for bit the joined caches (a copy of the join is kept
     in the phase), each position's cache bytes, the peak, the launches;
     4 serve steps from them as they are within ``serve_ulps`` of the
     unsharded step; (b) the MoE global dispatch (2 x 1024 tokens) of a
     full-width qwen3-moe (ep) and mixtral (tp) layer, bit for bit the
     dispatch on one position, the bytes copied into (0, 0) before and
     after (the dry run's stand-in count); (c) smollm-360m at full width
     through ``ChunkedPrefill`` (one ``advance()`` a 256-token chunk,
     drained bit-exact with the blocking call) and one paged decode
     step, both held against the same pass under ``plain_attention()``
     within phase 5's 4 bf16 ulps, and each op ``repro_torch.kernels``
     exports against its exported oracle.
Then one JSON line of per-kernel numbers, the nvidia-smi line, and the
result line. Times are CUDA-event times with the L2 cache flushed before
every launch; bounds use the H100 SXM peaks (3.35 TB/s, 989 TFLOP/s bf16).
"""
from __future__ import annotations

import gc
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


def check_paged(torch, timer, name, case, main: bool, n_splits=None,
                window: int = 0):
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ops import grouped_map
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_attention_splits_ref)
    q, kp, vp, table, lens, m = case
    B, H, D = q.shape
    KV = kp.shape[2]
    mk = m if m is not None else grouped_map(H, KV, q.device)
    out = paged_attention(q, kp, vp, table, lens, mk, n_splits=n_splits,
                          window=window)
    torch.cuda.synchronize()
    splits = paged_attention.last_splits
    ref = paged_attention_ref(q, kp, vp, table, lens, qh2kv=m, window=window)
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    # the plain split decomposition with the kernel's split count
    split_ref = paged_attention_splits_ref(q, kp, vp, table, lens, qh2kv=m,
                                           n_splits=splits, window=window)
    err_split = (out.float() - split_ref.float()).abs().max().item()
    log(f"paged[{name}]: B={B} H={H} KV={KV} D={D} lens={lens.tolist()} "
        f"window={window} n_splits={splits} max_abs_err={err:.3e} (vs the "
        f"plain split decomposition {err_split:.3e}; tol {TOL}) "
        f"finite={finite}")
    if not (err <= TOL and err_split <= TOL and finite):
        raise AssertionError(f"paged decode kernel disagrees ({name})")
    if n_splits is not None and splits != n_splits:
        raise AssertionError(f"paged ran {splits} splits, not {n_splits}")
    if not main:
        return None
    ms = timer.ms(lambda: paged_attention(q, kp, vp, table, lens, mk,
                                          window=window))
    sweep = {ns: timer.ms(lambda: paged_attention(q, kp, vp, table, lens, mk,
                                                  n_splits=ns, window=window))
             for ns in (1, 2, 4, 8)}
    log(f"paged[{name}]: forced splits " + ", ".join(
        f"{ns}: {t:.4f} ms" for ns, t in sweep.items())
        + f" (the chooser took {splits})")
    # the fixed cost: the same call with no live token in any slot, and
    # one trivial kernel launch under the same timer
    no_tok = torch.zeros_like(lens)
    empty_ms = timer.ms(lambda: paged_attention(q, kp, vp, table, no_tok, mk,
                                                window=window))
    one = torch.zeros(1, device=q.device)
    launch_ms = timer.ms(lambda: one.fill_(1.0))
    log(f"paged[{name}]: fixed cost: {empty_ms:.4f} ms with no live token, "
        f"{launch_ms:.4f} ms for one trivial kernel launch")
    plain_ms = timer.ms(lambda: paged_attention_ref(q, kp, vp, table, lens,
                                                    qh2kv=m, window=window))
    # library yardstick: SDPA on pre-gathered, head-expanded KV (the
    # gather is excluded from its time)
    S = table.shape[1] * kp.shape[1]
    kx = kp[table.long()].reshape(B, S, KV, D)[:, :, mk.long()]
    vx = vp[table.long()].reshape(B, S, KV, D)[:, :, mk.long()]
    kx, vx = kx.transpose(1, 2).contiguous(), vx.transpose(1, 2).contiguous()
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < lens[:, None].long()
    if window:
        mask &= pos >= lens[:, None].long() - window
    mask = mask[:, None, None, :]
    qx = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer.ms(lambda: sdpa(qx, kx, vx, attn_mask=mask))
    # the tokens this run's slots attend (a window reads its last tokens)
    toks = sum(min(n, window) if window else n for n in lens.tolist())
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
                  seed, main: bool, n_splits=None, window: int = 0):
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import (flash_prefill_ref,
                                                       flash_prefill_split_ref)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, Sq, H, D, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, Sk, KV, D, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, Sk, KV, D, generator=g, device="cuda").bfloat16()
    k[:, q_offset + Sq:] = 1e4        # keys past the chunk: never read
    v[:, q_offset + Sq:] = -1e4
    k_lo = max(0, q_offset - window + 1) if window else 0
    k[:, :k_lo] = 1e4                 # keys before every query's window
    v[:, :k_lo] = -1e4
    m = torch.tensor(qh2kv, dtype=torch.int32, device="cuda")
    out = flash_prefill(q, k, v, m, q_offset=q_offset, n_splits=n_splits,
                        window=window)
    torch.cuda.synchronize()
    splits = flash_prefill.last_splits
    ref = flash_prefill_ref(q, k, v, q_offset=q_offset, qh2kv=m,
                            window=window)
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    # the plain split-over-keys decomposition with the kernel's split count
    split_ref = flash_prefill_split_ref(q, k, v, q_offset=q_offset, qh2kv=m,
                                        n_splits=splits, window=window)
    err_split = (out.float() - split_ref.float()).abs().max().item()
    log(f"prefill[{name}]: Sq={Sq} Sk={Sk} q_offset={q_offset} H={H} KV={KV} "
        f"D={D} window={window} n_splits={splits} max_abs_err={err:.3e} "
        f"(vs the plain split decomposition {err_split:.3e}; tol {TOL}) "
        f"finite={finite}")
    if not (err <= TOL and err_split <= TOL and finite):
        raise AssertionError(f"prefill kernel disagrees ({name})")
    if n_splits is not None and splits != n_splits:
        raise AssertionError(f"prefill ran {splits} splits, not {n_splits}")
    if not main:
        return None
    ms = timer.ms(lambda: flash_prefill(q, k, v, m, q_offset=q_offset,
                                        window=window))
    plain_ms = timer.ms(lambda: flash_prefill_ref(q, k, v, q_offset=q_offset,
                                                  qh2kv=m, window=window))
    ml = m.long()
    qx = q.transpose(1, 2).contiguous()
    kx = k[:, :, ml].transpose(1, 2).contiguous()
    vx = v[:, :, ml].transpose(1, 2).contiguous()
    qpos = q_offset + torch.arange(Sq, device="cuda")
    kpos = torch.arange(Sk, device="cuda")[None, :]
    mask = qpos[:, None] >= kpos
    if window:
        mask &= qpos[:, None] - kpos < window
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer.ms(lambda: sdpa(qx, kx, vx, attn_mask=mask))
    # the keys read and the (query, key) pairs this chunk's masks keep
    keys = min(Sk, q_offset + Sq) - k_lo
    pairs = sum(min(Sk, q_offset + i + 1) - (max(0, q_offset + i - window + 1)
                                             if window else 0)
                for i in range(Sq))
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
                   kv=None, all_positions=False):
    """Logits of every position a served stream was sampled from: the
    first token's (chunked prefill) and each decode step's (paged). With
    ``kv`` — host (k, v) of the prompt from another path, such as a
    tiered prefill — the prompt's KV but its last token's comes from
    there, and the first token's logits from a one-token extend. With
    ``all_positions`` the rows start with every prompt position's."""
    from repro_torch.models.transformer import (decode_step,
                                                decode_step_paged,
                                                init_caches)
    from repro_torch.serving.engine import stage_run
    from repro_torch.serving.paged_cache import DevicePagePool
    dev = params["embed"].device
    S = len(prompt)
    t = torch.as_tensor(prompt[None, :].astype("int64"), device=dev)
    caches = init_caches(cfg, 1, S, device=dev)
    prompt_rows = []
    if kv is None:
        for lo in range(0, S, chunk):
            logits, caches = decode_step(params, t[:, lo:lo + chunk], caches,
                                         cfg)
            prompt_rows.append(logits[0])
    else:
        caches.kv.k[:, 0, :S - 1] = kv[0][:, :S - 1].to(dev)
        caches.kv.v[:, 0, :S - 1] = kv[1][:, :S - 1].to(dev)
        logits, caches = decode_step(params, t[:, S - 1:],
                                     caches._replace(length=S - 1), cfg)
    rows = list(torch.cat(prompt_rows)) if all_positions else [logits[0, -1]]
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


def draw_params(torch, cfg, device):
    """Random weights from seed 0, drawn on ``device``; logs the count."""
    from repro_torch.models.transformer import init_params
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    n = sum(t.numel() for st in [params] + [v for v in params.values()
                                            if isinstance(v, dict)]
            for t in st.values() if isinstance(t, torch.Tensor))
    log(f"{cfg.name}: {cfg.n_layers} layers (+{cfg.encoder_layers} encoder), "
        f"d_model {cfg.d_model}, {cfg.n_heads}->{cfg.padded_heads} query "
        f"heads over {cfg.n_kv_heads} KV heads, head_dim {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to "
        f"{cfg.padded_vocab}; {n / 1e9:.3f} B parameters "
        f"({cfg.param_count() / 1e9:.3f} B by param_count), drawn in "
        f"{time.monotonic() - t0:.1f} s")
    return params


def hold_rows(torch, name, lk, lp) -> float:
    """Kernel-path logits against plain-path logits, every row, within 4
    bf16 ulps of the largest logit (phase 5's rule); returns the error."""
    err = (lk.float() - lp.float()).abs().max().item()
    scale = lp.abs().max().item()
    tol = bf16_ulps(4, scale)
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"{name}: kernel vs plain logits max_abs_err {err:.4f} over "
        f"{lk.numel() // lk.shape[-1]} rows (max |logit| {scale:.3f}; tol "
        f"{tol:.4f} = 4 bf16 ulps), greedy agreement {agree:.4f}")
    if not bool(torch.isfinite(lk).all()) or err > tol:
        raise AssertionError(f"{name}: kernel path and plain path disagree")
    return err


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
        # the kernel writes cb's lower triangle only: the rest of its
        # buffer is never written, so it is selected away, not multiplied
        # (uninitialised bits may hold a NaN, and NaN x 0 is NaN)
        pairs = [("cb (lower triangle)", torch.where(tri, got["cb"], 0.0),
                  torch.where(tri, cb, 0.0)),
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

# ---------------------------------------------------------------------------
# phase 12: the MoE family
# ---------------------------------------------------------------------------

def routes_by_position(torch, cfg, routes):
    """What ``record_routing`` collected over one teacher-forced run (per
    chunk or step, one call per layer) → (layers, positions, k): the
    experts that computed each position in each layer, ascending, -1 for
    a choice dropped at capacity."""
    from repro_torch.models.layers import dispatched_experts
    L = cfg.n_layers
    sets = [dispatched_experts(cfg, idx) for idx in routes]
    return torch.stack([torch.cat(sets[l::L]) for l in range(L)])


def hold_routed(torch, name, lk, lp, rk, rp):
    """Kernel-path logits ``lk`` against plain-path ``lp`` (one row per
    position) at every position before the first where a routing choice
    differs between the two runs (``rk``/``rp``: (layers, positions, k),
    the experts that computed each position in each layer, ascending), to
    phase 5's rule: 4 bf16 ulps of the largest logit. Returns the number
    of differing (layer, position, k) choices."""
    if not rk.shape == rp.shape == (rk.shape[0], lk.shape[0], rk.shape[2]):
        raise AssertionError(f"{name}: routing does not cover the positions")
    diff = rk != rp
    n_diff = int(diff.sum())
    at = diff.any(-1).any(0).nonzero()
    first = int(at[0]) if len(at) else lk.shape[0]
    if first == 0:
        log(f"{name}: a routing choice differs at position 0: no position "
            f"to hold ({n_diff} differing (layer, position, k) choices)")
        return n_diff
    a, b = lk[:first], lp[:first]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    tol = bf16_ulps(4, scale)
    finite = bool(torch.isfinite(lk).all())
    after = (lk[first:] - lp[first:]).abs().max().item() \
        if first < lk.shape[0] else 0.0
    layers = diff.any(-1).any(-1).nonzero().flatten().tolist()
    log(f"{name}: kernel vs plain logits max_abs_err {err:.4f} over the "
        f"{first} of {lk.shape[0]} positions before the first routing "
        f"difference (max |logit| {scale:.3f}; tol {tol:.4f} = 4 bf16 "
        f"ulps); {n_diff} (layer, position, k) choices differ, in layers "
        f"{layers}, from position {first}; max |diff| at and after it "
        f"{after:.4f} (not held); greedy agreement "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f}")
    if not finite or err > tol:
        raise AssertionError(f"{name}: kernel path and plain path disagree")
    return n_diff


def hold_replayed(torch, name, lr, lp):
    """The kernel path run under the plain run's routing choices
    (``replay_routing``) against the plain run: every position held to
    phase 5's rule."""
    torch.cuda.synchronize()
    hold_rows(torch, f"{name}, the plain run's routing replayed in the "
              f"kernel path", lr, lp)


def moe_kernel_cases(torch, timer):
    """(a): both attention kernels at the MoE models' shapes — head_dim
    128, qwen3-moe's 64 query heads over 4 KV heads, and mixtral's 32
    over 8 with its 4096-token window binding — and a 64-token window."""
    g4 = [h // 16 for h in range(64)]
    g8 = [h // 4 for h in range(32)]
    check_paged(torch, timer, "qwen3-moe", paged_case(
        torch, B=8, H=64, KV=4, D=128, page=64, max_pages=32, P=289,
        lens=[2048, 1, 1537, 700, 64, 65, 1999, 333], qh2kv=None, seed=12),
        main=True)
    # one slot shorter than the window, one exactly at it
    check_paged(torch, timer, "mixtral-window4096", paged_case(
        torch, B=8, H=32, KV=8, D=128, page=64, max_pages=96, P=800,
        lens=[6144, 4097, 5000, 100, 4096, 6000, 1, 4500], qh2kv=None,
        seed=13), main=True, window=4096)
    check_paged(torch, timer, "mixtral-window64", paged_case(
        torch, B=8, H=32, KV=8, D=128, page=64, max_pages=32, P=289,
        lens=[2048, 65, 64, 63, 1, 700, 1537, 130], qh2kv=None, seed=14),
        main=False, window=64)
    check_prefill(torch, timer, "qwen3-moe", Sq=256, Sk=1536, q_offset=1280,
                  H=64, KV=4, D=128, qh2kv=g4, seed=15, main=True)
    check_prefill(torch, timer, "mixtral-window4096", Sq=256, Sk=6144,
                  q_offset=5888, H=32, KV=8, D=128, qh2kv=g8, seed=16,
                  main=True, window=4096)
    # the kernel's k_lo tile skip: most key tiles lie before every window
    check_prefill(torch, timer, "mixtral-window64", Sq=256, Sk=1536,
                  q_offset=1280, H=32, KV=8, D=128, qh2kv=g8, seed=17,
                  main=False, window=64)


def moe_params(torch, cfg, device):
    """Random weights from seed 0, drawn on ``device`` (a CPU draw of
    qwen3-moe's would hold ~35 GB of host memory)."""
    params = draw_params(torch, cfg, device)
    log(f"{cfg.name}: {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
        f"d_ff {cfg.moe.d_ff_expert}, capacity factor "
        f"{cfg.moe.capacity_factor}, window {cfg.sliding_window}")
    return params


def e2e_qwen3_moe(torch, device="cuda"):
    """(b): qwen3-moe-235b-a22b at full width (depth cut from 94 to 4
    layers) served by the launcher's body, its launches counted, and one
    request teacher-forced through the kernel and plain paths with every
    routing choice recorded. ``device="cpu"``: a rehearsal at the
    reduced width."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models.layers import (moe_capacity, plain_attention,
                                           record_routing, replay_routing)
    cfg = get_config("qwen3-moe-235b-a22b")
    if device != "cuda":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=4)
    params = moe_params(torch, cfg, device)
    log(f"capacity: {moe_capacity(cfg, 8)} of a decode step's 8 rows, "
        f"{moe_capacity(cfg, 256)} of a 256-token chunk's (mean "
        f"{256 * cfg.moe.top_k / cfg.moe.n_experts:.0f} an expert)")
    paged_attention.launches = 0
    flash_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    s = serve(cfg, device, params=params, requests=12, max_batch=8,
              max_new=16, admission="predictive", seed=0, log=log)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "flash_prefill": flash_prefill.launches}
    log(f"qwen3-moe e2e: {s['completed']}/{s['submitted']} requests "
        f"completed, {s['new_tokens']} tokens in {s['seconds']:.3f} s, decode "
        f"{s['decode_tok_s']:.2f} tok/s, TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} "
        f"ms, TBT p50 {s['tbt_p50_s'] * 1e3:.2f} ms p99 "
        f"{s['tbt_p99_s'] * 1e3:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"qwen3-moe e2e launches: paged_attention "
        f"{launches['paged_attention']} (= {cfg.n_layers} x "
        f"{s['paged_calls']} paged step calls), flash_prefill "
        f"{launches['flash_prefill']} (= {cfg.n_layers} x "
        f"{s['prefill_chunks']} prefill chunks)")
    if s["submitted"] != 8 or s["completed"] != s["submitted"]:
        raise AssertionError("qwen3-moe: not every request completed")
    if launches["paged_attention"] != cfg.n_layers * s["paged_calls"] \
            or launches["flash_prefill"] != cfg.n_layers * s["prefill_chunks"]:
        raise AssertionError("qwen3-moe: launches do not match layers x calls")
    if not (launches["paged_attention"] and launches["flash_prefill"]):
        raise AssertionError("qwen3-moe: a kernel of the path never launched")
    for rid, toks, mn, _ in s["payloads"]:
        out = s["outputs"][rid]
        if len(out) != mn or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"qwen3-moe request {rid}: bad stream {out}")

    rid, prompt, _, _ = s["payloads"][0]
    stream = s["outputs"][rid]
    with record_routing() as rk:
        lk = teacher_forced(torch, params, cfg, prompt, stream,
                            all_positions=True)
    with plain_attention(), record_routing() as rp:
        lp = teacher_forced(torch, params, cfg, prompt, stream,
                            all_positions=True)
    torch.cuda.synchronize()
    served = lk[len(prompt) - 1:].argmax(-1).cpu().tolist() == stream
    log(f"qwen3-moe teacher forcing (request {rid}, prompt {len(prompt)}, "
        f"{len(stream)} served tokens, {lk.shape[0]} positions): kernel "
        f"argmax == served stream: {served}")
    n_diff = hold_routed(torch, "qwen3-moe teacher forcing", lk, lp,
                         routes_by_position(torch, cfg, rk),
                         routes_by_position(torch, cfg, rp))
    with replay_routing(rp):
        lr = teacher_forced(torch, params, cfg, prompt, stream,
                            all_positions=True)
    hold_replayed(torch, "qwen3-moe teacher forcing", lr, lp)
    return dict(launches=launches, routing_differences=n_diff,
                completed=s["completed"])


def e2e_mixtral(torch, device="cuda", prompt_len=5120):
    """(c): mixtral-8x7b at full width (depth cut from 32 to 2 layers):
    ``prefill()`` of a prompt longer than the 4096-token window (the
    window binds in the prefill kernel), its KV staged into pages, and 16
    paged decode steps (the window binds in the paged kernel), kernel
    path against plain path; the logits at every prompt position come
    from one extend of the whole prompt over a linear cache (the same
    computation as ``prefill()``, which returns the last only).
    ``device="cpu"``: a rehearsal at the reduced width (a 64-token
    window, so a shorter ``prompt_len`` still passes it)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.models.layers import (plain_attention, record_routing,
                                           replay_routing)
    from repro_torch.models.transformer import (decode_step,
                                                decode_step_paged,
                                                init_caches, prefill)
    from repro_torch.serving.engine import stage_run
    from repro_torch.serving.paged_cache import DevicePagePool
    cfg = get_config("mixtral-8x7b")
    if device != "cuda":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=2)
    steps = 16
    params = moe_params(torch, cfg, device)
    prompt = np.random.default_rng(18).integers(0, cfg.vocab_size,
                                                prompt_len)
    t = torch.as_tensor(prompt[None].astype("int64"), device=device)

    def run(stream):
        first, c = prefill(params, t, cfg)
        lin = init_caches(cfg, 1, prompt_len, window=prompt_len,
                          device=device)       # linear: wider than the ring
        every, _ = decode_step(params, t, lin, cfg)
        rows = list(every[0])
        if (first[0] - rows[-1]).abs().max().item() > bf16_ulps(
                4, rows[-1].abs().max().item()):
            raise AssertionError("mixtral: prefill() and the extend differ")
        pp = DevicePagePool(cfg, n_pages=2 + -(-(prompt_len + steps) // 64),
                            page_tokens=64, device=device)
        pages = stage_run(pp, [], c.kv.k[:, 0], c.kv.v[:, 0], prompt_len)
        pages += pp.alloc(pp.pages_for(prompt_len + steps) - len(pages))
        table = torch.tensor([pages], dtype=torch.int32, device=device)
        tok = int(rows[-1].argmax())
        out = [tok]
        for i in range(steps):
            tk = torch.tensor([[stream[i] if stream else tok]],
                              dtype=torch.int64, device=device)
            lens = torch.tensor([prompt_len + i], dtype=torch.int32,
                                device=device)
            lg, _, _ = decode_step_paged(params, tk, pp.k_pages, pp.v_pages,
                                         table, lens, cfg)
            rows.append(lg[0, -1])
            tok = int(lg[0, -1].argmax())
            out.append(tok)
        return torch.stack(rows), out

    paged_attention.launches = 0
    flash_prefill.launches = 0
    with record_routing() as rk:
        lk, stream = run(None)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "flash_prefill": flash_prefill.launches}
    log(f"mixtral: prompt {prompt_len} tokens, window {cfg.sliding_window}, "
        f"{steps} paged steps; launches: flash_prefill "
        f"{launches['flash_prefill']} (= {cfg.n_layers} x 2: prefill() and "
        f"the extend), paged_attention {launches['paged_attention']} (= "
        f"{cfg.n_layers} x {steps})")
    if launches != {"paged_attention": cfg.n_layers * steps,
                    "flash_prefill": 2 * cfg.n_layers}:
        raise AssertionError("mixtral: launches do not match layers x calls")
    with plain_attention(), record_routing() as rp:
        lp, _ = run(stream)
    torch.cuda.synchronize()
    if paged_attention.launches != launches["paged_attention"] \
            or flash_prefill.launches != launches["flash_prefill"]:
        raise AssertionError("mixtral: the plain run launched a kernel")
    # routing: prefill() and the extend each route every prompt position
    # once a layer; the holding compares the extend's and the steps'
    L = cfg.n_layers
    same = all(torch.equal(a, b) for a, b in zip(rk[:L], rk[L:2 * L]))
    log(f"mixtral: prefill() and the extend route the prompt alike: {same}")
    ext_k = rk[L:]
    ext_p = rp[L:]
    n_diff = hold_routed(torch, "mixtral teacher forcing", lk, lp,
                         routes_by_position(torch, cfg, ext_k),
                         routes_by_position(torch, cfg, ext_p))
    with replay_routing(rp):
        lr, _ = run(stream)
    hold_replayed(torch, "mixtral teacher forcing", lr, lp)
    return dict(launches=launches, routing_differences=n_diff)



# ---------------------------------------------------------------------------
# phase 13: the remaining families
# ---------------------------------------------------------------------------

def family_kernel_cases(torch, timer) -> dict:
    """(a): the kernels at the new families' shapes, each timed with its
    bound, plain version and library call."""
    from repro_torch.models.layers import qh2kv_map
    whisper = qh2kv_map(20, 20, 32).tolist()
    qwen14 = qh2kv_map(40, 8, 48).tolist()
    grouped = qh2kv_map(48, 8, 48).tolist()
    out = {}
    out["flash_prefill whisper decoder"] = check_prefill(
        torch, timer, "whisper", Sq=64, Sk=64, q_offset=0, H=32, KV=20, D=64,
        qh2kv=whisper, seed=20, main=True)
    out["flash_prefill internvl2 prefill"] = check_prefill(
        torch, timer, "internvl2", Sq=512, Sk=512, q_offset=0, H=48, KV=8,
        D=128, qh2kv=grouped, seed=21, main=True)
    out["flash_prefill qwen3-14b chunk"] = check_prefill(
        torch, timer, "qwen3-14b", Sq=256, Sk=1536, q_offset=1280, H=48,
        KV=8, D=128, qh2kv=qwen14, seed=22, main=True)
    out["paged_attention qwen3-14b decode"] = check_paged(
        torch, timer, "qwen3-14b", paged_case(
            torch, B=8, H=48, KV=8, D=128, page=64, max_pages=32, P=289,
            lens=[1536, 1, 1100, 700, 64, 65, 1999, 333], qh2kv=qwen14,
            seed=23), main=True)
    out["ssd_scan jamba mixer"] = check_ssd(
        torch, timer, "jamba", b=1, s=1024, h=256, p=64, n=64, chunk=256,
        seed=24, main=True)
    return out


def greedy_run(torch, params, cfg, prompt, steps, stream=None, **kw):
    """``prefill`` of ``prompt`` (B, S) with the frontend input ``kw``,
    its caches copied into ones ``steps`` tokens longer, then ``steps``
    ``decode_step``s fed greedily (or ``stream``). Returns the logits of
    every sampled position (steps + 1, B, V) and the tokens fed
    (steps, B)."""
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                prefill)
    B = prompt.shape[0]
    first, c = prefill(params, prompt, cfg, **kw)
    n = c.length
    caches = init_caches(cfg, B, n + steps, enc_len=cfg.frontend_tokens
                         if cfg.encoder_layers else 0, device=prompt.device)
    caches.kv.k[:, :, :n] = c.kv.k
    caches.kv.v[:, :, :n] = c.kv.v
    caches = caches._replace(enc_kv=c.enc_kv, length=n)
    rows, fed = [first], []
    tok = first.argmax(-1)
    for i in range(steps):
        t = stream[i] if stream is not None else tok
        fed.append(t)
        lg, caches = decode_step(params, t[:, None], caches, cfg)
        rows.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1)
    return torch.stack(rows), torch.stack(fed)


def e2e_whisper(torch, device="cuda", steps=64, prompt_len=64, batch=4):
    """(b): whisper-large-v3 at full width and depth: ``prefill(frames=)``
    of four 1500-frame stub inputs and a 64-token decoder prompt, 64
    greedy ``decode_step``s, teacher-forced through the plain path."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.transformer import build_enc_kv, encode
    cfg = get_config("whisper-large-v3")
    if device != "cuda":
        cfg = cfg.reduced()
    if prompt_len + steps > cfg.max_decode_len:
        raise AssertionError("the run passes whisper's decoder cap")
    params = draw_params(torch, cfg, device)
    g = torch.Generator(device=device).manual_seed(19)
    frames = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                         generator=g, device=device).bfloat16()
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device=device)
    torch.cuda.reset_peak_memory_stats()
    flash_prefill.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    lk, fed = greedy_run(torch, params, cfg, prompt, steps, frames=frames)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = flash_prefill.launches
    t0 = time.monotonic()
    build_enc_kv(params, encode(params, frames, cfg), cfg)
    torch.cuda.synchronize()
    enc_s = time.monotonic() - t0
    log(f"whisper: {batch} x {cfg.frontend_tokens} frames, prompt "
        f"{prompt_len}, {steps} greedy steps in {run_s:.3f} s; the encoder "
        f"and the cross K/V alone {enc_s:.3f} s, {enc_s / run_s:.3f} of the "
        f"run; flash_prefill launches {launches} (= {cfg.n_layers} x (1 + "
        f"{steps})); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if device == "cuda" and launches != cfg.n_layers * (1 + steps):
        raise AssertionError("whisper: launches do not match layers x calls")
    with plain_attention():
        lp, _ = greedy_run(torch, params, cfg, prompt, steps, stream=fed,
                           frames=frames)
    torch.cuda.synchronize()
    err = hold_rows(torch, "whisper teacher forcing", lk, lp)
    return dict(launches=launches, err=err, encoder_share=enc_s / run_s)


def e2e_internvl2(torch, device="cuda", steps=16, prompt_len=256):
    """(c): internvl2-26b at full width and depth: ``prefill(patches=)``
    of 256 stub patches and a 256-token prompt, 16 greedy dense
    ``decode_step``s, teacher-forced through the plain path."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.models.layers import plain_attention
    cfg = get_config("internvl2-26b")
    if device != "cuda":
        cfg = cfg.reduced()
    params = draw_params(torch, cfg, device)
    g = torch.Generator(device=device).manual_seed(25)
    patches = torch.randn((1, cfg.frontend_tokens, cfg.d_model), generator=g,
                          device=device).bfloat16()
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=g,
                           device=device)
    torch.cuda.reset_peak_memory_stats()
    flash_prefill.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    lk, fed = greedy_run(torch, params, cfg, prompt, steps, patches=patches)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = flash_prefill.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"internvl2: {cfg.frontend_tokens} patches + {prompt_len} tokens, "
        f"{steps} greedy steps in {run_s:.3f} s; flash_prefill launches "
        f"{launches} (= {cfg.n_layers} x (1 + {steps})); "
        f"max_memory_allocated {peak:.2f} GiB")
    if device == "cuda" and launches != cfg.n_layers * (1 + steps):
        raise AssertionError("internvl2: launches do not match layers x "
                             "calls")
    with plain_attention():
        lp, _ = greedy_run(torch, params, cfg, prompt, steps, stream=fed,
                           patches=patches)
    torch.cuda.synchronize()
    err = hold_rows(torch, "internvl2 teacher forcing", lk, lp)
    return dict(launches=launches, err=err, peak_gib=peak)


def serve_dense(torch, arch, device="cuda"):
    """``arch`` at full width and depth (``.reduced()`` off the card)
    served by the launcher's body with phase 5's workload, both kernels'
    launches counted from zero (= layers x paged calls and layers x
    prefill chunks, both non-zero), one request teacher-forced through
    the kernel and plain paths within 4 bf16 ulps (phase 5's rule)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models.layers import plain_attention
    cfg = get_config(arch)
    if device != "cuda":
        cfg = cfg.reduced()
    params = draw_params(torch, cfg, device)
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    flash_prefill.launches = 0
    s = serve(cfg, device, params=params, requests=12, max_batch=8,
              max_new=16, admission="predictive", seed=0, log=log)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "flash_prefill": flash_prefill.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{arch} e2e: {s['completed']}/{s['submitted']} requests "
        f"completed, {s['new_tokens']} tokens in {s['seconds']:.3f} s, decode "
        f"{s['decode_tok_s']:.2f} tok/s, TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} "
        f"ms, TBT p50 {s['tbt_p50_s'] * 1e3:.2f} ms p99 "
        f"{s['tbt_p99_s'] * 1e3:.2f} ms; max_memory_allocated {peak:.2f} GiB")
    log(f"{arch} e2e launches: paged_attention "
        f"{launches['paged_attention']} (= {cfg.n_layers} x "
        f"{s['paged_calls']} paged step calls), flash_prefill "
        f"{launches['flash_prefill']} (= {cfg.n_layers} x "
        f"{s['prefill_chunks']} prefill chunks)")
    if s["submitted"] != 8 or s["completed"] != s["submitted"]:
        raise AssertionError(f"{arch}: not every request completed")
    if device == "cuda" and (
            launches["paged_attention"] != cfg.n_layers * s["paged_calls"]
            or launches["flash_prefill"]
            != cfg.n_layers * s["prefill_chunks"]
            or not (launches["paged_attention"]
                    and launches["flash_prefill"])):
        raise AssertionError(f"{arch}: launches do not match layers x "
                             f"calls")
    # the greedy sampler ranges over the padded vocabulary, as the
    # reference's does (``argmax`` over the unembedding's padded_vocab
    # columns, random weights in the padding rows too): phi3-mini's 32,064
    # pad to 32,256, qwen2.5-3b's and qwen3-14b's 151,936 to 152,064
    pad_ids = 0
    for rid, toks, mn, _ in s["payloads"]:
        out = s["outputs"][rid]
        if len(out) != mn or not all(0 <= t < cfg.padded_vocab for t in out):
            raise AssertionError(f"{arch} request {rid}: bad stream {out}")
        pad_ids += sum(t >= cfg.vocab_size for t in out)
    log(f"{arch}: {pad_ids} of {s['new_tokens']} served tokens are padding "
        f"ids (>= vocab_size {cfg.vocab_size}, < padded_vocab "
        f"{cfg.padded_vocab})")
    rid, prompt, _, _ = s["payloads"][0]
    stream = s["outputs"][rid]
    lk = teacher_forced(torch, params, cfg, prompt, stream)
    with plain_attention():
        lp = teacher_forced(torch, params, cfg, prompt, stream)
    torch.cuda.synchronize()
    served = lk.argmax(-1).cpu().tolist() == stream
    log(f"{arch} teacher forcing (request {rid}, prompt {len(prompt)}): "
        f"kernel argmax == served stream: {served}")
    err = hold_rows(torch, f"{arch} teacher forcing", lk, lp)
    return dict(launches=launches, summary=s, peak_gib=peak, err=err)


class kernels_as_plain_versions:
    """Inside, the model calls each kernel's own plain version in its
    place — ``flash_prefill_ref`` (fp32 probabilities, as the kernel
    keeps them) for the prefill kernel and ``ssd_chunked`` for the SSD
    scan — where ``plain_attention()`` gives the reference model's plain
    numerics (``_attend`` rounds the probabilities to bf16). Holds a
    kernel-path run against the same function on the same inputs."""

    def __enter__(self):
        import repro_torch.models.layers as L
        import repro_torch.models.mamba as M
        from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
        from repro_torch.kernels.ssd_scan.ref import ssd_chunked
        self.saved = (L.flash_prefill_attention, M.ssd_scan_op)
        L.flash_prefill_attention = flash_prefill_ref
        M.ssd_scan_op = lambda x, dt, A, B, C, h0=None, *, chunk=256: \
            ssd_chunked(x, dt, A, B, C, chunk, h0=h0)
        return self

    def __exit__(self, *exc):
        import repro_torch.models.layers as L
        import repro_torch.models.mamba as M
        L.flash_prefill_attention, M.ssd_scan_op = self.saved


def e2e_jamba(torch, device="cuda", prompt_len=200, steps=16):
    """(e): jamba-1.5-large-398b's period stack at ``.reduced()`` widths
    on the card (one full-width period does not fit it): ``prefill()``, an
    extend of the whole prompt from empty caches (every position's
    logits) and 16 ``decode_step``s on its KV and states. The plain path
    runs first with its MoE routing recorded; the kernels' plain versions
    and the kernel path then run under that routing. Every position of
    the kernel path is held against both plain runs within the distance
    between the two plain runs (the stack's response to one attention
    layer's rounding) plus 4 bf16 ulps."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.models.layers import (plain_attention, record_routing,
                                           replay_routing)
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                prefill)
    cfg = get_config("jamba-1.5-large-398b").reduced()
    params = draw_params(torch, cfg, device)
    prompt = np.random.default_rng(26).integers(0, cfg.vocab_size,
                                                prompt_len)
    t = torch.as_tensor(prompt[None].astype("int64"), device=device)

    def run(stream):
        first, _ = prefill(params, t, cfg)
        caches = init_caches(cfg, 1, prompt_len + steps, device=device)
        every, caches = decode_step(params, t, caches, cfg)
        rows = list(every[0])
        if (first[0] - rows[-1]).abs().max().item() > bf16_ulps(
                4, rows[-1].abs().max().item()):
            raise AssertionError("jamba: prefill() and the extend differ")
        tok, fed = int(rows[-1].argmax()), []
        for i in range(steps):
            tk = stream[i] if stream is not None else tok
            fed.append(tk)
            lg, caches = decode_step(params, torch.tensor(
                [[tk]], dtype=torch.int64, device=device), caches, cfg)
            rows.append(lg[0, -1])
            tok = int(lg[0, -1].argmax())
        return torch.stack(rows), fed

    with plain_attention(), record_routing() as routes:
        lp, fed = run(None)
    with kernels_as_plain_versions(), replay_routing(routes):
        lv, _ = run(fed)
    flash_prefill.launches = 0
    ssd_scan.launches = 0
    with replay_routing(routes):
        lk, _ = run(fed)
    torch.cuda.synchronize()
    launches = {"flash_prefill": flash_prefill.launches,
                "ssd_scan": ssd_scan.launches}
    n_mamba = cfg.n_layers - cfg.attention_layers
    log(f"jamba (reduced, {cfg.n_layers} layers: 1 attention, {n_mamba} "
        f"Mamba2, 4 MoE FFNs): prompt {prompt_len}, {steps} steps; "
        f"launches: flash_prefill {launches['flash_prefill']} (= "
        f"{cfg.attention_layers} x (2 + {steps})), ssd_scan "
        f"{launches['ssd_scan']} (= {n_mamba} x 2: prefill() and the extend; "
        f"a one-token step takes the recurrence); {len(routes)} MoE calls "
        f"replayed")
    if device == "cuda" and launches != {
            "flash_prefill": cfg.attention_layers * (2 + steps),
            "ssd_scan": 2 * n_mamba}:
        raise AssertionError("jamba: launches do not match layers x calls")
    # the stack's own response to rounding: the two plain runs differ
    # only in how one attention layer rounds its probabilities (its
    # output by at most about a bf16 ulp), and seven Mamba2 mixers and
    # four MoE FFNs at this width carry that to every position
    scale = lp.abs().max().item()
    spread = (lv - lp).abs().max().item()
    tol = spread + bf16_ulps(4, scale)
    err_v = (lk - lv).abs().max().item()
    err = (lk - lp).abs().max().item()
    log(f"jamba, every position, the plain run's routing replayed: the "
        f"kernels' plain versions vs the plain path {spread:.4f} (the "
        f"stack's response to the attention's probability rounding); the "
        f"kernel path vs the kernels' plain versions {err_v:.4f}, vs the "
        f"plain path {err:.4f} (max |logit| {scale:.3f}; tol {tol:.4f} = "
        f"that response + 4 bf16 ulps); greedy agreement with the plain "
        f"path {(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.4f}")
    if not bool(torch.isfinite(lk).all()) or max(err, err_v) > tol:
        raise AssertionError("jamba: the kernel path and the plain path "
                             "disagree")
    return dict(launches=launches, err=err, spread=spread)

# ---------------------------------------------------------------------------
# phase 14: the multi-device serving paths, every position on one card
# ---------------------------------------------------------------------------

def card_mesh(torch, shape, axes, device="cuda"):
    """A mesh whose every position names ``device`` (the card has one
    GPU; ``make_decode_mesh`` would refuse to stack positions)."""
    import numpy as np
    from repro_torch.launch.mesh import Mesh
    n = int(np.prod(shape))
    return Mesh(np.asarray([torch.device(device)] * n,
                           dtype=object).reshape(shape), axes)


def llama_cut(torch, device="cuda"):
    """llama2-70b at full width, depth cut to 8 of 80 layers (80 are
    ~141 GB of bf16); ``device="cpu"``: the reduced width, its heads
    made grouped GQA (16 over 4) so they stripe over a model axis."""
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config("llama2-70b")
    if device != "cuda":
        cfg = dataclasses.replace(cfg.reduced(), n_heads=16, n_kv_heads=4)
    cfg = dataclasses.replace(cfg, n_layers=8)
    return cfg, draw_params(torch, cfg, device)


def check_sharded_op(torch, timer, *, H=64, KV=8, D=128, seed=14,
                     lens=(1, 2048, 1536, 64, 65, 700, 1537, 333)) -> dict:
    """(a): ``paged_decode_attention_sharded`` on a (2, 2) mesh over the
    card at llama2-70b's decode shape (or H query heads over KV at head
    dim D): bitwise the unsharded kernel with its split count pinned,
    within 2e-2 of the plain version; timed beside the unsharded
    kernel."""
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ops import (
        grouped_map, paged_decode_attention_sharded)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    lens = list(lens)
    q, kp, vp, table, lens_t, _ = paged_case(
        torch, B=8, H=H, KV=KV, D=D, page=64, max_pages=32, P=257,
        lens=lens, qh2kv=None, seed=seed)
    mk = grouped_map(H, KV, q.device)
    mesh = card_mesh(torch, (2, 2), ("data", "model"))
    whole = paged_attention(q, kp, vp, table, lens_t, mk)
    splits = paged_attention.last_splits
    got = paged_decode_attention_sharded(q, kp, vp, table, lens_t, mesh=mesh,
                                         n_splits=splits)
    own = paged_decode_attention_sharded(q, kp, vp, table, lens_t, mesh=mesh)
    shard_splits = paged_attention.last_splits
    ref = paged_attention_ref(q, kp, vp, table, lens_t)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(got, whole))
    err = (got.float() - ref.float()).abs().max().item()
    err_own = (own.float() - ref.float()).abs().max().item()
    ms = timer.ms(lambda: paged_decode_attention_sharded(
        q, kp, vp, table, lens_t, mesh=mesh))
    whole_ms = timer.ms(lambda: paged_attention(q, kp, vp, table, lens_t, mk))
    log(f"sharded op (2x2 on the card, B=8 H={H} KV={KV} D={D}, lens "
        f"{lens}): pinned to the unsharded {splits} splits bitwise == unsharded "
        f"kernel: {bitwise}; max_abs_err vs plain {err:.3e} (each shard's "
        f"own choice, {shard_splits} splits: {err_own:.3e}; tol {TOL}); "
        f"sharded op {ms:.4f} ms (4 launches + stripe copies) vs the "
        f"unsharded kernel {whole_ms:.4f} ms")
    if not bitwise or max(err, err_own) > TOL:
        raise AssertionError("the sharded paged op disagrees")
    return dict(ms=ms, whole_ms=whole_ms, err=err, splits=splits)


def mesh_engine_run(torch, params, cfg, prompts, dm, max_new, device):
    """Prefill -> banked pool -> DecodeWorker on mesh ``dm`` (None:
    unmeshed). Returns streams, per-request logits rows, step times and
    the launches of the run."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                            PrefillWorker)
    from repro_torch.serving.paged_cache import DevicePagePool
    from repro_torch.serving.request import ServingRequest
    mesh = None if dm is None else card_mesh(torch, dm, ("data", "model"),
                                             device)
    pp = DevicePagePool(cfg, n_pages=80, mesh=mesh, device=device)
    pool = HostKVPool()
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=256, page_pool=pp)
    dw = DecodeWorker(params, cfg, max_batch=4, max_len=1024, page_pool=pp)
    rows: dict = {}
    call = dw._paged_call

    def recorded(*a):
        lg = call(*a)
        for i, s in enumerate(dw.slots):
            if s is not None:
                rows.setdefault(s.req_id, []).append(lg[i, -1].float())
        return lg

    dw._paged_call = recorded
    paged_attention.launches = 0
    flash_prefill.launches = 0
    press = [pw(t) for t in prompts]
    outs = {}
    # the fan-out first: one result in two slots (shared tail -> COW)
    for rid, i in [(2, 2), (3, 2), (0, 0), (1, 1)]:
        dw.join(ServingRequest(req_id=rid, tokens=None, max_new=max_new),
                press[i])
        outs[rid] = [press[i].first_token]
    steps = []
    while dw.n_active:
        t0 = time.monotonic()
        got = dw.step()                 # ends in a device-to-host copy
        steps.append(time.monotonic() - t0)
        for rid, tok, _ in got:
            outs[rid].append(tok)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "flash_prefill": flash_prefill.launches}
    st = pp.stats()
    pp.check_leaks()
    pool.close()
    n_pos = 1 if dm is None else dm[0] * dm[1]
    if device == "cuda" and (
            launches["paged_attention"]
            != n_pos * cfg.n_layers * dw.counters["steps"]
            or not launches["flash_prefill"]):
        raise AssertionError(f"mesh {dm}: launches {launches} do not match "
                             f"{n_pos} positions x {cfg.n_layers} layers x "
                             f"{dw.counters['steps']} steps")
    if st["cow_copies"] < 1:
        raise AssertionError(f"mesh {dm}: no copy-on-write ran")
    return dict(outs=outs, rows={r: torch.stack(v) for r, v in rows.items()},
                steps=steps, launches=launches, decode=dw.stats(), pages=st)


def e2e_mesh(torch, params, cfg, device="cuda") -> dict:
    """(b): the engine on meshes (1,1), (2,1), (1,2), (2,2) over the
    card, each held against the unmeshed run by phase 5's rule; the
    launcher's body on ``make_decode_mesh(1, 1)``; the refusal of a
    2x2 mesh on a one-GPU host."""
    import numpy as np
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.launch.mesh import make_decode_mesh
    from repro_torch.launch.serve import serve
    rng = np.random.default_rng(14)
    common = rng.integers(0, cfg.vocab_size, 512)     # one shared block
    prompts = [np.concatenate([common, rng.integers(0, cfg.vocab_size,
                                                    88 + 37 * r)])
               for r in range(3)]
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    base = mesh_engine_run(torch, params, cfg, prompts, None, 16, device)
    out = {"unmeshed": base}
    for dm in [(1, 1), (2, 1), (1, 2), (2, 2)]:
        r = mesh_engine_run(torch, params, cfg, prompts, dm, 16, device)
        name = f"{dm[0]}x{dm[1]}"
        same = r["outs"] == base["outs"]
        err = max((r["rows"][k] - base["rows"][k]).abs().max().item()
                  for k in base["rows"])
        scale = max(v.abs().max().item() for v in base["rows"].values())
        tol = bf16_ulps(4, scale)
        log(f"mesh {name}: streams == unmeshed: {same}; logits max_abs_err "
            f"{err:.4f} (max |logit| {scale:.3f}; tol {tol:.4f} = 4 bf16 "
            f"ulps); zero-copy/staged joins {r['decode']['zero_copy_joins']}"
            f"/{r['decode']['staged_joins']}, COW {r['pages']['cow_copies']}"
            f"; launches {r['launches']}; decode step median "
            f"{1e3 * float(np.median(r['steps'][1:])):.2f} ms (unmeshed "
            f"{1e3 * float(np.median(base['steps'][1:])):.2f} ms)")
        if not same or err > tol:
            raise AssertionError(f"mesh {name}: streams differ from the "
                                 f"unmeshed run")
        out[name] = r
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"mesh runs: max_memory_allocated {peak:.2f} GiB, {before:.2f} GiB "
        f"of it allocated before the first run (the weights)")
    paged_attention.launches = 0
    flash_prefill.launches = 0
    s = serve(cfg, device, params=params, requests=12, max_batch=8,
              max_new=16, mesh=make_decode_mesh(1, 1, device=device),
              log=log)
    torch.cuda.synchronize()
    launches = {"paged_attention": paged_attention.launches,
                "flash_prefill": flash_prefill.launches}
    log(f"serve --mesh 1x1: {s['completed']}/{s['submitted']} requests, "
        f"TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} ms, TBT p50 "
        f"{s['tbt_p50_s'] * 1e3:.2f} ms p99 {s['tbt_p99_s'] * 1e3:.2f} ms; "
        f"launches {launches} ({cfg.n_layers} x {s['paged_calls']} paged "
        f"calls, {cfg.n_layers} x {s['prefill_chunks']} chunks)")
    if s["submitted"] != 8 or s["completed"] != 8:
        raise AssertionError("serve --mesh 1x1: not every request completed")
    if device == "cuda" and (
            launches["paged_attention"] != cfg.n_layers * s["paged_calls"]
            or launches["flash_prefill"]
            != cfg.n_layers * s["prefill_chunks"]):
        raise AssertionError("serve --mesh 1x1: launches do not match")
    if torch.cuda.device_count() < 4:
        try:
            make_decode_mesh(2, 2)
        except RuntimeError as e:
            log(f"make_decode_mesh(2, 2) on this host: {e}")
        else:
            raise AssertionError("make_decode_mesh(2, 2) stacked positions")
    out.update(serve=s, serve_launches=launches, peak_gib=peak)
    return out


def e2e_cpp(torch, params, cfg, device="cuda", prompt_len=8192,
            chunk=1024) -> dict:
    """(c): CPP over 4 stages of 2 layers on the card, one 8,192-token
    prompt in 1,024-token chunks, against ``cpp_reference`` (the full
    prefill)."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.serving.cpp import cpp_prefill, cpp_reference
    g = torch.Generator().manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                         generator=g).to(device)
    mesh = card_mesh(torch, (4,), ("stage",), device)
    cpp_prefill(params, toks[:, :2 * chunk], cfg, mesh, prefill_chunk=chunk)
    cpp_reference(params, toks[:, :2 * chunk], cfg)      # warm both paths
    torch.cuda.synchronize()
    flash_prefill.launches = 0
    t0 = time.monotonic()
    lc, (kc, vc) = cpp_prefill(params, toks, cfg, mesh, prefill_chunk=chunk)
    torch.cuda.synchronize()
    cpp_s = time.monotonic() - t0
    launches = flash_prefill.launches
    micro = len(cpp_prefill.last_schedule)
    t0 = time.monotonic()
    lr, (kr, vr) = cpp_reference(params, toks, cfg)
    torch.cuda.synchronize()
    ref_s = time.monotonic() - t0
    C, X = prompt_len // chunk, 4
    err = (lc - lr).abs().max().item()
    scale = lr.abs().max().item()
    tol = bf16_ulps(4, scale)
    kerr = max((torch.cat(a).float() - b.float()).abs().max().item()
               / b.abs().max().item() for a, b in ((kc, kr), (vc, vr)))
    log(f"cpp: {X} stages x {cfg.n_layers // X} layers, a {prompt_len}-token "
        f"prompt in {C} chunks of {chunk}: {micro} microsteps, "
        f"flash_prefill launches {launches} (= {cfg.n_layers} layers x {C} "
        f"chunks); wall {cpp_s * 1e3:.1f} ms against the full prefill's "
        f"{ref_s * 1e3:.1f} ms; logits max_abs_err {err:.4f} (max |logit| "
        f"{scale:.3f}; tol {tol:.4f} = 4 bf16 ulps), KV max_abs_err "
        f"{kerr:.4f} of its scale (tol {TOL})")
    if micro != C + X - 1 or (device == "cuda"
                              and launches != cfg.n_layers * C):
        raise AssertionError("cpp: wrong schedule or launches")
    if not bool(torch.isfinite(lc).all()) or err > tol or kerr > TOL:
        raise AssertionError("cpp disagrees with the full prefill")
    return dict(launches=launches, microsteps=micro, cpp_s=cpp_s,
                ref_s=ref_s, err=err, kv_err=kerr)


# ---------------------------------------------------------------------------
# phase 15: training on the card
# ---------------------------------------------------------------------------

def kernel_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention, paged_attention_layers)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    return {f.__name__: f.launches for f in (
        paged_attention, paged_attention_layers, flash_prefill, ssd_scan)}


def zero_kernel_counts() -> None:
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention, paged_attention_layers)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    for f in (paged_attention, paged_attention_layers, flash_prefill,
              ssd_scan):
        f.launches = 0


def no_kernel_launched(what: str) -> None:
    counts = kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"{what} launched a forward-only kernel: "
                             f"{counts}")


def train_card_vs_cpu(torch, device="cuda") -> dict:
    """(a): one train step's loss and gradients of smollm-360m.reduced()
    on the card against the same step on the CPU, same weights and
    batch: the loss within 2e-3 relative, each gradient leaf within 2e-2
    of its largest magnitude, no kernel launched."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.transformer import init_params
    from repro_torch.training.loop import batch_to
    from repro_torch.training.optim import tree_leaves, tree_map
    cfg = get_config("smollm-360m").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(device), cpu)
    nb = SyntheticLM(batch_spec_for(cfg, 4, 256), seed=0).batch(0)
    l_card, g_card = loss_and_grads(card, batch_to(nb, device), cfg)
    l_cpu, g_cpu = loss_and_grads(cpu, batch_to(nb, "cpu"), cfg)
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    worst = max(float((a.cpu().float() - b.float()).abs().max()
                      / b.float().abs().max().clamp(min=1e-30))
                for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)))
    log(f"(a) {cfg.name}, 4 x 256 tokens: loss card {float(l_card):.5f} cpu "
        f"{float(l_cpu):.5f} (rel {rel:.2e}, tol 2e-3); gradients: worst "
        f"leaf {worst:.3e} of its max-abs (tol {TOL})")
    no_kernel_launched("(a)")
    if not math.isfinite(float(l_card)) or rel > 2e-3 or worst > TOL:
        raise AssertionError("(a) the card's train step disagrees with "
                             "the CPU's")
    return dict(loss_rel=rel, grad_err=worst)


def train_smollm(torch, device="cuda") -> tuple:
    """(b): ``python -m repro_torch.launch.train --arch smollm-360m
    --steps 60 --batch 8 --seq 512`` (full width and depth, AdamW, remat
    on) through the launcher's body; every loss finite and the mean of
    the last 10 below that of the first 10."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.transformer import param_count_exact
    cfg = get_config("smollm-360m")
    assert cfg.remat and cfg.optimizer == "adamw"
    torch.cuda.reset_peak_memory_stats()
    res = train_launcher.run(["--arch", "smollm-360m", "--steps", "60",
                              "--batch", "8", "--seq", "512",
                              "--device", device])
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = (sum(res.losses[:10]) / 10, sum(res.losses[-10:]) / 10)
    n = param_count_exact(res.params)
    steady = sorted(res.step_s[5:])[len(res.step_s[5:]) // 2]
    log(f"(b) {cfg.name}: {n / 1e6:.1f}M parameters, 60 steps of 8 x 512 "
        f"tokens; loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} (first "
        f"10 mean {first:.3f}, last 10 mean {last:.3f}); {res.wall_s:.1f} s "
        f"in all, {res.tokens_per_s:.0f} tok/s over the run; median step "
        f"after the fifth {steady * 1e3:.1f} ms = {4096 / steady:.0f} tok/s; "
        f"model-FLOP share (6 N tokens / time / 989 TFLOP/s) "
        f"{6 * n * 4096 / steady / BF16_FLOP_S:.3f}; peak memory "
        f"{peak:.2f} GB")
    no_kernel_launched("(b)")
    if not all(math.isfinite(x) for x in res.losses) or not last < first:
        raise AssertionError("(b) smollm-360m's training did not descend")
    return cfg, res, dict(peak_gb=peak, params=n, step_ms=steady * 1e3,
                          tok_s=4096 / steady, first=first, last=last,
                          run_tok_s=res.tokens_per_s)


def train_e2e_card(torch, device="cuda") -> dict:
    """(c): ``launch/train_e2e.py``'s smollm-100m, 300 steps of 4 x 256
    tokens with checkpoints at 100, 200 and 300, then the 20-step resume:
    it starts at step 300 with the saved optimizer step, its first loss
    lies within the last 10 pre-save losses' range of their mean, and
    the step-300 checkpoint reads back bit for bit."""
    import shutil
    from repro_torch.launch import train_e2e
    from repro_torch.training.checkpoint import load_checkpoint
    from repro_torch.training.optim import tree_leaves
    d = os.path.join(ROOT, "build", "train-e2e")
    shutil.rmtree(d, ignore_errors=True)
    try:
        res, res2 = train_e2e.run(steps=300, batch=4, seq=256, ckpt=d,
                                  device=device)
        saved = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        back = load_checkpoint(d, res.params, res.opt_state)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    p, st, step = back
    exact = step == 300 and all(
        torch.equal(a, b) for a, b in zip(
            list(tree_leaves(p)) + list(tree_leaves(st.m))
            + list(tree_leaves(st.v)) + [st.step],
            list(tree_leaves(res.params)) + list(tree_leaves(res.opt_state.m))
            + list(tree_leaves(res.opt_state.v)) + [res.opt_state.step]))
    last10 = res.losses[-10:]
    mean, spread = sum(last10) / 10, max(last10) - min(last10)
    steady = sorted(res.step_s[5:])[len(res.step_s[5:]) // 2]
    log(f"(c) smollm-100m: loss {sum(res.losses[:10]) / 10:.3f} -> "
        f"{mean:.3f} (first/last 10 means), {res.tokens_per_s:.0f} tok/s "
        f"over the run, median step {steady * 1e3:.1f} ms; checkpoints "
        f"{saved}; resumed at step {int(res2.opt_state.step) - res2.steps} "
        f"(optimizer step {int(res2.opt_state.step)} after {res2.steps}), "
        f"first loss {res2.losses[0]:.4f} against the last 10's mean "
        f"{mean:.4f} +- range {spread:.4f}; checkpoint read back bit for "
        f"bit: {exact}")
    no_kernel_launched("(c)")
    if saved != [f"ckpt_{s:08d}.npz" for s in (100, 200, 300)] \
            or int(res2.opt_state.step) != 320 or not exact \
            or abs(res2.losses[0] - mean) > spread:
        raise AssertionError("(c) the checkpoint and resume failed")
    return dict(first=sum(res.losses[:10]) / 10, last=mean,
                resumed=res2.losses[0], spread=spread,
                tok_s=res.tokens_per_s, step_ms=steady * 1e3)


def train_llama_adafactor(torch, device="cuda") -> dict:
    """(d): llama2-70b at full width, 4 of 80 layers (80 are ~69 B
    parameters; 4 are 3.95 B, ~7.9 GB each of bf16 params, grads and
    Adafactor m), one 4096-token sequence (the reference's train_4k
    length), remat on, 3 steps: every loss finite, every leaf's first
    moment non-zero, every leaf drawn at random changed in bf16 (the
    norm weights start at 1.0, where one bf16 ulp is 0.0078 and 3
    warm-up steps at lr ≤ 4e-5 move them by ~1e-5), every matrix leaf's
    second moment factored."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params, param_count_exact
    from repro_torch.training.loop import train
    from repro_torch.training.optim import tree_leaves
    cfg = dataclasses.replace(get_config("llama2-70b"), n_layers=4)
    assert cfg.optimizer == "adafactor" and cfg.remat
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, steps=3, batch=1, seq=4096, seed=0, log_every=1,
                device=device)
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = res.opt_state
    n = param_count_exact(res.params)
    init = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
    leaves = list(zip(tree_leaves(init), tree_leaves(res.params),
                      tree_leaves(st.m), tree_leaves(st.v)))
    random = [(a, b) for a, b, _, _ in leaves
              if float(a.float().std()) > 0]
    moved = all(not torch.equal(a, b) for a, b in random)
    constant_moved = sum(not torch.equal(a, b) for a, b, _, _ in leaves) \
        - sum(not torch.equal(a, b) for a, b in random)
    m_live = all(bool(m.float().abs().max() > 0) for _, _, m, _ in leaves)
    factored = all(isinstance(v, tuple) == (p.dim() >= 2)
                   for p, _, _, v in leaves)
    del init
    log(f"(d) llama2-70b, 4 of 80 layers ({n / 1e9:.3f} B parameters), "
        f"Adafactor, remat, 1 x 4096 tokens: losses "
        f"{[round(x, 4) for x in res.losses]}, step times "
        f"{[round(x, 3) for x in res.step_s]} s, peak memory {peak:.2f} GB; "
        f"{len(random)} random leaves all moved: {moved}; constant (norm) "
        f"leaves moved: {constant_moved} of {len(leaves) - len(random)}; "
        f"every m non-zero: {m_live}; matrix leaves' v factored: {factored}")
    no_kernel_launched("(d)")
    if not all(math.isfinite(x) for x in res.losses) or not moved \
            or not m_live or not factored:
        raise AssertionError("(d) the Adafactor steps failed a gate")
    return dict(params=n, step_s=res.step_s, peak_gb=peak,
                losses=res.losses)


def profile_train(torch, cfg, res, device="cuda") -> dict:
    """(e): one train step of (b)'s model under ``torch.profiler``
    (``python -m repro_torch.launch.profile --train``'s report) on (b)'s
    trained weights, and the plain attention's share of it."""
    from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
    from repro_torch.launch.profile import profile_train_step
    from repro_torch.models.transformer import param_count_exact
    from repro_torch.training.loop import batch_to
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 8, 512)).batch(0),
                     device)
    r = profile_train_step(cfg, res.params, res.opt_state, batch)
    wall_s = r["wall_us"] / 1e6
    n = param_count_exact(res.params)
    r.update(tok_s=4096 / wall_s,
             mfu=6 * n * 4096 / wall_s / BF16_FLOP_S,
             idle=1 - r["busy_us"] / r["wall_us"])
    log(f"(e) one step: wall {wall_s * 1e3:.1f} ms = {r['tok_s']:.0f} tok/s, "
        f"model-FLOP share {r['mfu']:.3f}; device busy "
        f"{r['busy_us'] / 1e3:.1f} ms, idle share {r['idle']:.3f}, "
        f"{r['launches']:.0f} kernels a step; plain attention "
        f"{r['attention_share']:.3f} of the busy time")
    no_kernel_launched("(e)")
    return r


def e2e_training(torch, device="cuda") -> dict:
    """Phase 15: (a)-(e), every kernel's launch count held at zero."""
    zero_kernel_counts()
    t0 = time.monotonic()
    out = dict(card_vs_cpu=train_card_vs_cpu(torch, device))
    cfg, res, out["smollm"] = train_smollm(torch, device)
    out["profile"] = profile_train(torch, cfg, res, device)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out["e2e"] = train_e2e_card(torch, device)
    gc.collect()
    torch.cuda.empty_cache()
    out["llama"] = train_llama_adafactor(torch, device)
    no_kernel_launched("phase 15")
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------------------
# phase 16: head dim 96 — phi3-mini-3.8b, and qwen2.5-3b
# ---------------------------------------------------------------------------

# the launcher's decode batch: phase 5's workload, prompts capped at 1536
PHI3_DEPTHS = [1536, 1536, 1536, 436, 1536, 1536, 428, 1536]


def head_dim_96_cases(torch, timer) -> dict:
    """(a): both kernels at head_dim 96 against their plain versions —
    phi3-mini's MHA (32 query heads over 32 KV heads) at its decode and
    prefill shapes, timed beside the bound, plain version and SDPA; a
    grouped map, windows, forced splits, ragged tails, and the layers
    entry over 32 layers."""
    mha = list(range(32))
    g4 = [h // 4 for h in range(16)]
    out = {}
    phi3 = dict(B=8, H=32, KV=32, D=96, page=64, max_pages=24, P=193)
    out["paged_attention phi3-mini decode"] = check_paged(
        torch, timer, "phi3-mini", paged_case(
            torch, lens=PHI3_DEPTHS, qh2kv=mha, seed=30, **phi3), main=True)
    # 1- and 65-token slots: most blocks of their clusters hold no token
    edges = [1536, 1, 1536, 436, 65, 1536, 428, 1536]
    for ns in (1, 2, 4, 8):
        check_paged(torch, timer, f"phi3-mini-{ns}-splits", paged_case(
            torch, lens=edges, qh2kv=mha, seed=31 + ns, **phi3), main=False,
            n_splits=ns)
    check_paged(torch, timer, "grouped-16-over-4-D96", paged_case(
        torch, B=8, H=16, KV=4, D=96, page=64, max_pages=32, P=289,
        lens=[5, 2048, 640, 1, 100, 1500, 63, 1024], qh2kv=g4, seed=40),
        main=False)
    check_paged(torch, timer, "phi3-mini-window300", paged_case(
        torch, lens=edges, qh2kv=mha, seed=41, **phi3), main=False,
        window=300)
    _, out["paged_attention_layers phi3-mini"] = check_paged_layers(
        torch, timer, L=32, lens=PHI3_DEPTHS, qh2kv=mha, seed=42, **phi3)
    out["flash_prefill phi3-mini chunk"] = check_prefill(
        torch, timer, "phi3-mini", Sq=256, Sk=1536, q_offset=1280, H=32,
        KV=32, D=96, qh2kv=mha, seed=43, main=True)
    check_prefill(torch, timer, "phi3-mini-off0", Sq=256, Sk=1536,
                  q_offset=0, H=32, KV=32, D=96, qh2kv=mha, seed=44,
                  main=False)
    check_prefill(torch, timer, "phi3-mini-tail131", Sq=131, Sk=1411,
                  q_offset=1280, H=32, KV=32, D=96, qh2kv=mha, seed=45,
                  main=False)
    check_prefill(torch, timer, "phi3-mini-off0-5splits", Sq=256, Sk=1536,
                  q_offset=0, H=32, KV=32, D=96, qh2kv=mha, seed=46,
                  main=False, n_splits=5)
    check_prefill(torch, timer, "grouped-D96-window300", Sq=256, Sk=1536,
                  q_offset=1280, H=16, KV=4, D=96, qh2kv=g4, seed=47,
                  main=False, window=300)
    return out


def e2e_head_dim_96(torch, timer) -> dict:
    """Phase 16: (a) the kernel cases; (b) phi3-mini-3.8b and (c)
    qwen2.5-3b served at full width and depth; (d) the sharded op at
    head_dim 96 on the (2, 2) mesh."""
    t0 = time.monotonic()
    out = dict(cases=head_dim_96_cases(torch, timer))
    log("phase 16 (a): " + json.dumps({k: {f: round(v, 5) if isinstance(
        v, float) else v for f, v in r.items()}
        for k, r in out["cases"].items()}))
    out["phi3"] = serve_dense(torch, "phi3-mini-3.8b")
    gc.collect()
    torch.cuda.empty_cache()
    out["qwen25"] = serve_dense(torch, "qwen2.5-3b")
    gc.collect()
    torch.cuda.empty_cache()
    out["sharded"] = check_sharded_op(torch, timer, H=32, KV=32, D=96,
                                      seed=48, lens=PHI3_DEPTHS)
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------------------
# phase 17: sharded training and the sharded MoE dispatch
# ---------------------------------------------------------------------------

def mesh_dist(torch, device="cuda"):
    """A (2, 2) (data, model) mesh with every position on ``device``,
    the batch over 'data'."""
    from repro_torch.models.layers import Dist
    return Dist(mesh=card_mesh(torch, (2, 2), ("data", "model"), device),
                batch_axes=("data",))


def moe_op_case(torch, timer, name, device="cuda") -> dict:
    """(a): ``moe_block`` on the (2, 2) mesh at B = 2, S = 4096 (T =
    8192 > 4096) from ``shard_params``' slices of one full-width MoE
    layer, against an independent one-device oracle —
    ``_moe_dispatch_compute`` of each position's token slice (EP) or data
    slice with every expert (TP), group by group, at the local capacity —
    within 4 bf16 ulps of the largest output; timed beside the unsharded
    op. ``device="cpu"``: the reduced width."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.shardings import shard_params
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _init_moe
    cfg = get_config(name)
    if device != "cuda":
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(17)
    p = _init_moe(gen, cfg, 1)
    dist = mesh_dist(torch, device)
    sp = shard_params(cfg, {"moe": p}, dist.mesh)["moe"]
    pm = {k: v[0] for k, v in p.items()}
    spm = {k: v[0] for k, v in sp.items()}
    x = (0.3 * torch.randn((2, 4096, cfg.d_model), generator=gen,
                           device=device)).to(torch.bfloat16)
    with torch.no_grad():
        with L.record_moe_branches() as taken:
            y, aux = L.moe_block(x, spm, cfg, dist)
        branch = taken[0]
        h = L.rms_norm(x, pm["ln"], cfg.norm_eps).reshape(-1, cfg.d_model)
        n = 4 if branch == "ep" else 2
        T_loc = h.shape[0] // n
        groups = max(T_loc // L.MOE_GROUP_TOKENS, 1)
        G = T_loc // groups
        cap = L.moe_capacity(cfg, G)
        want = torch.cat([L._moe_dispatch_compute(
            h[i * T_loc + g * G:i * T_loc + (g + 1) * G], pm["router"],
            pm["w1"], pm["w2"], pm["w3"], cfg.moe.top_k, cap)[0]
            for i in range(n) for g in range(groups)]).view(x.shape)
        if device == "cuda":
            torch.cuda.synchronize()
        err = (y.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = bf16_ulps(4, scale)
        ms = whole_ms = None
        if timer is not None:
            ms = timer.ms(lambda: L.moe_block(x, spm, cfg, dist), iters=5,
                          warmup=1)
            whole_ms = timer.ms(lambda: L.moe_block(x, pm, cfg), iters=5,
                                warmup=1)
    expect = "ep" if cfg.moe.parallelism == "ep" else "tp"
    log(f"(a) {cfg.name} moe_block on 2x2, T = 8192: branch {taken} "
        f"(expected {expect}), {cfg.moe.n_experts} experts, "
        f"{cfg.moe.n_experts // (2 if branch == 'ep' else 1)} a position, "
        f"d_ff_expert {cfg.moe.d_ff_expert}"
        f"{' split in two' if branch == 'tp' else ''}; capacity {cap} over "
        f"{groups} group(s) of {G}; max_abs_err vs the per-position oracle "
        f"{err:.4e} (max |y| {scale:.3f}, tol {tol:.4f} = 4 bf16 ulps); "
        f"aux {float(aux):.5f}; sharded op "
        + (f"{ms:.3f} ms vs the unsharded op {whole_ms:.3f} ms"
           if ms is not None else "not timed (cpu)"))
    if taken != [expect] or not bool(torch.isfinite(y.float()).all()) \
            or err > tol:
        raise AssertionError(f"(a) {cfg.name}: the sharded MoE dispatch "
                             f"disagrees with its oracle")
    return dict(branch=branch, err=err, tol=tol, ms=ms, whole_ms=whole_ms)


class HeadShapes:
    """Records (query heads, KV heads, map given) of every chunked-prefill
    call the model makes, while entered."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import layers as L
        self.orig = L.flash_prefill_attention

        def recording(q, k, v, **kw):
            self.calls.append((q.shape[2], k.shape[2],
                               kw.get("qh2kv") is not None))
            return self.orig(q, k, v, **kw)
        L.flash_prefill_attention = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.flash_prefill_attention = self.orig


def prefill_mesh_llama(torch, device="cuda", seq=4096) -> dict:
    """(b), llama2-70b at full width, 8 of 80 layers (phase 14's cut):
    ``make_prefill_step`` on the (2, 2) mesh over a 2 x 4096 batch, one
    chunked-prefill launch per (position, layer), each on 32 query heads
    over 4 KV heads; the logits within 4 bf16 ulps of the unsharded
    ``prefill``'s."""
    from repro_torch.launch.shardings import gather, shard_params
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import prefill
    cfg, params = llama_cut(torch, device)
    dist = mesh_dist(torch, device)
    sp = shard_params(cfg, params, dist.mesh)
    gen = torch.Generator(device=device).manual_seed(171)
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                         device=device)
    step = make_prefill_step(cfg, dist)
    step(sp, toks[:, :256], {})                          # warm-up
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    zero_kernel_counts()
    with HeadShapes() as shapes:
        t0 = time.monotonic()
        lk, ck = step(sp, toks, {})
        sync()
        t_mesh = time.monotonic() - t0
    launches = kernel_counts()["flash_prefill"]
    with torch.no_grad():
        t0 = time.monotonic()
        lu, cu = prefill(params, toks, cfg)
        sync()
        t_whole = time.monotonic() - t0
    err = (lk - lu).abs().max().item()
    scale = lu.abs().max().item()
    tol = bf16_ulps(4, scale)
    kv_err = max((gather(a, device).float() - b.float()).abs().max().item()
                 / b.float().abs().max().item()       # the stripes joined
                 for a, b in ((ck.kv.k, cu.kv.k), (ck.kv.v, cu.kv.v)))
    heads = sorted(set(shapes.calls))
    log(f"(b) {cfg.name} ({cfg.n_layers} layers) make_prefill_step on 2x2, "
        f"2 x {seq} tokens: flash_prefill launches {launches} (expected "
        f"{4 * cfg.n_layers} = 4 positions x {cfg.n_layers} layers), "
        f"(query heads, KV heads, map) per call {heads}; logits vs the "
        f"unsharded prefill max_abs_err {err:.4f} (max |logit| {scale:.3f}, "
        f"tol {tol:.4f} = 4 bf16 ulps), KV {kv_err:.3e} of its scale; "
        f"{t_mesh * 1e3:.1f} ms on the mesh vs {t_whole * 1e3:.1f} ms "
        f"unsharded (synchronised wall)")
    want_heads = [(cfg.padded_heads // 2, cfg.n_kv_heads // 2, False)]
    if device == "cuda" and (launches != 4 * cfg.n_layers
                             or heads != want_heads):
        raise AssertionError(f"(b) {cfg.name}: launches {launches}, head "
                             f"stripes {heads}")
    if not bool(torch.isfinite(lk).all()) or err > tol or kv_err > TOL:
        raise AssertionError(f"(b) {cfg.name}: the sharded prefill "
                             f"disagrees with the unsharded one")
    return dict(launches=launches, err=err, tol=tol, mesh_ms=t_mesh * 1e3,
                whole_ms=t_whole * 1e3)


def prefill_mesh_qwen3(torch, device="cuda", seq=4096) -> dict:
    """(b), qwen3-moe at full width, 4 of 94 layers: the kernel path
    against the plain path under the same (2, 2) mesh, by phase 12's
    rule (the plain run's routing replayed in the kernel path, logits
    within 4 bf16 ulps); 16 launches in the kernel path's own run, and
    the expert-parallel dispatch on every MoE layer."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.shardings import shard_params
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import (plain_attention,
                                           record_moe_branches,
                                           record_routing, replay_routing)
    cfg = get_config("qwen3-moe-235b-a22b")
    if device != "cuda":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=4)
    dist = mesh_dist(torch, device)
    params = moe_params(torch, cfg, device)
    sp = shard_params(cfg, params, dist.mesh)
    del params
    gen = torch.Generator(device=device).manual_seed(172)
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                         device=device)
    step = make_prefill_step(cfg, dist)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with plain_attention(), record_routing() as rp:
        lp, _ = step(sp, toks, {})
    sync()
    zero_kernel_counts()
    with record_routing() as rk, record_moe_branches() as branches:
        t0 = time.monotonic()
        lk_own, _ = step(sp, toks, {})
        sync()
        t_mesh = time.monotonic() - t0
    launches = kernel_counts()["flash_prefill"]
    with replay_routing(rp):
        lk, _ = step(sp, toks, {})
    sync()
    # rows whose set of chosen experts differs (an order swap within the
    # top-k is not a different routing)
    differ = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                 for a, b in zip(rk, rp))
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    tol = bf16_ulps(4, scale)
    own_err = (lk_own - lp).abs().max().item()
    log(f"(b) {cfg.name} ({cfg.n_layers} layers) make_prefill_step on 2x2, "
        f"2 x {seq} tokens: flash_prefill launches {launches} (expected "
        f"{4 * cfg.n_layers}); dispatch {sorted(set(branches))} on "
        f"{len(branches)} MoE calls; rows whose experts differ kernel vs "
        f"plain {differ} of {sum(r.shape[0] for r in rp)}; logits under the "
        f"plain routing max_abs_err {err:.4f} (max |logit| {scale:.3f}, "
        f"tol {tol:.4f}), under its own routing {own_err:.4f}; "
        f"{t_mesh * 1e3:.1f} ms (synchronised wall)")
    if device == "cuda" and launches != 4 * cfg.n_layers:
        raise AssertionError(f"(b) {cfg.name}: launches {launches}")
    if set(branches) != {"ep"} or len(branches) != cfg.n_layers \
            or not bool(torch.isfinite(lk).all()) or err > tol \
            or (differ == 0 and own_err > tol):
        raise AssertionError(f"(b) {cfg.name}: the kernel path disagrees "
                             f"with the plain path on the mesh")
    return dict(launches=launches, err=err, tol=tol, differ=differ,
                mesh_ms=t_mesh * 1e3)


def train_mesh_smollm(torch, device="cuda", batch=8, seq=512,
                      steps=10) -> dict:
    """(c): smollm-360m at full width trained on the (2, 2) mesh with
    AdamW, phase 15's 8 x 512 batches from seed 0, against as many
    unsharded steps: step 1's loss within 2e-2 relative (the reference's
    bound, ``tests/test_distribution.py:80``) and its gradients within
    2e-2 of each leaf's max-abs — or, for a leaf whose unsharded bf16
    gradient is itself further than that from the fp32 gradient of the
    same step (the embedding's bf16 scatter-add over repeated tokens),
    no further from the fp32 gradient than 1.25x the unsharded one (the
    rule ``tests/test_torch_train_parity.py`` holds against the reference)
    — the last loss below the first;
    tok/s and peak memory; no kernel launched."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
    from repro_torch.launch.shardings import gather, shard_params
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.transformer import init_params
    from repro_torch.training.loop import batch_to, train
    from repro_torch.training.optim import tree_map
    cfg = get_config("smollm-360m")
    if device != "cuda":
        cfg = cfg.reduced()
    dist = mesh_dist(torch, device)
    zero_kernel_counts()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    nb = batch_to(SyntheticLM(batch_spec_for(cfg, batch, seq),
                              seed=0).batch(0), device)
    l0, g0 = loss_and_grads(params, nb, cfg)
    l1, g1 = loss_and_grads(shard_params(cfg, params, dist.mesh), nb, cfg,
                            dist)
    _, g32 = loss_and_grads(tree_map(lambda t: t.float(), params), nb, cfg)
    rel = abs(float(l1) - float(l0)) / abs(float(l0))

    def dist_(a, b):
        a, b = gather(a, b.device).float(), b.float()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    errs, fp32_rule = [], []

    def hold(a, b, c):
        d = dist_(b, a)
        errs.append(d)
        if d > TOL:
            fp32_rule.append((d, dist_(b, c), dist_(a, c)))
    tree_map(hold, g0, g1, g32)
    worst = max(errs)
    del params, g0, g1, g32
    runs = {}
    for what, d in (("unsharded", None), ("2x2", dist)):
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kw = {} if d is None else {"dist": d}
        res = train(cfg, steps=steps, batch=batch, seq=seq, seed=0,
                    device=device, log_every=0, **kw)
        peak = torch.cuda.max_memory_allocated() / 1e9 \
            if device == "cuda" else float("nan")
        steady = sorted(res.step_s[2:])[len(res.step_s[2:]) // 2]
        runs[what] = dict(losses=res.losses, tok_s=res.tokens_per_s,
                          step_ms=steady * 1e3, peak_gb=peak)
        del res
    no_kernel_launched("17 (c)")
    mesh, whole = runs["2x2"], runs["unsharded"]
    log(f"(c) {cfg.name}, {batch} x {seq} tokens: step 1 loss 2x2 "
        f"{float(l1):.5f} vs unsharded {float(l0):.5f} (rel {rel:.3e}, tol "
        f"2e-2); step 1 gradients worst leaf {worst:.3e} of its max-abs "
        f"(tol {TOL}); leaves past it held against the fp32 gradient "
        f"(sharded gap, sharded to fp32, unsharded to fp32): "
        f"{[tuple(round(v, 4) for v in r) for r in fp32_rule]}; {steps} "
        f"steps: 2x2 losses {mesh['losses'][0]:.4f} -> "
        f"{mesh['losses'][-1]:.4f}, unsharded {whole['losses'][0]:.4f} -> "
        f"{whole['losses'][-1]:.4f}, last-step gap "
        f"{abs(mesh['losses'][-1] - whole['losses'][-1]):.4f}; 2x2 "
        f"{mesh['tok_s']:.0f} tok/s over the run (median step "
        f"{mesh['step_ms']:.1f} ms), peak {mesh['peak_gb']:.2f} GB; "
        f"unsharded {whole['tok_s']:.0f} tok/s ({whole['step_ms']:.1f} ms), "
        f"peak {whole['peak_gb']:.2f} GB; no kernel launched")
    losses = mesh["losses"] + whole["losses"]
    if not all(math.isfinite(x) for x in losses) or rel > TOL \
            or any(e1 > 1.25 * e0 for _, e1, e0 in fp32_rule) \
            or not mesh["losses"][-1] < mesh["losses"][0]:
        raise AssertionError("(c) sharded training of smollm-360m disagrees "
                             "or does not descend")
    return dict(rel=rel, grad_err=worst, **{k: {f: v for f, v in r.items()
                                               if f != "losses"}
                                            for k, r in runs.items()})


def train_mesh_qwen3(torch, device="cuda", n_layers=1, seq=4096,
                     steps=3) -> dict:
    """(d): qwen3-moe at full width, ``n_layers`` of 94, Adafactor, 2 x
    4096 tokens on the (2, 2) mesh for 3 steps: the expert-parallel
    dispatch on every MoE call of every step, every loss finite; the step
    time and the peak memory; no kernel launched. One layer: at two, with
    every position on one card, the peak passed 70 GB (70.48 GB: four
    positions' gathered expert slabs beside the weights, gradients and
    first moment; PERF.md §6)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import record_moe_branches
    from repro_torch.training.loop import train
    cfg = get_config("qwen3-moe-235b-a22b")
    if device != "cuda":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=n_layers, optimizer="adafactor")
    dist = mesh_dist(torch, device)
    zero_kernel_counts()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with record_moe_branches() as branches:
        res = train(cfg, steps=steps, batch=2, seq=seq, seed=0,
                    device=device, log_every=0, dist=dist)
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if device == "cuda" else float("nan")
    no_kernel_launched("17 (d)")
    # the forward's calls; a remat recompute in the backward, run on
    # autograd's device thread, is not in this thread's log
    calls = steps * n_layers
    log(f"(d) {cfg.name}, {n_layers} layers, Adafactor, remat "
        f"{cfg.remat}, 2 x {seq} tokens on 2x2, {steps} steps: losses "
        f"{[round(x, 4) for x in res.losses]}; dispatch "
        f"{sorted(set(branches))} on {len(branches)} recorded MoE calls "
        f"(at least {calls}: steps x layers); step times "
        f"{[round(t, 2) for t in res.step_s]} s; "
        f"{res.tokens_per_s:.0f} tok/s; peak memory {peak:.2f} GB")
    if set(branches) != {"ep"} or len(branches) < calls \
            or not all(math.isfinite(x) for x in res.losses):
        raise AssertionError("(d) qwen3-moe's sharded training did not take "
                             "the expert-parallel dispatch or diverged")
    return dict(losses=res.losses, step_s=res.step_s, peak_gb=peak,
                n_layers=n_layers)


def e2e_sharded_training(torch, timer, device="cuda") -> dict:
    """Phase 17: (a) the MoE op, (b) the sharded prefill step, (c) and
    (d) sharded training, every position on ``device``."""
    t0 = time.monotonic()
    out = {"moe_" + n: moe_op_case(torch, timer, n, device)
           for n in ("qwen3-moe-235b-a22b", "mixtral-8x7b")}
    gc.collect()
    out["llama"] = prefill_mesh_llama(torch, device)
    gc.collect()
    out["qwen3"] = prefill_mesh_qwen3(torch, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["smollm"] = train_mesh_smollm(torch, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["qwen3_train"] = train_mesh_qwen3(torch, device)
    out["launches"] = out["llama"]["launches"] + out["qwen3"]["launches"]
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------------------
# phase 18: the context-parallel serve step and the tensor-parallel mixer
# ---------------------------------------------------------------------------

def random_caches(torch, cfg, shape, length, device="cuda", seed=0):
    """``init_caches`` of a decode at ``shape`` (its serving window) with
    every KV slot and Mamba2 state drawn from ``seed`` (bf16 N(0, 1) K/V
    layer by layer, so no fp32 copy of a cache exists): the state
    decoded over, not a result."""
    from repro_torch.launch.steps import serve_window
    from repro_torch.models.transformer import init_caches
    c = init_caches(cfg, shape.batch, shape.seq,
                    window=serve_window(cfg, shape), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for t in (c.kv or ()):
        for l in range(t.shape[0]):
            t[l] = torch.randn(t.shape[1:], generator=gen, device=device,
                               dtype=torch.bfloat16)
    return c._replace(length=length)


def serve_ulps(cfg) -> float:
    """The serve steps' logits bound: phase 5's 4 bf16 ulps at
    llama2-70b's 8-layer cut, scaled with depth beyond it — each layer
    adds row-parallel sums (attention's ``wo``, the MLP's ``w2``, the
    mixer's ``out_proj``: bf16 partials summed in fp32 and rounded once,
    a rounding the unsharded GEMM does not make), and the residual
    stream carries every one of them to the logits."""
    return 4.0 * max(1.0, cfg.n_layers / 8)


def hold_serve(torch, what, lm, lw, bound_ulps=4) -> tuple:
    """One step of a mesh's serve step against the unsharded step on the
    same inputs (or any step against its reference): the logits within ``bound_ulps`` bf16 ulps of the
    largest, the argmax equal wherever the unsharded top-2 gap leaves
    room for it (more than twice the error). Returns (error in ulps,
    rows too close to call)."""
    scale = lw.abs().max().item()
    ulp = bf16_ulps(1, scale)
    err = (lm - lw).abs().max().item()
    top2 = lw.float().topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    same = bool(torch.equal(lm.argmax(-1)[decisive], lw.argmax(-1)[decisive]))
    if not bool(torch.isfinite(lm).all()) or err > bound_ulps * ulp \
            or not same:
        raise AssertionError(f"{what}: disagrees with its reference "
                             f"step ({err / ulp:.2f} ulps, streams equal "
                             f"where decided: {same})")
    return err / ulp, int((~decisive).sum())


def serve_mesh_run(torch, cfg, params, caches, shape, meshes, tokens,
                   steps, device="cuda") -> dict:
    """The unsharded ``decode_step`` (through ``make_serve_step`` without
    a mesh) for ``steps`` greedy steps, then ``make_serve_step`` on each
    of ``meshes`` from the same caches (``shard_caches`` copies), fed the
    unsharded stream, every step held by ``hold_serve``. Step walls are
    synchronised host times; the peak is ``max_memory_allocated`` over
    the mesh run (the unsharded weights and caches included)."""
    from repro_torch.launch.shardings import shard_caches, shard_params
    from repro_torch.launch.steps import (cache_specs, make_dist,
                                          make_serve_step)
    from repro_torch.models.layers import NO_DIST
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    length = caches.length
    whole = make_serve_step(cfg, NO_DIST, shape)
    stream, logits, walls = [tokens], [], []
    # the slots the unsharded run writes, kept to be put back for the
    # meshes: a wrapped ring's hold live positions
    saved = None
    if caches.kv is not None:
        S = caches.kv.k.shape[2]
        slots = torch.tensor([(length + t) % S for t in range(steps)],
                             device=caches.kv.k.device)
        saved = [t[:, :, slots].clone() for t in caches.kv]
    c = caches
    for _ in range(steps):
        sync()
        t0 = time.monotonic()
        lw, c = whole(params, stream[-1], c)
        sync()
        walls.append(time.monotonic() - t0)
        logits.append(lw)
        stream.append(lw[:, -1:].argmax(-1).to(torch.int32))
    out = {"whole_ms": 1e3 * sum(walls[1:]) / max(len(walls) - 1, 1)}
    if saved is not None:
        for t, kept in zip(caches.kv, saved):
            t[:, :, slots] = kept
    for dm in meshes:
        mesh = card_mesh(torch, dm, ("data", "model"), device)
        dist = make_dist(mesh, shape)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sp = shard_params(cfg, params, mesh)
        sc = shard_caches(cfg, caches._replace(length=length),
                          cache_specs(cfg, shape, dist), mesh)
        step = make_serve_step(cfg, dist, shape)
        errs, ties, walls = [], 0, []
        for t in range(steps):
            sync()
            t0 = time.monotonic()
            lm, sc = step(sp, stream[t], sc)
            sync()
            walls.append(time.monotonic() - t0)
            e, n = hold_serve(torch, f"{cfg.name} {dm}", lm, logits[t],
                              serve_ulps(cfg))
            errs.append(e)
            ties += n
        peak = torch.cuda.max_memory_allocated() / 1e9 \
            if device == "cuda" else float("nan")
        out[f"{dm[0]}x{dm[1]}"] = dict(
            ms=1e3 * sum(walls[1:]) / max(len(walls) - 1, 1),
            worst_ulps=max(errs), near_ties=ties, peak_gb=peak,
            stripes=len(sc.kv.k.shards) if sc.kv is not None else 0)
        del sp, sc
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def serve_decode_32k(torch, device="cuda", seq=32768, length=32640,
                     steps=16) -> dict:
    """(a): ``decode_32k``'s sequence, llama2-70b at full width, 8 of 80
    layers (phase 14's cut), batch 8 (cut from 128): caches of ``seq``
    slots at ``length`` (random K/V from seed 0), 16 greedy steps on a
    (1, 4) mesh (8,192-slot stripes) and a (2, 2) one against the
    unsharded ``decode_step``."""
    import dataclasses

    from repro_torch.launch.steps import INPUT_SHAPES
    cfg, params = llama_cut(torch, device)
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], batch=8, seq=seq)
    caches = random_caches(torch, cfg, shape, length, device)
    gen = torch.Generator(device=device).manual_seed(18)
    tok = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen,
                        device=device).to(torch.int32)
    out = serve_mesh_run(torch, cfg, params, caches, shape,
                         [(1, 4), (2, 2)], tok, steps, device)
    kv_gb = 2 * caches.kv.k.numel() * 2 / 1e9
    log(f"(a) {cfg.name} ({cfg.n_layers} layers), decode_32k's sequence: "
        f"batch 8 (cut from 128), {seq}-slot caches at length {length} "
        f"({kv_gb:.2f} GB of K/V), {steps} greedy steps teacher-forced on "
        f"the unsharded stream: unsharded {out['whole_ms']:.2f} ms a step; "
        + "; ".join(f"{k}: {v['stripes']} stripes, {v['ms']:.2f} ms a step, "
                    f"worst {v['worst_ulps']:.2f} ulps (tol "
                    f"{serve_ulps(cfg):g}), "
                    f"{v['near_ties']} near-tie rows, peak "
                    f"{v['peak_gb']:.2f} GB" for k, v in out.items()
                    if isinstance(v, dict)))
    del params, caches
    return out


def serve_long_500k(torch, device="cuda", steps=16, mamba_state=None,
                    length=524000) -> dict:
    """(b): ``long_500k``, batch 1, so the KV sequence stripes over all
    four positions of (2, 2): smollm-360m at full width and depth over
    the 8,192-slot ring (``SERVE_WINDOW``) at ``length`` (wrapped), and
    mamba2-2.7b from (c)'s prefill state (row 0) on the tensor-parallel
    mixers; each 16 steps against the unsharded step."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import INPUT_SHAPES, SERVE_WINDOW
    shape = INPUT_SHAPES["long_500k"]
    cfg = get_config("smollm-360m")
    if device != "cuda":
        cfg = cfg.reduced()
    params = draw_params(torch, cfg, device)
    caches = random_caches(torch, cfg, shape, length, device, seed=1)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=device)
    out = {"smollm": serve_mesh_run(torch, cfg, params, caches, shape,
                                    [(2, 2)], tok, steps, device)}
    r = out["smollm"]["2x2"]
    log(f"(b) {cfg.name} long_500k: a {caches.kv.k.shape[2]}-slot ring "
        f"(SERVE_WINDOW {SERVE_WINDOW}) at length {length}, batch 1 over "
        f"{r['stripes']} stripes (data-major over the 2x2 mesh): unsharded "
        f"{out['smollm']['whole_ms']:.2f} ms a step, 2x2 {r['ms']:.2f} ms, "
        f"worst {r['worst_ulps']:.2f} ulps (tol {serve_ulps(cfg):g}), "
        f"{r['near_ties']} "
        f"near-tie rows")
    del params, caches
    if mamba_state is not None:
        mcfg, mparams, state, first = mamba_state
        caches = state._replace(ssm=type(state.ssm)(
            *(t[:, :1].contiguous() for t in state.ssm)))
        layer = decode_layers_mamba(torch, mcfg, mparams, caches, first[:1],
                                    device)
        out["mamba"] = serve_mesh_run(torch, mcfg, mparams, caches, shape,
                                      [(2, 2)], first[:1], steps, device)
        r = out["mamba"]["2x2"]
        log(f"(b) {mcfg.name} long_500k from (c)'s prefill state (row 0, "
            f"length {caches.length}), heads over the 2x2 mesh's model "
            f"axis: unsharded {out['mamba']['whole_ms']:.2f} ms a step, "
            f"2x2 {r['ms']:.2f} ms, worst {r['worst_ulps']:.2f} ulps (tol "
            f"{serve_ulps(mcfg):g}), {r['near_ties']} near-tie rows; each "
            f"layer's decode mixer on the unsharded step's input and state: "
            f"y {layer['y']:.2f} ulps (tol 2), conv state "
            f"{layer['conv']:.2f} ulps (tol 1), SSM state "
            f"{layer['ssm']:.3e} (tol 4e-3)")
        out["mamba"]["layer"] = layer
    return out


def layer_errors(torch, cfg, sp, dist, calls, states=None,
                 device="cuda") -> dict:
    """Each recorded unsharded mixer call (input, output, new state) run
    again by the tensor-parallel mixer on the same input (and, for a
    decode, the same incoming state of that layer): the worst output
    error in bf16 ulps of its max-abs, conv state in ulps, SSM state
    relative to its scale."""
    from repro_torch.launch.shardings import gather
    from repro_torch.models.mamba import mamba_block
    worst = dict(y=0.0, conv=0.0, ssm=0.0)
    with torch.no_grad():
        for l, (x, y0, st0) in enumerate(calls):
            st = None if states is None else type(states)(
                *(t[l] for t in states))
            y1, st1 = mamba_block(x, {k: v[l] for k, v in sp["mamba"].items()},
                                  cfg, dist, state=st, return_state=True)
            worst["y"] = max(worst["y"], (y1.float() - y0.float()).abs().max()
                             .item() / bf16_ulps(1, y0.float().abs().max()
                                                 .item()))
            worst["conv"] = max(worst["conv"], (
                gather(st1.conv, device).float() - st0.conv.float()).abs()
                .max().item() / bf16_ulps(1, st0.conv.float().abs().max()
                                          .item()))
            worst["ssm"] = max(worst["ssm"], (
                gather(st1.ssm, device) - st0.ssm).abs().max().item()
                / st0.ssm.abs().max().item())
    return worst


def decode_layers_mamba(torch, cfg, params, caches, tok, device) -> dict:
    """(b)'s per-layer hold: one unsharded serve step from ``caches``
    recorded, then each layer's tensor-parallel decode mixer on the
    (2, 2) mesh from the same input and state; raises past 2 ulps (y),
    1 ulp (conv state) or 4e-3 (SSM state)."""
    from repro_torch.launch.shardings import shard_params
    from repro_torch.launch.steps import INPUT_SHAPES, make_dist
    from repro_torch.models.transformer import decode_step
    dist = make_dist(mesh_dist(torch, device).mesh, INPUT_SHAPES["long_500k"])
    sp = shard_params(cfg, params, dist.mesh)
    with torch.no_grad(), MixerCalls() as whole:
        decode_step(params, tok, caches, cfg)
    worst = layer_errors(torch, cfg, sp, dist, whole.calls, caches.ssm,
                         device)
    if worst["y"] > 2 or worst["conv"] > 1 or worst["ssm"] > 4e-3:
        raise AssertionError(f"(b) {cfg.name}: a tensor-parallel decode "
                             f"mixer disagrees with the unsharded one: "
                             f"{worst}")
    return worst


class MixerCalls:
    """Records every unsharded ``mamba_block`` call's input, output and
    new state while entered (the per-layer hold of phase 18 (c)) and the
    head count of every SSD-scan call."""

    def __init__(self):
        self.calls, self.heads = [], []

    def __enter__(self):
        from repro_torch.models import mamba as MB
        from repro_torch.models import transformer as TR
        self.block, self.op = TR.mamba_block, MB.ssd_scan_op

        def block(x, p, cfg, dist=None, **kw):
            out = self.block(x, p, cfg, dist, **kw) if dist is not None \
                else self.block(x, p, cfg, **kw)
            if dist is None or not dist.active:
                self.calls.append((x, out[0], out[1]))
            return out

        def op(xh, *a, **k):
            self.heads.append(xh.shape[2])
            return self.op(xh, *a, **k)
        TR.mamba_block, MB.ssd_scan_op = block, op
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba as MB
        from repro_torch.models import transformer as TR
        TR.mamba_block, MB.ssd_scan_op = self.block, self.op


def prefill_mesh_mamba(torch, timer, device="cuda", seq=4096) -> dict:
    """(c): ``make_prefill_step`` of mamba2-2.7b at full width and depth
    over 2 x ``seq`` tokens on (2, 2): one ``ssd_scan`` launch per (row,
    position, layer), each on nh / 2 heads. Held layer by layer: each
    layer's tensor-parallel mixer, fed the unsharded prefill's input to
    that layer, gives its output within 2 bf16 ulps of the unsharded
    mixer's max-abs, its conv state within 1 ulp and its SSM state within
    4e-3 (a bf16 ulp) of their scale. The free run's logits and final
    states are reported beside the unsharded stack's own kernel-vs-plain
    distance (64 mixers amplify a per-layer ulp: neither meets 4 ulps and
    2e-2 at this depth), held finite with equal argmax wherever the top-2
    gap exceeds twice the measured error. Then ``ssd_scan`` at the
    stripe's shape timed beside its plain version (phase 6's check)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.shardings import gather, shard_params
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.transformer import prefill
    cfg = get_config("mamba2-2.7b")
    if device != "cuda":
        cfg = cfg.reduced()
    params = draw_params(torch, cfg, device)
    dist = mesh_dist(torch, device)
    sp = shard_params(cfg, params, dist.mesh)
    gen = torch.Generator(device=device).manual_seed(181)
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                         device=device)
    step = make_prefill_step(cfg, dist)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    step(sp, toks[:, :512], {})                          # warm-up
    sync()
    zero_kernel_counts()
    with MixerCalls() as mesh_calls:
        t0 = time.monotonic()
        lk, ck = step(sp, toks, {})
        sync()
        t_mesh = time.monotonic() - t0
    launches = kernel_counts()["ssd_scan"]
    heads = mesh_calls.heads
    with torch.no_grad(), MixerCalls() as whole:
        t0 = time.monotonic()
        lu, cu = prefill(params, toks, cfg)
        sync()
        t_whole = time.monotonic() - t0
    with torch.no_grad(), plain_attention():
        lp, cp = prefill(params, toks, cfg)
    nh = cfg.ssm.n_heads(cfg.d_model)
    want = 4 * cfg.n_layers

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() \
            / b.float().abs().max().item()
    # each layer on the unsharded run's own input to it
    worst = layer_errors(torch, cfg, sp, dist, whole.calls, device=device)
    del whole
    scale = lu.abs().max().item()
    ulp = bf16_ulps(1, scale)
    err = (lk - lu).abs().max().item()
    top2 = lu.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    same = bool(torch.equal(lk.argmax(-1)[decisive], lu.argmax(-1)[decisive]))
    st_err = max(rel(gather(a, device), b) for a, b in zip(ck.ssm, cu.ssm))
    own = (lu - lp).abs().max().item() / ulp
    own_st = max(rel(a, b) for a, b in zip(cu.ssm, cp.ssm))
    log(f"(c) {cfg.name} ({cfg.n_layers} layers) make_prefill_step on 2x2, "
        f"2 x {seq} tokens: ssd_scan launches {launches} (expected {want} "
        f"= 2 rows x 2 positions x {cfg.n_layers} layers), heads per call "
        f"{sorted(set(heads))} of {nh}; each layer on the unsharded "
        f"input: y {worst['y']:.2f} ulps (tol 2), conv state "
        f"{worst['conv']:.2f} ulps (tol 1), SSM state {worst['ssm']:.3e} "
        f"of its scale (tol 4e-3); the free run: logits {err / ulp:.2f} "
        f"ulps (max |logit| {scale:.3f}), final states {st_err:.3e} of "
        f"their scale, argmax equal on {int(decisive.sum())} of "
        f"{decisive.numel()} rows decided ({same}) — the unsharded stack's "
        f"own kernel vs plain: {own:.2f} ulps, states {own_st:.3e}; "
        f"{t_mesh * 1e3:.1f} ms on the mesh vs {t_whole * 1e3:.1f} ms "
        f"unsharded (synchronised wall)")
    if (device == "cuda" and launches != want) or len(heads) != want \
            or set(heads) != {nh // 2}:
        raise AssertionError(f"(c): {launches} launches on {set(heads)} "
                             f"heads")
    if worst["y"] > 2 or worst["conv"] > 1 or worst["ssm"] > 4e-3 \
            or not bool(torch.isfinite(lk).all()) or not same:
        raise AssertionError("(c): the tensor-parallel mixers disagree "
                             "with the unsharded ones")
    kernel = None
    if timer is not None:
        kernel = check_ssd(torch, timer, "tp-stripe", b=1, s=seq,
                           h=nh // 2, p=cfg.ssm.head_dim, n=cfg.ssm.d_state,
                           chunk=cfg.ssm.chunk, seed=18, main=True)
    del sp
    return dict(launches=launches, layer=worst, err_ulps=err / ulp,
                state_err=st_err, own_ulps=own, own_state=own_st,
                mesh_ms=t_mesh * 1e3, whole_ms=t_whole * 1e3, kernel=kernel,
                mamba_state=(cfg, params, cu, lu.argmax(-1)[:, None].to(
                    torch.int32)))


def e2e_serve_mesh(torch, timer, device="cuda", seq=32768,
                   length=32640) -> dict:
    """Phase 18: (a) decode_32k's sequence, (c) the tensor-parallel
    mixer, (b) long_500k — every position on ``device``."""
    t0 = time.monotonic()
    out = {"a": serve_decode_32k(torch, device, seq=seq, length=length)}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["c"] = prefill_mesh_mamba(torch, timer, device)
    gc.collect()
    out["b"] = serve_long_500k(torch, device,
                               mamba_state=out["c"].pop("mamba_state"))
    out["launches"] = out["c"]["launches"]
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------------------
# phase 19: the dry run — on the card's host, and against the card
# ---------------------------------------------------------------------------

def dryrun_host() -> dict:
    """(a): ``lower_one`` of smollm-360m's ``decode_32k`` on 16x16 and
    ``train_4k`` on 2x16x16, host only; no jax imported."""
    from repro_torch.launch.dryrun import lower_one
    out = {}
    for shape, multi in (("decode_32k", False), ("train_4k", True)):
        t0 = time.monotonic()
        rec = lower_one("smollm-360m", shape, multi_pod=multi, verbose=False)
        rec["wall_s"] = time.monotonic() - t0
        show = {k: rec[k] for k in ("arch", "shape", "mesh", "n_devices",
                                    "trace_s", "wall_s", "memory", "cost",
                                    "roofline")}
        show["busiest"] = rec["analysis"]["position"]
        show["collective_bytes"] = rec["analysis"]["collective_bytes"]
        log("(a) " + json.dumps(show))
        out[f"{shape}-{rec['mesh']}"] = rec
    if "jax" in sys.modules:
        raise AssertionError("the dry run imported jax")
    return out


def _arg_bytes(torch, tree) -> int:
    """The bytes of every tensor a step receives (each storage once)."""
    from repro_torch.launch.shardings import Sharded
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, Sharded):
            for t in x.shards.values():
                walk(t)
        elif isinstance(x, torch.Tensor):
            key = x.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(tree)
    return total


def predict_and_run(torch, name, cfg, shape, dims, make_args,
                    device="cuda", hold_plain=False) -> dict:
    """(b): the dry run's prediction of ``cfg``'s step at ``shape`` on a
    ``dims`` mesh (``launch.dryrun.dry_run`` on stand-in positions), then
    the step for real with every position on ``device``: the predicted
    argument bytes (summed over positions) held equal to the bytes the
    step receives, the step's peak held at least those, its logits
    finite; the predicted peak, roofline bound and launches read beside
    the measured ones. ``hold_plain``: the logits also held within 4
    bf16 ulps of the largest (phase 5's rule) of the same step's under
    ``plain_attention()``, for a shape no other phase holds."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_standin_mesh
    from repro_torch.models.layers import plain_attention
    axes = ("data", "model")
    rec = DR.dry_run(cfg, shape, make_standin_mesh(dims, axes))
    mesh = card_mesh(torch, dims, axes, device)
    step, args = make_args(mesh)
    received = _arg_bytes(torch, args)
    predicted = rec["memory"]["argument_bytes_total"]
    if received != predicted:
        raise AssertionError(f"{name}: the step receives {received} bytes, "
                             f"the dry run predicted {predicted}")
    step(*args)                          # warm: the first call's set-up
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    logits = out[0]
    del out
    if peak < received:
        raise AssertionError(f"{name}: peak {peak} below the {received} "
                             f"argument bytes")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: logits not finite")
    err = None
    if hold_plain:
        with plain_attention():
            plain = step(*args)[0]
        err = (logits.float() - plain.float()).abs().max().item()
        scale = plain.abs().max().item()
        tol = bf16_ulps(4, scale)
        log(f"(b) {name}: logits against the plain path's max_abs_err "
            f"{err:.4f} (max |logit| {scale:.3f}; tol {tol:.4f} = 4 bf16 "
            f"ulps)")
        if err > tol:
            raise AssertionError(f"{name}: the kernel path's logits "
                                 f"disagree with the plain path's")
        del plain
    del logits
    per = rec["analysis"]["per_position"]
    bound_sum = sum(max(roofline_times(r)) for r in per.values())
    peak_sum = sum(r["peak_bytes"] for r in per.values())
    res = {"argument_bytes": received, "measured_peak": peak,
           "predicted_peak_sum": peak_sum,
           "peak_ratio": peak_sum / peak,
           "busiest": rec["analysis"]["position"],
           "bound_busiest_ms": rec["roofline"]["t_bound_s"] * 1e3,
           "bound_sum_ms": bound_sum * 1e3, "wall_ms": wall * 1e3,
           "share_of_bound": bound_sum / wall,
           "predicted_flops_sum": sum(r["flops"] for r in per.values()),
           "launches": launches, "trace_s": rec["trace_s"],
           "max_abs_err": err}
    log(f"(b) {name} on {dims}: argument bytes {received} = predicted; "
        f"peak measured {peak / 1e9:.3f} GB, predicted (sum of positions' "
        f"peaks) {peak_sum / 1e9:.3f} GB, ratio {res['peak_ratio']:.3f}; "
        f"wall {wall * 1e3:.2f} ms against a bound of "
        f"{bound_sum * 1e3:.3f} ms summed over positions (busiest "
        f"{res['busiest']} {res['bound_busiest_ms']:.3f} ms): "
        f"{res['share_of_bound']:.4f} of the bound reached; launches "
        f"{launches}; counted in {rec['trace_s']} s")
    return res


def roofline_times(r) -> tuple:
    """A position's three roofline times on the H100 (seconds)."""
    from repro_torch.launch.op_analysis import roofline_terms
    t = roofline_terms(r)
    return t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]


def dryrun_card(torch, device="cuda") -> dict:
    """(b): smollm-360m's prefill of 1 x 8192 on 1x1 (full width and
    depth), llama2-70b's ``decode_32k`` serve step (8 of 80 layers,
    batch 8, on (2, 2)), mamba2-2.7b's prefill of 2 x 4096 on (2, 2):
    each predicted, then run on the card. smollm-360m's logits are held
    against its plain path here; the other two steps' are held in phase
    18 (a) and (c), at the same shapes."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.shardings import shard_caches, shard_params
    from repro_torch.launch.steps import (INPUT_SHAPES, ShapeSpec,
                                          cache_specs, make_dist,
                                          make_prefill_step, make_serve_step)
    reduced = device != "cuda"
    out = {}

    def cut(arch, **kw):
        cfg = get_config(arch)
        return dataclasses.replace(cfg.reduced() if reduced else cfg, **kw)

    def prefill_case(cfg, shape, dims):
        def make(mesh):
            params = draw_params(torch, cfg, device)
            sp = shard_params(cfg, params, mesh)
            del params
            gen = torch.Generator(device=device).manual_seed(19)
            tok = torch.randint(0, cfg.vocab_size, (shape.batch, shape.seq),
                                generator=gen, device=device,
                                dtype=torch.int32)
            return make_prefill_step(cfg, make_dist(mesh, shape)), \
                (sp, tok, {})
        return make

    smollm = cut("smollm-360m")
    shape = ShapeSpec("prefill", "prefill", 1024 if reduced else 8192, 1)
    out["smollm"] = predict_and_run(torch, "smollm-360m prefill", smollm,
                                    shape, (1, 1),
                                    prefill_case(smollm, shape, (1, 1)),
                                    device, hold_plain=True)
    torch.cuda.empty_cache()

    llama = cut("llama2-70b", n_layers=8)
    if reduced:
        llama = dataclasses.replace(llama, n_heads=16, n_kv_heads=4)
    dshape = dataclasses.replace(INPUT_SHAPES["decode_32k"], batch=8,
                                 seq=512 if reduced else 32768)

    def decode_make(mesh):
        params = draw_params(torch, llama, device)
        sp = shard_params(llama, params, mesh)
        del params
        dist = make_dist(mesh, dshape)
        whole = random_caches(torch, llama, dshape, dshape.seq - 128,
                              device)
        sc = shard_caches(llama, whole, cache_specs(llama, dshape, dist),
                          mesh)._replace(length=dshape.seq - 1)
        del whole
        gen = torch.Generator(device=device).manual_seed(19)
        tok = torch.randint(0, llama.vocab_size, (dshape.batch, 1),
                            generator=gen, device=device, dtype=torch.int32)
        return make_serve_step(llama, dist, dshape), (sp, tok, sc)
    out["llama"] = predict_and_run(torch, "llama2-70b decode_32k", llama,
                                   dshape, (2, 2), decode_make, device)
    torch.cuda.empty_cache()

    mamba = cut("mamba2-2.7b")
    mshape = ShapeSpec("prefill", "prefill", 256 if reduced else 4096, 2)
    out["mamba"] = predict_and_run(torch, "mamba2-2.7b prefill", mamba,
                                   mshape, (2, 2),
                                   prefill_case(mamba, mshape, (2, 2)),
                                   device)
    torch.cuda.empty_cache()
    return out


def e2e_dryrun(torch, device="cuda") -> dict:
    """Phase 19: (a) the dry run on the card's host, (b) its predictions
    against three steps on the card."""
    t0 = time.monotonic()
    host = dryrun_host()
    card = dryrun_card(torch, device)
    launches = {k: sum(v["launches"][k] for v in card.values())
                for k in card["smollm"]["launches"]}
    return {"host": host, "card": card, "launches": launches,
            "seconds": time.monotonic() - t0}


# ---------------------------------------------------------------------------
# phase 20: where mesh steps keep what they make, and the main path again
# ---------------------------------------------------------------------------

def joined_prefill(torch, params, tokens, cfg, dist):
    """The placement a mesh prefill's caches had before they stayed on
    their stripes, kept here for the comparison only: the same forward,
    every data row's KV joined on the mesh's first position and the
    Mamba2 states gathered whole there. Returns (kv, ssm) tensors."""
    from repro_torch.launch.shardings import gather
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import join_rows
    from repro_torch.models.mamba import MambaState
    with torch.no_grad():
        x = T._embed(params, tokens, cfg, dist)
        _, _, kvs, ssm = T._run_stack(
            params, x, cfg, mode="prefill",
            caches=T.Caches(kv=None, length=0), dist=dist)
    dev = dist.grid()[0, 0]
    kv = None
    if kvs:
        kv = T.KVCache(*(torch.stack([join_rows([p[i] for p in rows], dev)
                                      for rows in kvs]) for i in range(2)))
    if ssm is not None:
        ssm = MambaState(ssm=gather(ssm.ssm, dev), conv=gather(ssm.conv, dev))
    return kv, ssm


def prefill_stripes(torch, cfg, params, device="cuda", seq=4096,
                    steps=4) -> dict:
    """(a): ``make_prefill_step`` over 2 x ``seq`` tokens on (2, 2): its
    caches ``Sharded`` by ``cache_specs``, gathered bit for bit
    ``joined_prefill``'s, each position's bytes read off its shards;
    then ``steps`` serve steps of ``make_serve_step`` at ``seq`` + 8
    slots from them as they are (the step gives them the room), against
    the unsharded serve step from the same caches gathered, within
    ``serve_ulps`` (phase 18's rule), fed the unsharded stream."""
    import dataclasses

    from repro_torch.launch.shardings import Sharded, gather, shard_params
    from repro_torch.launch.steps import (INPUT_SHAPES, cache_specs,
                                          make_dist, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models.layers import NO_DIST
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], batch=2,
                                seq=seq + 8)
    mesh = mesh_dist(torch, device).mesh
    dist = make_dist(mesh, shape)
    sp = shard_params(cfg, params, mesh)
    gen = torch.Generator(device=device).manual_seed(201)
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                         device=device)
    step = make_prefill_step(cfg, dist)
    step(sp, toks[:, :512], {})                          # warm-up
    sync()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.monotonic()
    logits, caches = step(sp, toks, {})
    sync()
    wall = time.monotonic() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    specs = cache_specs(cfg, shape, dist)
    per_pos: dict = {}
    for f in ("kv", "ssm"):
        for a, s in zip(getattr(caches, f) or (), getattr(specs, f) or ()):
            if not isinstance(a, Sharded) or a.spec != tuple(s):
                raise AssertionError(f"(a) {cfg.name}: a {f} leaf is not "
                                     f"laid out by cache_specs")
            for key, t in a.shards.items():
                co = a.coords(key)
                lab = f"({co.get('data', 0)}, {co.get('model', 0)})"
                per_pos[lab] = per_pos.get(lab, 0) + t.numel() \
                    * t.element_size()
    kv_j, ssm_j = joined_prefill(torch, sp, toks, cfg, dist)
    same = True
    if kv_j is not None:
        for a, b in zip(caches.kv, kv_j):
            same &= bool(torch.equal(gather(a, device), b))
    if ssm_j is not None:
        for a, b in zip(caches.ssm, ssm_j):
            same &= bool(torch.equal(gather(a, device), b))
    total = sum(b.numel() * b.element_size() for g in (kv_j, ssm_j)
                if g is not None for b in g)
    del kv_j, ssm_j
    whole = caches._replace(**{f: type(getattr(caches, f))(
        *(gather(t, device) for t in getattr(caches, f)))
        for f in ("kv", "ssm") if getattr(caches, f) is not None})
    serve = make_serve_step(cfg, dist, shape)
    single = make_serve_step(cfg, NO_DIST, shape)
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    worst = 0.0
    for _ in range(steps):
        lw, whole = single(params, nxt, whole)
        lm, caches = serve(sp, nxt, caches)
        e, _ = hold_serve(torch, f"(a) {cfg.name}", lm, lw, serve_ulps(cfg))
        worst = max(worst, e)
        nxt = lw.argmax(-1).to(torch.int32)
    if caches.length != seq + steps or whole.length != seq + steps:
        raise AssertionError(f"(a) {cfg.name}: lengths {caches.length}, "
                             f"{whole.length}")
    log(f"(a) {cfg.name} ({cfg.n_layers} layers) make_prefill_step on 2x2, "
        f"2 x {seq} tokens: caches Sharded by cache_specs, gathered equal "
        f"to the joined caches bit for bit: {same}; bytes a position "
        f"{json.dumps(per_pos)} of {total} in all (the joined form held "
        f"them all on (0, 0)); peak {peak / 1e9:.3f} GB; "
        f"{wall * 1e3:.1f} ms; launches flash_prefill "
        f"{launches['flash_prefill']}, ssd_scan {launches['ssd_scan']}; "
        f"{steps} serve steps from the stripes as they are: worst "
        f"{worst:.2f} ulps (tol {serve_ulps(cfg):g})")
    if not same or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"(a) {cfg.name}: the striped caches are not "
                             f"the joined ones")
    if len(per_pos) != 4 or len(set(per_pos.values())) != 1:
        raise AssertionError(f"(a) {cfg.name}: the stripes are uneven "
                             f"{per_pos}")
    del sp, caches, whole
    return dict(launches=launches, per_position=per_pos, total=total,
                peak=peak, wall_ms=wall * 1e3, worst_ulps=worst)


def global_whole(torch, hs, p, cfg, dev, T_total):
    """The MoE global dispatch before it ran where the experts are, kept
    here for the comparison only: every row's tokens and every expert's
    weights gathered on the first position."""
    from repro_torch.launch.shardings import gather
    from repro_torch.models import layers as L
    h = torch.cat([t.to(dev) for t in hs])
    return L._moe_dispatch_compute(
        h, gather(p["router"], dev), gather(p["w1"], dev),
        gather(p["w2"], dev), gather(p["w3"], dev), cfg.moe.top_k,
        L.moe_capacity(cfg, T_total))


def global_moved(torch, cfg, tokens) -> dict:
    """Bytes copied into (0, 0), and the most into any position, by one
    global dispatch of 2 rows x ``tokens`` on a 2x2 mesh, before
    (``global_whole``) and after (``_moe_global``): the dry run's count
    on stand-in positions (every position of the card's mesh is
    ``cuda:0``, so no copy shows there)."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_standin_mesh
    from repro_torch.launch.op_analysis import OpAnalysis, standin
    from repro_torch.models import layers as L
    mesh = make_standin_mesh((2, 2), ("data", "model"))
    grid = mesh.devices
    p = DR._moe_layer(cfg, mesh, False)
    hs = [standin((tokens, cfg.d_model), L.DTYPE, grid[r, 0])
          for r in range(2)]
    out = {}
    for name, fn in (
            ("before", lambda: global_whole(torch, hs, p, cfg, grid[0, 0],
                                            2 * tokens)),
            ("after", lambda: L._moe_global(hs, p, cfg, grid, 2 * tokens))):
        mode = OpAnalysis()
        with mode, torch.no_grad():
            fn()
        got = {d: t.record()["collective_total"]
               for d, t in mode.tallies.items()}
        out[name] = (got.get(grid[0, 0], 0), max(got.values()))
    return out


def moe_global_case(torch, timer, name, device="cuda", tokens=1024) -> dict:
    """(b): one full-width MoE layer's ``moe_block`` on (2, 2) over 2 x
    ``tokens`` (T = 2048: the global dispatch) from ``shard_params``'
    slices, against ``global_whole`` on the same inputs: y and aux bit
    for bit (each position runs whole experts, so no partial sum
    rounds). ``device="cpu"``: the reduced width."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.shardings import gather, shard_params
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _init_moe
    cfg = get_config(name)
    if device != "cuda":
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(20)
    p = _init_moe(gen, cfg, 1)
    dist = mesh_dist(torch, device)
    spm = {k: v[0] for k, v in
           shard_params(cfg, {"moe": p}, dist.mesh)["moe"].items()}
    del p
    x = (0.3 * torch.randn((2, tokens, cfg.d_model), generator=gen,
                           device=device)).to(torch.bfloat16)
    with torch.no_grad():
        with L.record_moe_branches() as taken:
            y, aux = L.moe_block(x, spm, cfg, dist)
        hs = [L.rms_norm(r, gather(spm["ln"], r.device), cfg.norm_eps)
              .reshape(-1, cfg.d_model) for r in L.split_rows(x, dist)]
        want, want_aux = global_whole(torch, hs, spm, cfg,
                                      dist.grid()[0, 0], 2 * tokens)
        want = want.view(x.shape)
        ms = whole_ms = None
        if timer is not None:
            ms = timer.ms(lambda: L.moe_block(x, spm, cfg, dist), iters=5,
                          warmup=1)
            whole_ms = timer.ms(lambda: global_whole(
                torch, hs, spm, cfg, dist.grid()[0, 0], 2 * tokens),
                iters=5, warmup=1)
    same = bool(torch.equal(y, want)) and bool(torch.equal(aux, want_aux))
    err = (y.float() - want.float()).abs().max().item()
    moved = global_moved(torch, cfg, tokens)
    log(f"(b) {cfg.name} ({cfg.moe.parallelism}) moe_block on 2x2, T = "
        f"{2 * tokens}: branch {taken}; bitwise the dispatch on one "
        f"position: {same} (max_abs_err {err:.3e}); bytes copied into "
        f"(0, 0) {moved['before'][0]} before, {moved['after'][0]} after, "
        f"into the busiest position {moved['before'][1]} before, "
        f"{moved['after'][1]} after (stand-in count); the dispatch "
        + (f"{ms:.3f} ms vs {whole_ms:.3f} ms on one position"
           if ms is not None else "not timed (cpu)"))
    if taken != ["global"] or not same \
            or not bool(torch.isfinite(y.float()).all()):
        raise AssertionError(f"(b) {cfg.name}: the global dispatch differs "
                             f"from the one-position dispatch")
    return dict(same=same, ms=ms, whole_ms=whole_ms, moved=moved)


def chunked_pass(torch, params, cfg, prompts, first=None) -> tuple:
    """One pass of (c)'s path with fresh workers: each prompt through
    ``ChunkedPrefill`` — one ``advance()`` a 256-token chunk, ``done``
    only at the end, ``chunks_done`` = ⌈prompt / 256⌉ — then one paged
    decode step over them all. ``first``: the first tokens the decode
    starts from in place of the pass's own (the plain pass is fed the
    kernel pass's). The workers' ``_chunk_extend`` and ``_paged_call``
    are wrapped, on these instances only, to keep the logits they
    return. Returns (the ChunkedPrefills, each prompt's last prefill
    logits (P, V), the decode step's logits of the active slots (P, V),
    the step's output)."""
    import dataclasses

    from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                            PrefillWorker)
    from repro_torch.serving.request import ServingRequest
    pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=256)
    dw = DecodeWorker(params, cfg, max_batch=4, max_len=2048)
    seen = {"prefill": [], "decode": []}

    def keeping(fn, key):
        def call(*args):
            out = fn(*args)
            logits = out[0] if isinstance(out, tuple) else out
            seen[key].append(logits[:, -1].float())
            return out
        return call
    pw._chunk_extend = keeping(pw._chunk_extend, "prefill")
    dw._paged_call = keeping(dw._paged_call, "decode")
    cps, last = [], []
    for i, toks in enumerate(prompts):
        cp = pw.start(toks)
        while not cp.advance():
            if cp.done:
                raise AssertionError("(c) done before the last chunk")
        want = -(-len(toks) // 256)
        if not cp.done or cp.chunks_done != want \
                or cp.prompt_len != len(toks):
            raise AssertionError(f"(c) prompt {i}: chunks_done "
                                 f"{cp.chunks_done}, want {want}")
        last.append(seen["prefill"][-1][0])
        res = cp.result if first is None else dataclasses.replace(
            cp.result, first_token=first[i])
        dw.join(ServingRequest(req_id=i, tokens=toks, max_new=4), res)
        cps.append(cp)
    active = [i for i, sl in enumerate(dw.slots) if sl is not None]
    out = dw.step()
    return cps, torch.stack(last), seen["decode"][-1][active], out


def chunked_main_path(torch, device="cuda") -> dict:
    """(c): smollm-360m at full width through ``ChunkedPrefill`` and one
    paged decode step (``chunked_pass``); the main path's launches read
    right after. The same pass then runs under ``plain_attention()``,
    fed the kernel pass's first tokens: each prompt's last prefill
    logits and the decode step's logits within phase 5's 4 bf16 ulps of
    the plain ones, the first tokens equal wherever the plain top-2 gap
    decides them. Each drained prefill is held bit for bit against the
    blocking call of a fresh worker."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import plain_attention
    from repro_torch.serving.engine import HostKVPool, PrefillWorker
    cfg = get_config("smollm-360m")
    if device != "cuda":
        cfg = cfg.reduced()
    params = draw_params(torch, cfg, device)
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (700, 1536, 257)]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    zero_kernel_counts()
    cps, last, dec, out = chunked_pass(torch, params, cfg, prompts)
    sync()
    launches = kernel_counts()
    chunks = sum(cp.chunks_done for cp in cps)
    with plain_attention():
        _, last_p, dec_p, _ = chunked_pass(
            torch, params, cfg, prompts,
            first=[cp.result.first_token for cp in cps])
    sync()
    e_pre, close_pre = hold_serve(torch, "(c) chunked prefill, kernels vs "
                                  "plain", last, last_p, 4)
    e_dec, close_dec = hold_serve(torch, "(c) paged decode step, kernels "
                                  "vs plain", dec, dec_p, 4)
    exact = True
    for toks, cp in zip(prompts, cps):
        ref = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=256)(toks)
        got = cp.drain()
        exact &= got.first_token == ref.first_token \
            and bool(torch.equal(got.kv_k, ref.kv_k)) \
            and bool(torch.equal(got.kv_v, ref.kv_v))
    log(f"(c) {cfg.name}: prompts {[len(t) for t in prompts]} through "
        f"ChunkedPrefill: chunks_done {[cp.chunks_done for cp in cps]} "
        f"(= ceil(prompt / 256)); drained bit-exact with the blocking "
        f"call: {exact}; one paged decode step over {len(out)} slots; "
        f"against the same pass under plain_attention(): last prefill "
        f"logits {e_pre:.2f} ulps ({close_pre} first tokens too close to "
        f"call), decode logits {e_dec:.2f} ulps ({close_dec} too close) "
        f"(tol 4 bf16 ulps); launches flash_prefill "
        f"{launches['flash_prefill']} (= {cfg.n_layers} x {chunks} "
        f"chunks), paged_attention {launches['paged_attention']} (= "
        f"{cfg.n_layers} x 1 step)")
    if not exact or len(out) != 3:
        raise AssertionError("(c) the chunked prefill is not the blocking "
                             "one")
    if device == "cuda" and (
            launches["flash_prefill"] != cfg.n_layers * chunks
            or launches["paged_attention"] != cfg.n_layers):
        raise AssertionError(f"(c) launches {launches}")
    return dict(launches=launches, chunks=[cp.chunks_done for cp in cps],
                prefill_ulps=e_pre, decode_ulps=e_dec)


def exported_ops(torch, device="cuda") -> dict:
    """(c): each op ``repro_torch.kernels`` and its subpackages export,
    called once against its exported oracle on the same inputs: the two
    attention ops within 2e-2 (bf16), the SSD scan's y and final state
    within ``SSD_TOL`` of their scale (both fp32; ``ssd_naive_ref``
    beside it on a short prefix). Their launches are comparisons: the
    caller reads the main path's counts before."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.paged_attention import (
        paged_attention_layers_ref, paged_attention_ref,
        paged_decode_attention_layers)
    from repro_torch.kernels.ssd_scan import ssd_naive_ref, ssd_scan_ref
    g = torch.Generator(device=device).manual_seed(21)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=device).to(dtype)
    errs = {}
    q, k, v = rnd(1, 256, 16, 64), rnd(1, 512, 4, 64), rnd(1, 512, 4, 64)
    errs["flash_prefill_attention"] = (
        K.flash_prefill_attention(q, k, v, q_offset=256).float()
        - flash_prefill_ref(q, k, v, q_offset=256).float()).abs().max().item()
    B, H, KV, D, P, page = 4, 16, 4, 64, 33, 64
    table = torch.randperm(P - 1, generator=g, device=device)[:B * 8] \
        .add(1).view(B, 8).to(torch.int32)
    lens = torch.tensor([1, 200, 512, 333], dtype=torch.int32, device=device)
    qd, kp, vp = rnd(B, H, D), rnd(P, page, KV, D), rnd(P, page, KV, D)
    errs["paged_decode_attention"] = (
        K.paged_decode_attention(qd, kp, vp, table, lens).float()
        - paged_attention_ref(qd, kp, vp, table, lens).float()
    ).abs().max().item()
    qs, kps, vps = rnd(2, B, H, D), rnd(2, P, page, KV, D), \
        rnd(2, P, page, KV, D)
    errs["paged_decode_attention_layers"] = (
        paged_decode_attention_layers(qs, kps, vps, table, lens).float()
        - paged_attention_layers_ref(qs, kps, vps, table, lens).float()
    ).abs().max().item()
    b, s, h, pd, n = 1, 512, 8, 64, 64
    x, Bm, Cm = rnd(b, s, h, pd), rnd(b, s, n), rnd(b, s, n)
    dt = torch.nn.functional.softplus(rnd(b, s, h, dtype=torch.float32))
    A = -torch.exp(0.5 * rnd(h, dtype=torch.float32))
    y, st = K.ssd_scan_op(x, dt, A, Bm, Cm, chunk=256)
    yr, sr = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=256)
    yn, _ = ssd_naive_ref(x[:, :64], dt[:, :64], A, Bm[:, :64], Cm[:, :64])
    rel = lambda a, r: ((a.float() - r.float()).abs().max()
                        / r.float().abs().max()).item()
    errs["ssd_scan_op"] = max(rel(y, yr), rel(st, sr))
    errs["ssd_scan_ref vs ssd_naive_ref"] = rel(yr[:, :64], yn)
    log("(c) the exported ops against their exported oracles: "
        + json.dumps({k_: float(f"{e:.3e}") for k_, e in errs.items()})
        + f" (tol {TOL} bf16, {SSD_TOL} of the scale for the SSD scan)")
    for k_, e in errs.items():
        if e > (SSD_TOL if "ssd" in k_ else TOL) or e != e:
            raise AssertionError(f"(c) {k_} disagrees with its oracle")
    return errs


def e2e_placements(torch, timer, device="cuda") -> dict:
    """Phase 20: (a) prefill caches on their stripes, (b) the MoE global
    dispatch on the expert shards, (c) the main path through
    ``ChunkedPrefill``, a paged step and the exported ops."""
    from repro_torch.configs.base import get_config
    t0 = time.monotonic()
    cuda = device == "cuda"
    out = {}
    cfg, params = llama_cut(torch, device)
    out["llama"] = prefill_stripes(torch, cfg, params, device,
                                   seq=4096 if cuda else 256)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mcfg = get_config("mamba2-2.7b")
    if not cuda:
        mcfg = mcfg.reduced()
    mparams = draw_params(torch, mcfg, device)
    out["mamba"] = prefill_stripes(torch, mcfg, mparams, device,
                                   seq=4096 if cuda else 256)
    del mparams
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for name in ("qwen3-moe-235b-a22b", "mixtral-8x7b"):
        out[name] = moe_global_case(torch, timer, name, device,
                                    tokens=1024 if cuda else 128)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    out["main"] = chunked_main_path(torch, device)
    out["ops"] = exported_ops(torch, device)
    out["launches"] = {k: out["llama"]["launches"][k]
                       + out["mamba"]["launches"][k]
                       + out["main"]["launches"][k]
                       for k in out["main"]["launches"]}
    out["seconds"] = time.monotonic() - t0
    return out


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
        f"D={d} {lib.paged_attention_smem_bytes(d)} B"
        for d in (32, 64, 96, 128)))

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

    phase("12 the MoE family: qwen3-moe-235b-a22b and mixtral-8x7b")
    torch.cuda.empty_cache()
    moe_kernel_cases(torch, timer)
    qwen = e2e_qwen3_moe(torch)
    torch.cuda.empty_cache()
    mix = e2e_mixtral(torch)
    log(f"phase 12 launches: qwen3-moe {qwen['launches']}, mixtral "
        f"{mix['launches']}; routing choices differing kernel vs plain: "
        f"qwen3-moe {qwen['routing_differences']}, mixtral "
        f"{mix['routing_differences']}")

    phase("13 the remaining families: whisper, internvl2, qwen3-14b, jamba")
    torch.cuda.empty_cache()
    t13 = time.monotonic()
    cases = family_kernel_cases(torch, timer)
    log("phase 13 (a): " + json.dumps({k: {f: round(v, 5) if isinstance(
        v, float) else v for f, v in r.items()} for k, r in cases.items()}))
    wh = e2e_whisper(torch)
    torch.cuda.empty_cache()
    vl = e2e_internvl2(torch)
    torch.cuda.empty_cache()
    qw = serve_dense(torch, "qwen3-14b")
    torch.cuda.empty_cache()
    jb = e2e_jamba(torch)
    log(f"phase 13 launches: whisper flash_prefill {wh['launches']}, "
        f"internvl2 flash_prefill {vl['launches']}, qwen3-14b "
        f"{qw['launches']}, jamba {jb['launches']}; phase 13 took "
        f"{time.monotonic() - t13:.1f} s")

    phase("14 the multi-device serving paths: the (data, model) decode "
          "mesh and CPP, every position on the card")
    gc.collect()                # earlier phases' reference cycles
    torch.cuda.empty_cache()
    t14 = time.monotonic()
    op14 = check_sharded_op(torch, timer)
    cfg14, params14 = llama_cut(torch)
    mesh14 = e2e_mesh(torch, params14, cfg14)
    cpp14 = e2e_cpp(torch, params14, cfg14)
    del params14
    log(f"phase 14 launches: mesh runs " + ", ".join(
        f"{k} {v['launches']}" for k, v in mesh14.items()
        if isinstance(v, dict) and "launches" in v)
        + f"; serve --mesh 1x1 {mesh14['serve_launches']}; cpp flash_prefill "
        f"{cpp14['launches']}; the sharded op {op14['ms']:.4f} ms against "
        f"the unsharded kernel's {op14['whole_ms']:.4f} ms; phase 14 took "
        f"{time.monotonic() - t14:.1f} s")

    phase("15 training on the card: card vs CPU, smollm-360m, "
          "train_e2e's smollm-100m, llama2-70b Adafactor, a profiled step")
    gc.collect()
    torch.cuda.empty_cache()
    t15 = e2e_training(torch)
    log(f"phase 15: no kernel launched in any train step "
        f"({kernel_counts()}); phase 15 took {t15['seconds']:.1f} s")

    phase("16 head dim 96: phi3-mini-3.8b and qwen2.5-3b, the last dense "
          "configs")
    gc.collect()
    torch.cuda.empty_cache()
    t16 = e2e_head_dim_96(torch, timer)
    log(f"phase 16 launches: phi3-mini {t16['phi3']['launches']}, "
        f"qwen2.5-3b {t16['qwen25']['launches']}; the sharded op at D=96 "
        f"{t16['sharded']['ms']:.4f} ms against the unsharded kernel's "
        f"{t16['sharded']['whole_ms']:.4f} ms; phase 16 took "
        f"{t16['seconds']:.1f} s")

    phase("17 sharded training and the sharded MoE dispatch: the (2, 2) "
          "mesh on the card")
    gc.collect()
    torch.cuda.empty_cache()
    t17 = e2e_sharded_training(torch, timer)
    log(f"phase 17 launches: flash_prefill {t17['llama']['launches']} "
        f"(llama2-70b) + {t17['qwen3']['launches']} (qwen3-moe) in the "
        f"sharded prefill steps; none in training, whose loss (c), (d) "
        f"is the vocab-parallel cross-entropy over each row's model "
        f"positions; phase 17 took {t17['seconds']:.1f} s")

    phase("18 the context-parallel serve step and the tensor-parallel "
          "Mamba2 mixer: (1, 4) and (2, 2) meshes on the card")
    gc.collect()
    torch.cuda.empty_cache()
    t18 = e2e_serve_mesh(torch, timer)
    k18 = t18["c"]["kernel"]
    log(f"phase 18 launches: ssd_scan {t18['launches']} in mamba2-2.7b's "
        f"sharded prefill step (h = 40 a launch: {k18['ms']:.4f} ms, plain "
        f"{k18['plain_ms']:.4f} ms, bound {k18['bound_ms']:.5f} ms); none "
        f"in the serve steps (plain per-stripe attention, ssd_decode); "
        f"phase 18 took {t18['seconds']:.1f} s")

    phase("19 the dry run: on the card's host, and its predictions against "
          "the card")
    gc.collect()
    torch.cuda.empty_cache()
    t19 = e2e_dryrun(torch)
    log(f"phase 19 launches: flash_prefill {t19['launches']['flash_prefill']}"
        f", ssd_scan {t19['launches']['ssd_scan']} in the predicted steps; "
        f"phase 19 took {t19['seconds']:.1f} s ({smi})")

    phase("20 placements: prefill caches on their stripes, the MoE global "
          "dispatch on the expert shards; the main path through "
          "ChunkedPrefill")
    gc.collect()
    torch.cuda.empty_cache()
    t20 = e2e_placements(torch, timer)
    log(f"phase 20 launches: {json.dumps(t20['launches'])}; phase 20 took "
        f"{t20['seconds']:.1f} s ({smi})")

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:76",
             launches=launches["paged_attention"]
             + t20["launches"]["paged_attention"], **paged),
        dict(name="flash_prefill", route="cuda",
             source="src/repro_torch/csrc/flash_prefill.cu",
             replaces="src/repro/kernels/flash_prefill/kernel.py:83",
             launches=launches["flash_prefill"] + t17["launches"]
             + t19["launches"]["flash_prefill"]
             + t20["launches"]["flash_prefill"], **pre),
        dict(name="paged_attention_layers", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:157",
             launches=layers_launches, **layers),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:79",
             launches=ssd_launches + t18["launches"]
             + t19["launches"]["ssd_scan"] + t20["launches"]["ssd_scan"],
             **ssd),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
