#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. the build of every hand-written kernel (one nvcc per source, all at
     once) and what ptxas reports for each;
  3. the paged decode kernel against its plain PyTorch version on the
     card at the serving path's shapes (smollm-360m: B=8 slots, 16 padded
     query heads over 5 KV heads, D=64, 64-token pages, 32-page tables,
     ragged lengths, a poisoned null page) plus one grouped case;
  4. the chunked-prefill kernel against its plain version (256-token
     chunks at offsets 0/256/1280 against a 1536-token cache, and a
     ragged 131-token tail chunk);
  5. end to end: the launcher's body serves the generated workload at the
     full width of smollm-360m (32 layers, random weights from seed 0)
     through the serving loop with predictive admission, and every kernel
     launch is counted; then one request is teacher-forced through the
     kernel path and through the plain versions on the card.
Then one JSON line of per-kernel numbers, the nvidia-smi line, and the
result line. Times are CUDA-event times with the L2 cache flushed before
every launch; bounds use the H100 SXM peaks (3.35 TB/s, 989 TFLOP/s bf16).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
BF16_FLOP_S = 989e12        # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2                  # kernel vs plain, bf16 (tests/test_kernels.py)


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
    Python wrapper's host time between them."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)       # ~25 ms at H100 clocks
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
    table = torch.zeros(B, max_pages, dtype=torch.int32)
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
    return q, kp, vp, table, lens_t, m


def check_paged(torch, timer, name, case, main: bool):
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ops import grouped_map
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    q, kp, vp, table, lens, m = case
    B, H, D = q.shape
    KV = kp.shape[2]
    mk = m if m is not None else grouped_map(H, KV, q.device)
    out = paged_attention(q, kp, vp, table, lens, mk)
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, table, lens, qh2kv=m)
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    log(f"paged[{name}]: B={B} H={H} KV={KV} D={D} lens={lens.tolist()} "
        f"max_abs_err={err:.3e} (tol {TOL}) finite={finite}")
    if not (err <= TOL and finite):
        raise AssertionError(f"paged decode kernel disagrees ({name})")
    if not main:
        return None
    ms = timer.ms(lambda: paged_attention(q, kp, vp, table, lens, mk))
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
                  seed, main: bool):
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, Sq, H, D, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, Sk, KV, D, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, Sk, KV, D, generator=g, device="cuda").bfloat16()
    k[:, q_offset + Sq:] = 1e4        # keys past the chunk: never read
    v[:, q_offset + Sq:] = -1e4
    m = torch.tensor(qh2kv, dtype=torch.int32, device="cuda")
    out = flash_prefill(q, k, v, m, q_offset=q_offset)
    torch.cuda.synchronize()
    ref = flash_prefill_ref(q, k, v, q_offset=q_offset, qh2kv=m)
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    log(f"prefill[{name}]: Sq={Sq} Sk={Sk} q_offset={q_offset} H={H} KV={KV} "
        f"D={D} max_abs_err={err:.3e} (tol {TOL}) finite={finite}")
    if not (err <= TOL and finite):
        raise AssertionError(f"prefill kernel disagrees ({name})")
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

def teacher_forced(torch, params, cfg, prompt, stream, chunk=256, page=64):
    """Logits of every position a served stream was sampled from: the
    first token's (chunked prefill) and each decode step's (paged)."""
    from repro_torch.models.transformer import (decode_step,
                                                decode_step_paged,
                                                init_caches)
    from repro_torch.serving.engine import stage_run
    from repro_torch.serving.paged_cache import DevicePagePool
    dev = params["embed"].device
    S = len(prompt)
    t = torch.as_tensor(prompt[None, :].astype("int64"), device=dev)
    caches = init_caches(cfg, 1, S, device=dev)
    for lo in range(0, S, chunk):
        logits, caches = decode_step(params, t[:, lo:lo + chunk], caches, cfg)
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


def end_to_end(torch):
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
    return launches


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
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

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

    phase("4 chunked-prefill kernel vs plain (card)")
    pre = None
    for off, sq, sk in ((0, 256, 1536), (256, 256, 1536), (1280, 256, 1536),
                        (1280, 131, 1411)):
        r = check_prefill(torch, timer, f"off{off}-sq{sq}", Sq=sq, Sk=sk,
                          q_offset=off, H=16, KV=5, D=64, qh2kv=smollm_map,
                          seed=off + sq, main=(off == 1280 and sq == 256))
        pre = r or pre

    phase("5 end to end, smollm-360m full width")
    launches = end_to_end(torch)

    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:76",
             launches=launches["paged_attention"], **paged),
        dict(name="flash_prefill", route="cuda",
             source="src/repro_torch/csrc/flash_prefill.cu",
             replaces="src/repro/kernels/flash_prefill/kernel.py:83",
             launches=launches["flash_prefill"], **pre),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
