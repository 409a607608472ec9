"""Where a serving step's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile \
        [--arch mamba2-2.7b | qwen3-moe-235b-a22b | qwen3-14b
                | phi3-mini-3.8b | qwen2.5-3b]

smollm-360m (the default), qwen3-14b, phi3-mini-3.8b, qwen2.5-3b and
qwen3-moe-235b-a22b: prefill the launcher's workload (8 requests of the
generated trace, prompts capped at 1536 tokens) into a full decode batch
at full width (random weights, seed 0), then, under ``torch.profiler``,
run five decode steps and five 256-token prefill chunks at offset 1280.
qwen3-moe runs 4 of its 94 layers (94 layers are 470 GB of bf16 weights;
4 are 22.4 GB), the others all of theirs (qwen3-14b 30.4 GB); a model of
more than 1 B parameters draws its weights on the card. mamba2-2.7b:
prefills the workload's first prompt to 1024 tokens at full width, then
profiles five 512-token extends from that state (what
``StateCheckpointWorker`` runs per block) and five one-token decode
steps. For each call it prints the host wall time
(synchronised), the device busy time (the sum of the kernels' device
time), the device's idle share, the kernel count, and the kernels that
took the most device time. GPU only.

``--train``: one training step of ``--arch`` (smollm-360m by default, at
full width and depth, AdamW, remat as the config has it) on a batch of
8 × 512 tokens of ``SyntheticLM``, profiled the same way, and the plain
attention's share of the step: its forward and backward at the step's
per-layer shapes (plus the forward again under remat), timed alone with
CUDA events, times the layer count.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
from repro_torch.launch.serve import MAX_LEN, make_payloads
from repro_torch.launch.steps import make_train_step
from repro_torch.models.layers import _grouped, chunked_attention, qh2kv_map
from repro_torch.models.transformer import (decode_step, init_caches,
                                            init_params, prefill)
from repro_torch.serving.engine import DecodeWorker, HostKVPool, PrefillWorker
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest
from repro_torch.training.loop import batch_to
from repro_torch.training.optim import make_optimizer

STEPS = 5      # profiled calls of each kind
TOP = 12       # kernels listed per kind
# depth of a config too deep for one card (``chip_smoke.py`` phase 12's)
DEPTH = {"qwen3-moe-235b-a22b": 4}


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


def _profile_ssm(cfg, device) -> None:
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    prompt = make_payloads(12, cfg.vocab_size, max_new=16, seed=0)[0][1]
    toks = torch.as_tensor(np.asarray(prompt[:1536], np.int64)[None],
                           device=device)
    _, caches = prefill(params, toks[:, :1024], cfg)
    print(f"{cfg.name}: state after 1024 prompt tokens; "
          f"{torch.cuda.get_device_name(0)}")
    _report("extend (512 tokens from the state)",
            lambda: decode_step(params, toks[:, 1024:1536], caches, cfg),
            STEPS, TOP)
    _, caches = decode_step(params, toks[:, 1024:1536], caches, cfg)
    _report("decode step (one token from the state)",
            lambda: decode_step(params, toks[:, 1535:1536], caches, cfg),
            STEPS, TOP)


def _event_ms(fn, n: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``n`` calls, after one warm
    call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def attention_ms(cfg, batch: int, seq: int, device) -> dict:
    """The plain causal attention of one training step at ``cfg``'s
    per-layer shapes: forward and backward (and, under remat, the
    recomputed forward) of ``chunked_attention``, timed alone, times the
    attention layer count."""
    g = torch.Generator(device=device).manual_seed(0)
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    qh2kv = None if _grouped(cfg) else qh2kv_map(cfg.n_heads, KV, Hp, device)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).bfloat16() \
            .requires_grad_(True)

    q, k, v = rand(batch, seq, Hp, Dh), rand(batch, seq, KV, Dh), \
        rand(batch, seq, KV, Dh)
    d_o = torch.randn((batch, seq, Hp, Dh), generator=g,
                      device=device).bfloat16()

    def fwd():
        with torch.no_grad():
            chunked_attention(q, k, v, 0, cfg.sliding_window, qh2kv=qh2kv)

    def fwd_bwd():
        o = chunked_attention(q, k, v, 0, cfg.sliding_window, qh2kv=qh2kv)
        torch.autograd.grad(o, (q, k, v), d_o)

    f_ms, fb_ms = _event_ms(fwd, STEPS), _event_ms(fwd_bwd, STEPS)
    per_layer = fb_ms + (f_ms if cfg.remat else 0.0)
    return dict(forward_ms=f_ms, forward_backward_ms=fb_ms,
                step_ms=per_layer * cfg.attention_layers)


def profile_train_step(cfg, params, opt_state, batch: dict, *,
                       n: int = 3, top: int = TOP) -> dict:
    """``_report`` of one train step (``make_train_step(cfg)``) on
    ``batch``, plus ``attention_ms`` at its shapes; returns the wall and
    device-busy µs, kernels per step, the attention's ms and its share
    of the device-busy time."""
    step = make_train_step(cfg)
    r = _report("train step", lambda: step(params, opt_state, batch),
                n, top)
    B, S = batch["tokens"].shape
    attn = attention_ms(cfg, B, S, batch["tokens"].device)
    r.update(attention=attn,
             attention_share=attn["step_ms"] * 1e3 / r["busy_us"])
    print(f"  plain attention: {attn['forward_backward_ms']:.3f} ms forward "
          f"+ backward a layer ({attn['forward_ms']:.3f} ms forward), "
          f"{attn['step_ms']:.2f} ms a step: {r['attention_share']:.3f} of "
          f"the step's device-busy time")
    return r


def _profile_train(cfg, device) -> None:
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    init, _ = make_optimizer(cfg.optimizer)
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 8, 512)).batch(0),
                     device)
    print(f"{cfg.name} ({cfg.n_layers} layers, {cfg.optimizer}, remat "
          f"{cfg.remat}): one train step of 8 x 512 tokens; "
          f"{torch.cuda.get_device_name(0)}")
    profile_train_step(cfg, params, init(params), batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m",
                    choices=("smollm-360m", "mamba2-2.7b",
                             "qwen3-moe-235b-a22b", "qwen3-14b",
                             "phi3-mini-3.8b", "qwen2.5-3b"))
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of serving")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=DEPTH.get(args.arch,
                                                      cfg.n_layers))
    if args.train:
        _profile_train(cfg, device)
        return 0
    if cfg.kind == "ssm":
        _profile_ssm(cfg, device)
        return 0
    # a large model's draw stays on the card (its host copy would hold
    # tens of GB: ~35 for qwen3-moe's fp32 draw at 4 layers)
    big = cfg.param_count() > 1e9
    gen = torch.Generator(device=device if big else "cpu").manual_seed(0)
    params = init_params(cfg, gen, device)
    pool = HostKVPool()
    pp = DevicePagePool(cfg, n_pages=1 + 9 * (MAX_LEN // 64), page_tokens=64,
                        device=device)
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=256, page_pool=pp)
    dw = DecodeWorker(params, cfg, max_batch=8, max_len=MAX_LEN, page_pool=pp)
    payloads = make_payloads(12, cfg.vocab_size, max_new=MAX_LEN, seed=0)
    for rid, toks, _, sess in payloads[:8]:
        dw.join(ServingRequest(rid, toks, MAX_LEN - len(toks)), pw(toks))
    lens = [len(t) for _, t, _, _ in payloads[:8]]
    print(f"{cfg.name} ({cfg.n_layers} layers): decode batch of "
          f"{dw.n_active} slots at depths {lens}; "
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
