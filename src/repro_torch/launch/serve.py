"""Serving launcher of the port: a single-host Mooncake prefill/decode
pair on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --requests 16 [--trace trace.jsonl] \
        [--ssd-blocks 64 --ssd-dir D [--ssd-mode overlap]] [--peer-ssd-dir P]
        [--mesh DxM]

The counterpart of ``python -m repro.launch.serve`` for what the port
covers: the reduced model of ``--arch`` (a uniform attention stack of
the registry: smollm-360m, qwen2.5-3b, qwen3-14b, phi3-mini-3.8b,
llama2-70b, internvl2-26b as a text-only stack, qwen3-moe-235b-a22b,
mixtral-8x7b; a prompt longer than a windowed model's sliding window is
refused, and so are the models whose state the KV workers would drop:
mamba2-2.7b, jamba-1.5-large-398b, whisper-large-v3), a ``HostKVPool``
(flat DRAM by default; with ``--ssd-blocks`` a DRAM tier over an SSD
tier, file-backed in ``--ssd-dir`` and loaded per ``--ssd-mode``),
chunked prefill (``prefill_chunk=256``) staged into a shared
``DevicePagePool`` (64-token pages), and paged continuous-batching
decode, all driven by the ``ServingLoop`` with admission backpressure
and preemption (``--no-loop`` keeps the phase-at-a-time driver). With
``--peer-ssd-dir``, blocks a PREVIOUS run demoted to its store become
fetchable as a peer node's through a shared ``GlobalBlockDirectory``
(the global pool across launcher runs — same seed, same hash chains).
With ``--mesh DxM`` the paged decode engine shards over a (data, model)
mesh of the first D·M GPUs: decode slots and page-pool banks split over
the data axis, KV-head stripes over the model axis (for M > 1 the
reduced arch is adjusted to grouped GQA, with a printed note).
Weights are random, from ``--seed``. ``serve()`` is the body, for
callers that bring their own config and device (the full-width smoke
run on the GPU, the CPU tests).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time
from contextlib import ExitStack, closing
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.directory import GlobalBlockDirectory
from repro_torch.core.trace import TraceSpec, generate_trace, load_trace
from repro_torch.data.pipeline import realize_request_tokens
from repro_torch.launch.mesh import make_decode_mesh, parse_mesh_arg
from repro_torch.models.transformer import init_params, paged_shard_reason
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillWorker, kv_worker_refusal)
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest

MAX_LEN = 2048
PROMPT_CAP = 1536


def make_payloads(n_requests: int, vocab: int, *, max_new: int, seed: int,
                  trace: Optional[str] = None) -> list:
    """(req_id, tokens, max_new, session) per request: a trace file or
    the generated workload, lengths capped at 1536 tokens."""
    if trace:
        reqs = load_trace(trace, limit=n_requests)
    else:
        spec = TraceSpec(n_requests=n_requests, duration_ms=10_000,
                         seed=seed, max_input_tokens=2048,
                         chat_turn_mu=5.0, doc_len_mu=6.5)
        reqs = generate_trace(spec)[:n_requests]
    for r in reqs:
        r.input_length = min(r.input_length, PROMPT_CAP)
        r.hash_ids = r.hash_ids[:max(r.input_length // 512, 1)]
    return [(r.req_id, realize_request_tokens(r, vocab),
             min(max_new, max(r.output_length, 2)),
             r.hash_ids[0] if r.hash_ids else None) for r in reqs]


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def serve(cfg: ModelConfig, device="cuda", *, params=None,
          requests: int = 16, trace: Optional[str] = None,
          max_batch: int = 8, max_new: int = 16, no_loop: bool = False,
          prefill_workers: int = 1, tbt_budget: Optional[float] = None,
          chunks_per_iter: int = 1, admission: str = "predictive",
          preempt: bool = True, restore_mode: str = "auto",
          pool_blocks: int = 4096, width_buckets: int = 1,
          decode_substrate: str = "paged", ssd_blocks: int = 0,
          ssd_dir: Optional[str] = None, ssd_mode: str = "overlap",
          peer_ssd_dir: Optional[str] = None, seed: int = 0, mesh=None,
          log=print) -> dict:
    """Serve ``requests`` requests end to end; returns a summary dict
    (counts, times, per-request token streams, the tiers' counters).
    ``mesh``: a (data, model) ``launch.mesh.Mesh`` the paged decode step
    shards over (prefill runs on ``device``)."""
    reason = kv_worker_refusal(cfg)
    if reason:
        raise ValueError(f"serve() drives the KV serving workers: {reason}")
    if mesh is not None and decode_substrate != "paged":
        raise ValueError("a mesh shards the PAGED decode engine; drop "
                         "decode_substrate='dense'")
    mesh_d = 1 if mesh is None else int(mesh.shape.get("data", 1))
    device = resolve_device(device)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = init_params(cfg, gen, device)
    # the pools own a prefetch thread and the store's file: closing them
    # (pool first, then the peer) joins the thread and flushes the store
    with ExitStack() as stack:
        directory = peer_pool = None
        if peer_ssd_dir:
            directory = GlobalBlockDirectory()
            # restart recovery re-indexes the peer's flushed blocks; bind()
            # publishes them, so this run's misses can fetch across "nodes"
            peer_pool = stack.enter_context(closing(HostKVPool(
                capacity_blocks=8, ssd_capacity_blocks=None,
                ssd_dir=peer_ssd_dir, directory=directory, node_id=1)))
        pool = stack.enter_context(closing(HostKVPool(
            capacity_blocks=pool_blocks, ssd_capacity_blocks=ssd_blocks,
            ssd_dir=ssd_dir, directory=directory, node_id=0)))
        if peer_pool is not None:
            pool.add_peer(1, peer_pool)
        page_pool = None
        if decode_substrate == "paged":
            per_seq = MAX_LEN // 64
            page_pool = DevicePagePool(
                cfg, n_pages=1 + (max_batch // mesh_d + 1) * per_seq,
                page_tokens=64, device=device, mesh=mesh)
        pws = [PrefillWorker(params, cfg, pool, prefill_chunk=256,
                             ssd_mode=ssd_mode, page_pool=page_pool)]
        dw = DecodeWorker(params, cfg, max_batch=max_batch, max_len=MAX_LEN,
                          substrate=decode_substrate, page_pool=page_pool,
                          width_buckets=width_buckets)
        payloads = make_payloads(requests, cfg.vocab_size, max_new=max_new,
                                 seed=seed, trace=trace)
        t_submit: dict[int, float] = {}
        outputs: dict[int, list] = {}
        token_t: dict[int, list] = {}
        t0 = time.monotonic()
        ls: dict = {}
        if not no_loop:
            pws += [PrefillWorker(params, cfg, pool, prefill_chunk=256,
                                  ssd_mode=ssd_mode, page_pool=page_pool)
                    for _ in range(prefill_workers - 1)]
            loop = ServingLoop(pws, dw, tbt_budget_s=tbt_budget,
                               chunks_per_iter=chunks_per_iter,
                               max_queue=max(requests, 8), admission=admission,
                               preempt=preempt, restore_mode=restore_mode)

            def feeder():
                for rid, toks, mn, sess in payloads:
                    t_submit[rid] = time.monotonic()
                    loop.submit(ServingRequest(req_id=rid, tokens=toks,
                                               max_new=mn, session=sess))
                loop.close_intake()

            th = threading.Thread(target=feeder, name="repro-loop-feeder")
            th.start()
            ls = loop.run()
            th.join()
            done = ls["completed"]
            for rid, o in loop.outputs.items():
                outputs[rid] = list(o.tokens)
                token_t[rid] = list(o.token_t)
            log(f"loop: {ls['iterations']} iterations, {ls['decode_steps']} "
                f"decode steps, {ls['prefill_chunks']} prefill chunks "
                f"interleaved, {ls['rejected']} rejected by '{admission}' "
                f"backpressure, {ls['preemptions']} preemptions "
                f"({ls['restores_reload']} reload / {ls['restores_recompute']} "
                f"recompute restores)")
        else:
            done = 0
            queue = list(payloads)
            pw = pws[0]
            while queue or dw.n_active:
                while queue and dw.n_active < max_batch:
                    rid, toks, mn, sess = queue.pop(0)
                    t_submit[rid] = time.monotonic()
                    pres = pw(toks, session=sess)
                    dw.join(ServingRequest(req_id=rid, tokens=toks, max_new=mn,
                                           session=sess), pres)
                    outputs[rid] = [pres.first_token]
                    token_t[rid] = [time.monotonic()]
                for rid, tok, fin in dw.step():
                    outputs[rid].append(tok)
                    token_t[rid].append(time.monotonic())
                    done += fin
        dt = time.monotonic() - t0
        total_new = sum(len(t) for t in outputs.values())
        ttft = [token_t[r][0] - t_submit[r] for r in token_t if token_t[r]]
        gaps = [b - a for ts in token_t.values() for a, b in zip(ts, ts[1:])]
        st = {k: sum(w.stats()[k] for w in pws) for k in pws[0].stats()}
        summary = dict(
            completed=done, submitted=len(payloads), seconds=dt,
            new_tokens=total_new, decode_tok_s=total_new / dt if dt else 0.0,
            ttft_p50_s=_pct(ttft, 50), tbt_p50_s=_pct(gaps, 50),
            tbt_p99_s=_pct(gaps, 99), prefill_chunks=st["chunks"],
            reused_blocks=st["reused_blocks"],
            ssd_loaded_blocks=st["ssd_loaded_blocks"],
            overlapped_requests=st["overlapped_requests"],
            fallback_blocks=st["fallback_blocks"],
            peer_blocks=st["peer_blocks"], skipped_blocks=st["skipped_blocks"],
            overlap_plans=[p for w in pws for p in w.overlap_plans],
            paged_calls=dw.counters["paged_calls"],
            decode_steps=dw.counters["steps"], loop=ls, outputs=outputs,
            payloads=payloads)
        log(f"served {done} requests in {dt:.1f}s — {total_new / dt:.1f} tok/s "
            f"decode, TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms, TBT p50/p99 "
            f"{summary['tbt_p50_s'] * 1e3:.1f}/{summary['tbt_p99_s'] * 1e3:.1f} "
            f"ms, pool: {pool.n_blocks} blocks resident, prefix reuse "
            f"{st['reused_blocks']} blocks")
        if page_pool is not None:
            ps = page_pool.stats()
            ds = dw.stats()
            if mesh is not None:
                log(f"mesh {mesh_d}x{page_pool.n_model}: "
                    f"{page_pool.n_banks} page banks "
                    f"× {page_pool.bank_pages} pages (capacity "
                    f"{ps['capacity']} logical pages), "
                    f"{dw.slots_per_bank} slots per data shard")
            log(f"paged substrate: {page_pool.used_pages}/{page_pool.n_pages} "
                f"pages held, {ps['pages_written']} written, "
                f"{ps['shared_adoptions']} shared-prefix adoptions, "
                f"{ps['cow_copies']} COW, {ds['zero_copy_joins']} zero-copy "
                f"joins, {ps['pages_exported']} pages spilled / "
                f"{ps['pages_imported']} imported")
        if pool.store is not None:
            pool.store.flush()      # what close() would write, counted here
            s = pool.store.stats()
            summary["store"] = s
            log(f"ssd store: {s['blocks']} blocks on disk "
                f"({s['file_bytes'] >> 10} KiB), {s['n_flushes']} write-back "
                f"flushes, {s['layer_reads']} layer reads, "
                f"{s['read_failures']} read failures; overlapped "
                f"{st['overlapped_requests']} prefills, "
                f"{st['ssd_loaded_blocks']} blocks loaded, "
                f"{st['fallback_blocks']} fell back to recompute")
        summary.update(peer_blocks_fetched=pool.peer_blocks_fetched,
                       peer_fetch_failures=pool.peer_fetch_failures,
                       fallback_reasons=dict(pool.fallback_reasons))
        if peer_pool is not None:
            summary["directory"] = directory.stats()
            log(f"global pool: fetched {pool.peer_blocks_fetched} blocks "
                f"off the peer store ({pool.peer_fetch_failures} failures, "
                f"fallbacks {summary['fallback_reasons']}); directory "
                f"{summary['directory']}")
        return summary


def mesh_from_args(ap: argparse.ArgumentParser, args, cfg: ModelConfig,
                   max_batch: Optional[int] = None):
    """``--mesh DxM`` → (cfg, decode mesh or None), with the reference
    launchers' checks and messages: the paged substrate only; for a
    model axis > 1 the reduced arch adjusted to grouped GQA (16 query
    heads over max(4, M) KV heads) when its own heads cannot stripe;
    ``max_batch`` (when given) divisible by the data axis."""
    if not args.mesh:
        return cfg, None
    if args.decode_substrate != "paged":
        ap.error("--mesh shards the PAGED decode engine; drop "
                 "--decode-substrate dense")
    mesh_d, mesh_m = parse_mesh_arg(args.mesh)
    if mesh_m > 1 and paged_shard_reason(cfg, mesh_m, mesh_d):
        kv = max(4, mesh_m)
        if 16 % kv or kv % mesh_m:
            ap.error(f"--mesh model axis {mesh_m} has no grouped-GQA "
                     f"head layout")
        print(f"--mesh {args.mesh}: adjusting the reduced arch to "
              f"grouped GQA (n_heads=16, n_kv_heads={kv}) so KV heads "
              f"stripe over the model axis")
        cfg = dataclasses.replace(cfg, n_heads=16, n_kv_heads=kv)
    reason = paged_shard_reason(cfg, mesh_m, mesh_d)
    if reason:
        ap.error(f"--mesh {args.mesh}: {reason}")
    if max_batch is not None and max_batch % mesh_d:
        ap.error(f"--max-batch {max_batch} must divide over the "
                 f"mesh data axis ({mesh_d})")
    return cfg, make_decode_mesh(mesh_d, mesh_m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m",
                    help="a registered uniform attention stack, served at "
                         "its reduced size: smollm-360m, qwen2.5-3b, "
                         "qwen3-14b, phi3-mini-3.8b, llama2-70b, "
                         "internvl2-26b (text only), qwen3-moe-235b-a22b, "
                         "mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-loop", action="store_true",
                    help="phase-at-a-time driver (full prefill + join + "
                         "decode) instead of the interleaved serving loop")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="N PrefillWorkers feeding the loop's decode batch")
    ap.add_argument("--tbt-budget", type=float, default=None,
                    help="loop TBT budget in seconds: fit prefill chunks "
                         "into the slack it leaves per decode step "
                         "(default: deterministic chunks-per-iter mode)")
    ap.add_argument("--chunks-per-iter", type=int, default=1,
                    help="prefill chunks between decode steps when no "
                         "--tbt-budget is given")
    ap.add_argument("--admission", default="predictive",
                    choices=("baseline", "early", "predictive"),
                    help="backpressure policy evaluated at submit()")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable decode preemption")
    ap.add_argument("--restore-mode", default="auto",
                    choices=("auto", "reload", "recompute"),
                    help="how preempted victims restore")
    ap.add_argument("--pool-blocks", type=int, default=4096)
    ap.add_argument("--ssd-blocks", type=int, default=0,
                    help="SSD-tier capacity in blocks (0 = flat DRAM pool)")
    ap.add_argument("--ssd-dir", default=None,
                    help="directory for the file-backed SSD block store; "
                         "with --ssd-blocks, demoted KV really hits disk")
    ap.add_argument("--ssd-mode", default="overlap",
                    choices=("blocking", "overlap"),
                    help="how SSD-resident prefixes load: synchronously, or "
                         "overlapped with head-chunk recompute (§5.2)")
    ap.add_argument("--peer-ssd-dir", default=None,
                    help="a PEER node's SSD store directory (e.g. left by a "
                         "previous run): its blocks join a shared "
                         "GlobalBlockDirectory and local misses resolve to "
                         "cross-node fetches")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="shard the paged decode engine over a "
                         "(data, model) device mesh, e.g. 2x2: decode "
                         "slots and page-pool banks split over the data "
                         "axis, KV-head stripes over the model axis. "
                         "Needs data*model GPUs and, for model>1, a "
                         "grouped-GQA head layout (the arch's heads are "
                         "adjusted with a printed note if required)")
    ap.add_argument("--width-buckets", type=int, default=1,
                    help="per-step block-table width buckets (>1 runs "
                         "shallow slots on narrower tables instead of "
                         "padding to the deepest; single-device only)")
    ap.add_argument("--decode-substrate", default="paged",
                    choices=("paged", "dense"),
                    help="decode KV substrate: block-table pages (default) "
                         "or the dense per-slot arena (exactness oracle)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    reason = kv_worker_refusal(cfg)
    if reason:
        ap.error(f"--arch {args.arch}: {reason}")
    cfg, mesh = mesh_from_args(ap, args, cfg, args.max_batch)
    serve(cfg, "cuda", mesh=mesh, requests=args.requests,
          trace=args.trace, max_batch=args.max_batch, max_new=args.max_new,
          no_loop=args.no_loop, prefill_workers=args.prefill_workers,
          tbt_budget=args.tbt_budget, chunks_per_iter=args.chunks_per_iter,
          admission=args.admission, preempt=not args.no_preempt,
          restore_mode=args.restore_mode, pool_blocks=args.pool_blocks,
          width_buckets=args.width_buckets,
          decode_substrate=args.decode_substrate,
          ssd_blocks=args.ssd_blocks, ssd_dir=args.ssd_dir,
          ssd_mode=args.ssd_mode, peer_ssd_dir=args.peer_ssd_dir,
          seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
