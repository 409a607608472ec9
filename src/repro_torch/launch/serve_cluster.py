"""Disaggregated serving cluster of the port (§3 workflow, executable) —
the counterpart of the reference's ``examples/serve_cluster.py``.

TWO prefill workers over their own host KVCache pools and TWO
continuous-batching decode workers share one ``DevicePagePool``; a
Conductor (Algorithm 1) in front decides, per request, which prefill
instance serves it (cache-aware + balancing, priced by the ``CostModel``
and the ``Messenger``) and which decode instance it joins. Requests come
from a generated Mooncake-format trace, realised to tokens whose block
structure matches the hash chains, so the engine's measured prefix reuse
equals the trace's.

    python -m repro_torch.launch.serve_cluster [--requests 24]
    python -m repro_torch.launch.serve_cluster --ssd-blocks 64 \\
        --ssd-dir D --dram-blocks 8 --global-pool
    python -m repro_torch.launch.serve_cluster --loop
    python -m repro_torch.launch.serve_cluster --processes 3 \\
        --chaos kill-owner

* ``--global-pool`` shares one ``GlobalBlockDirectory`` between the two
  pools: a block demoted to one instance's SSD store is fetchable by the
  other, the Conductor prices the peer-SSD arm, and the stores' measured
  read EMAs feed back into the arm prices.
* ``--loop`` drives the always-on ``ServingLoop`` instead of the
  Conductor's phase-at-a-time dispatch.
* ``--processes N`` runs the cluster as N OS processes over the wire: a
  parent hosting the ``DirectoryServer`` and N workers (started with
  ``subprocess``, each on the parent's device) that own a ``HostKVPool``
  + ``BlockServer`` and fetch peer blocks through ``SocketPeer``s. Each
  worker prefills its own document, then serves a query extending
  another node's document — a cross-process socket fetch — and the
  parent checks every token bit-exact against a single-process DRAM-only
  oracle. ``--chaos kill-owner`` SIGKILLs the block owner mid-transfer;
  survivors must still match the oracle, with the degradation accounted
  in ``fallback_reasons``.

The command line serves ``smollm-360m.reduced()`` on the GPU, with random
weights from ``--seed``, as the reference does; ``serve_cluster()`` is the
body, for callers that bring their own config, device, hardware model and
clock (the full-width smoke run, the CPU tests). ``--mesh DxM`` shards the
decode workers' paged step over a (data, model) mesh of the first D·M
GPUs: the one page pool's banks and the slots split over the data axis,
KV-head stripes over the model axis (``serve_cluster(..., mesh=)`` takes
any ``launch.mesh.Mesh``, CPU meshes included).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from contextlib import ExitStack, closing
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.conductor import (Conductor, DecodeInstance,
                                        PrefillInstance)
from repro_torch.core.costmodel import CostModel, Hardware, InstanceSpec
from repro_torch.core.directory import GlobalBlockDirectory
from repro_torch.core.messenger import Messenger
from repro_torch.core.policies import list_policies
from repro_torch.core.trace import BLOCK_TOKENS, TraceSpec, generate_trace
from repro_torch.data.pipeline import realize_request_tokens
from repro_torch.launch.serve import mesh_from_args
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillWorker, connect_pools,
                                        paged_supported, prefix_hash_ids)
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_PREFILL, N_DECODE = 2, 2
DECODE_IID0 = 100           # decode instance ids: 100, 101, ...


def cluster_workload(n: int, vocab: int):
    """Deterministic docs + queries shared by parent, workers and the
    oracle: query i extends node (i+1)%n's document, so serving it from
    node i forces a cross-process socket fetch."""
    rng = np.random.default_rng(42)
    docs = [rng.integers(0, vocab, size=2 * BLOCK_TOKENS, dtype=np.int32)
            for _ in range(n)]
    extras = [rng.integers(0, vocab, size=48, dtype=np.int32)
              for _ in range(n)]
    queries = [np.concatenate([docs[(i + 1) % n], extras[i]])
               for i in range(n)]
    return docs, queries


def _decode_all(cfg, pw, dw, tokens, max_new: int) -> list:
    pres = pw(tokens)
    dw.join(ServingRequest(req_id=0, tokens=tokens, max_new=max_new), pres)
    out = [pres.first_token]
    while dw.n_active:
        for _, tok, _fin in dw.step():
            out.append(tok)
    return [int(t) for t in out]


def config_by_name(name: str) -> ModelConfig:
    """A registered config by name; ``<arch>-reduced`` is its
    ``reduced()`` variant (how a worker process rebuilds its parent's)."""
    if name.endswith("-reduced"):
        return get_config(name[:-len("-reduced")]).reduced()
    return get_config(name)


def seeded_params(cfg: ModelConfig, device, seed: int) -> dict:
    """The launcher's random weights: equal in every process that asks
    for the same config, seed and device."""
    return init_params(cfg, torch.Generator().manual_seed(seed), device)


def kernel_launches() -> dict:
    """This process's launch counters of the main path's kernels."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    return {"paged_attention": paged_attention.launches,
            "flash_prefill": flash_prefill.launches}


# ---------------------------------------------------------------------------
# --processes: one worker node
# ---------------------------------------------------------------------------

def _worker_main(args) -> int:
    """One cluster node: HELLO the directory, serve blocks over a
    ``BlockServer``, fetch peers over ``SocketPeer``s, answer one query."""
    from repro_torch.serving.directory_service import RemoteDirectory
    from repro_torch.serving.transport import (BlockServer, InProcPeer,
                                               SocketPeer)

    n, i = args.processes, args.worker_node
    device = resolve_device(args.device)
    cfg = config_by_name(args.worker_arch)
    params = seeded_params(cfg, device, args.seed)
    docs, queries = cluster_workload(n, cfg.vocab_size)

    # tiny DRAM tier: the node's own doc demotes straight to its SSD
    # store, so peers fetch it through the store's CRC'd slots
    with ExitStack() as stack:
        pool = stack.enter_context(closing(HostKVPool(
            capacity_blocks=1, ssd_capacity_blocks=64, writeback_batch=1,
            ssd_dir=os.path.join(args.ssd_dir, f"p{i}"))))
        server = stack.enter_context(closing(
            BlockServer(InProcPeer(pool), stall_s=args.serve_stall)))
        host, port = args.directory.rsplit(":", 1)
        rdir = stack.enter_context(closing(RemoteDirectory(
            (host, int(port)), node_id=i, block_port=server.port)))
        pool.directory = rdir
        pool.node_id = i
        rdir.bind(i, pool.meta)
        pw = PrefillWorker(params, cfg, pool, prefill_chunk=256,
                           ssd_mode=args.ssd_mode)
        dw = DecodeWorker(params, cfg, max_batch=1, max_len=2048,
                          substrate="dense")

        pw(docs[i])                     # round 1: publish own doc
        br = rdir.barrier("published", n, timeout=600)
        if not br["met"]:
            print(f"node {i}: cluster failed to assemble ({br})", flush=True)
            return 2
        peers = {}
        for nid, (phost, pport) in sorted(rdir.nodes().items()):
            if nid != i:
                peers[nid] = stack.enter_context(closing(
                    SocketPeer((phost, pport), node=nid)))
                pool.add_peer(nid, peers[nid])
        # the parent joins this barrier too: it times the chaos kill off it
        br = rdir.barrier("round2", n + 1, timeout=600)
        if not br["met"]:
            print(f"node {i}: round-2 barrier failed ({br})", flush=True)
            return 2
        toks = _decode_all(cfg, pw, dw, queries[i], args.max_new)
        if device.type == "cuda":
            torch.cuda.synchronize()

        # modeled-vs-measured, wire edition: feed each peer's observed
        # socket bandwidth back into the Messenger's egress links
        msg = Messenger(list(range(n)), bw=100e9)
        bw = {}
        for nid, sp in peers.items():
            if sp.bw_ema:
                msg.set_link_bw(nid, sp.bw_ema)
                bw[str(nid)] = int(sp.bw_ema)
        # keep serving until every live node is done fetching (the
        # chaos victim never arrives)
        rdir.barrier("served", n - (args.chaos == "kill-owner"),
                     timeout=600)
        server.close()                  # joins its threads: final counts
        print("RESULT " + json.dumps(dict(
            node=i, tokens=toks, peer_blocks=pool.peer_blocks_fetched,
            fallback=pool.fallback_reasons, bw=bw, server=server.stats(),
            reads={str(nid): sp.layer_reads for nid, sp in peers.items()},
            plans=list(pw.overlap_plans), launches=kernel_launches())),
            flush=True)
    return 0


# ---------------------------------------------------------------------------
# --processes: the parent
# ---------------------------------------------------------------------------

def _serve_processes(cfg, device, *, n: int, chaos: bool, max_new: int,
                     ssd_dir: Optional[str], ssd_mode: str,
                     serve_stall: Optional[float], chaos_delay: float,
                     seed: int, log) -> dict:
    """Launch N worker processes around an in-process DirectoryServer,
    optionally SIGKILL the block owner mid-transfer, and hold every
    surviving answer bit-exact against a single-process oracle."""
    from repro_torch.serving.directory_service import (DirectoryServer,
                                                       RemoteDirectory)
    stall = serve_stall if serve_stall is not None else \
        (0.2 if chaos else 0.0)
    params = seeded_params(cfg, device, seed)
    docs, queries = cluster_workload(n, cfg.vocab_size)
    if device.type == "cuda":
        # every kernel is built before any worker starts: N workers would
        # otherwise each run nvcc for the same sources
        from repro_torch.kernels import _build
        _build.build_all()

    # single-process DRAM-only oracle for every query
    with closing(HostKVPool(capacity_blocks=4096)) as opool:
        opw = PrefillWorker(params, cfg, opool, prefill_chunk=256)
        odw = DecodeWorker(params, cfg, max_batch=1, max_len=2048,
                           substrate="dense")
        oracle = {i: _decode_all(cfg, opw, odw, queries[i], max_new)
                  for i in range(n)}
    del params, opw, odw

    dserver = DirectoryServer()
    base = ssd_dir or tempfile.mkdtemp(prefix="serve-cluster-")
    made_tmp = ssd_dir is None
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    procs = []
    log(f"cluster: directory @ 127.0.0.1:{dserver.port}, {n} worker "
        f"processes on {device.type}"
        + (f", chaos=kill-owner (stall {stall}s/layer)" if chaos else ""))
    failures = 0
    results: dict = {}
    reasons: dict = {}
    healed = None
    rd = None
    try:
        for i in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve_cluster",
                 "--processes", str(n), "--worker-node", str(i),
                 "--directory", f"127.0.0.1:{dserver.port}",
                 "--ssd-dir", base, "--ssd-mode", ssd_mode,
                 "--max-new", str(max_new), "--serve-stall", str(stall),
                 "--chaos", "kill-owner" if chaos else "none",
                 "--device", device.type, "--worker-arch", cfg.name,
                 "--seed", str(seed)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env))
        rd = RemoteDirectory(dserver.addr)
        br = rd.barrier("round2", n + 1, timeout=600)
        if not br["met"]:
            log(f"cluster never reached round 2: {br}")
            return dict(processes=n, chaos=chaos, failures=1, oracle=oracle,
                        results={}, fallback_reasons={},
                        directory_healed=None)
        log(f"round 2 underway: nodes {sorted(dserver.endpoints())}")
        if chaos:
            time.sleep(chaos_delay)
            log(f"chaos: SIGKILL node 0 (pid {procs[0].pid}) "
                f"mid-FETCH_BLOCK")
            os.kill(procs[0].pid, signal.SIGKILL)
            # the dead node's directory conn is its lease: its claims
            # must drop without any explicit withdraw
            doc0 = prefix_hash_ids(docs[0])
            deadline = time.time() + 10
            while time.time() < deadline and \
                    0 in dserver.directory.holders(doc0[0]):
                time.sleep(0.05)
            healed = 0 not in dserver.directory.holders(doc0[0])
            if healed:
                log("directory self-healed: node 0's claims dropped")
            else:
                log("FAIL: dead node 0 still owns blocks in the directory")
                failures += 1

        for i, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    r = json.loads(line[len("RESULT "):])
                    results[r["node"]] = r
            if chaos and i == 0:
                if p.returncode != -signal.SIGKILL:
                    log(f"FAIL: node 0 exited {p.returncode}, expected "
                        f"SIGKILL")
                    failures += 1
            elif p.returncode != 0:
                log(f"FAIL: node {i} exited {p.returncode}:\n{out}")
                failures += 1

        survivors = range(1 if chaos else 0, n)
        for i in survivors:
            r = results.get(i)
            if r is None:
                log(f"FAIL: no RESULT from node {i}")
                failures += 1
                continue
            r["bit_exact"] = r["tokens"] == oracle[i]
            if not r["bit_exact"]:
                failures += 1
            for k, v in r["fallback"].items():
                reasons[k] = reasons.get(k, 0) + v
            log(f"node {i}: {len(r['tokens'])} tokens "
                f"{'bit-exact' if r['bit_exact'] else 'MISMATCH'} vs oracle "
                f"— peer_blocks={r['peer_blocks']} fallback={r['fallback']} "
                f"bw={r['bw']} served={r['server']} "
                f"launches={r['launches']}")
        if chaos:
            if not (reasons.get("peer_unreachable")
                    or reasons.get("verify_failed")):
                log(f"FAIL: no survivor accounted the dead owner in "
                    f"fallback_reasons ({reasons})")
                failures += 1
        else:
            expect = 2 * len(survivors)     # every query = 2 peer blocks
            got = sum(results[i]["peer_blocks"] for i in survivors
                      if i in results)
            if got != expect:
                log(f"FAIL: {got} peer blocks fetched over the wire, "
                    f"expected {expect}")
                failures += 1
        log(("PASS" if not failures else f"FAIL ({failures})")
            + f": {len([i for i in survivors if i in results])}/{n} nodes "
            f"answered, degradations {reasons or '{}'}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if p.stdout is not None:
                p.stdout.close()
        if rd is not None:
            rd.close()
        dserver.close()
        if made_tmp:
            shutil.rmtree(base, ignore_errors=True)
    return dict(processes=n, chaos=chaos, failures=failures, oracle=oracle,
                results=results, fallback_reasons=reasons,
                directory_healed=healed)


# ---------------------------------------------------------------------------
# the in-process cluster
# ---------------------------------------------------------------------------

def make_trace(requests: int) -> list:
    """The session-structured trace, scaled to smoke size."""
    trace = generate_trace(TraceSpec(
        n_requests=requests, duration_ms=5_000, seed=1,
        max_input_tokens=1536, chat_turn_mu=5.5, doc_len_mu=6.8,
        frac_oneshot=0.2, frac_chat=0.6, frac_doc=0.2))[:requests]
    for r in trace:
        r.input_length = min(max(r.input_length, 64), 1536)
        r.hash_ids = r.hash_ids[:max(r.input_length // BLOCK_TOKENS, 1)]
    return trace


def serve_cluster(cfg: ModelConfig, device="cuda", *, params=None,
                  hardware: Optional[Hardware] = None,
                  n_chips: Optional[int] = None,
                  clock: Callable[[], float] = time.time,
                  requests: int = 24, max_new: int = 8,
                  dram_blocks: int = 2048, ssd_blocks: int = 0,
                  ssd_dir: Optional[str] = None, ssd_mode: str = "overlap",
                  strategy: str = "kvcache", global_pool: bool = False,
                  decode_substrate: str = "paged", device_pages: int = 0,
                  loop: bool = False, tbt_budget: Optional[float] = None,
                  processes: int = 0, chaos: str = "none",
                  chaos_delay: float = 0.08,
                  serve_stall: Optional[float] = None, seed: int = 0,
                  mesh=None, log=print) -> dict:
    """Run one lane of the cluster and return its summary dict.

    ``hardware``/``n_chips`` build the Conductor's ``InstanceSpec``
    (default: one H100 node); ``clock`` is what the Conductor reads
    ``now`` from. ``params`` defaults to ``seeded_params(cfg, device,
    seed)``; the ``processes`` lane always uses those (its workers build
    their own). ``mesh``: the (data, model) mesh the decode workers'
    paged step shards over (the in-process lanes)."""
    device = resolve_device(device)
    if processes:
        return _serve_processes(
            cfg, device, n=processes, chaos=chaos == "kill-owner",
            max_new=max_new, ssd_dir=ssd_dir, ssd_mode=ssd_mode,
            serve_stall=serve_stall, chaos_delay=chaos_delay, seed=seed,
            log=log)
    if global_pool and not ssd_blocks:
        raise ValueError("global_pool needs an SSD tier (ssd_blocks > 0)")
    if params is None:
        params = seeded_params(cfg, device, seed)
    inst = InstanceSpec()
    if hardware is not None:
        inst = InstanceSpec(n_chips=inst.n_chips, hw=hardware)
    if n_chips is not None:
        inst = InstanceSpec(n_chips=n_chips, hw=inst.hw)

    with ExitStack() as stack:
        # ---- build the disaggregated cluster ----
        directory = GlobalBlockDirectory() if global_pool else None
        # ssd_dir without ssd_blocks raises in HostKVPool (a store nothing
        # can reach is a config error, not a silent flat pool)
        pools = [stack.enter_context(closing(HostKVPool(
            capacity_blocks=dram_blocks, ssd_capacity_blocks=ssd_blocks,
            ssd_dir=os.path.join(ssd_dir, f"p{i}") if ssd_dir else None,
            directory=directory, node_id=i))) for i in range(N_PREFILL)]
        if directory is not None:
            connect_pools(pools)
        # ONE device page pool for the whole cluster (the HBM the paged
        # pages live in): prefill workers stage fresh KV into it and
        # decode workers adopt the runs — the zero-copy §3 handoff
        max_batch, max_len, page_tokens = 4, 2048, 64
        page_pool = None
        if decode_substrate == "paged" and paged_supported(cfg):
            per_seq = (max_len + page_tokens - 1) // page_tokens
            # mesh: n_pages is the PER-BANK budget (capacity scales ×data)
            mesh_d = 1 if mesh is None else int(mesh.shape.get("data", 1))
            n_pages = device_pages or \
                1 + ((N_DECODE * max_batch) // mesh_d + N_PREFILL) * per_seq
            page_pool = DevicePagePool(cfg, n_pages=n_pages,
                                       page_tokens=page_tokens, device=device,
                                       mesh=mesh)
            if mesh is not None:
                log(f"decode mesh {mesh_d}x{mesh.shape.get('model', 1)}: "
                    f"{page_pool.n_banks} page banks × "
                    f"{page_pool.bank_pages} pages, KV heads / "
                    f"{page_pool.n_model} model shards")
        pws = [PrefillWorker(params, cfg, pools[i], prefill_chunk=256,
                             ssd_mode=ssd_mode, page_pool=page_pool)
               for i in range(N_PREFILL)]
        dws = [DecodeWorker(params, cfg, max_batch=max_batch,
                            max_len=max_len, substrate=decode_substrate,
                            page_pool=page_pool)
               for _ in range(N_DECODE)]

        llama = get_config("llama2-70b")
        P = [PrefillInstance(iid=i, pool=pools[i].meta,
                             cost=CostModel(llama, inst))
             for i in range(N_PREFILL)]
        D = [DecodeInstance(iid=DECODE_IID0 + i, cost=CostModel(llama, inst))
             for i in range(N_DECODE)]
        msg = Messenger([p.iid for p in P] + [d.iid for d in D], bw=100e9)
        if ssd_blocks:
            for p in P:
                msg.add_ssd_channel(p.iid, inst.hw.ssd_read_bw)
        conductor = Conductor(P, D, msg, ttft_slo=30.0, tbt_slo=0.1,
                              strategy=strategy, directory=directory)
        trace = make_trace(requests)
        if loop:
            summary = _run_loop(cfg, pws, dws[0], pools, page_pool, trace,
                                requests=requests, max_new=max_new,
                                tbt_budget=tbt_budget, log=log)
        else:
            summary = _run_conductor(cfg, conductor, pws, dws, pools, P,
                                     msg, trace, max_new=max_new,
                                     clock=clock, log=log)
        _report_tiers(summary, conductor, pws, pools, directory, page_pool,
                      ssd_blocks=ssd_blocks, loop=loop, log=log)
        if page_pool is not None:
            try:
                page_pool.check_leaks()
                summary["pages_leak_free"] = True
            except AssertionError as e:
                summary["pages_leak_free"] = False
                log(f"page pool leak check failed: {e}")
        return summary


def _run_loop(cfg, pws, dw, pools, page_pool, trace, *, requests, max_new,
              tbt_budget, log) -> dict:
    """Always-on mode: ONE ServingLoop owns the page pool, a single decode
    batch and both prefill workers; routing (deepest pool residency) and
    backpressure live in the loop, so the Conductor is bypassed. A feeder
    thread plays the trace's arrival order."""
    log(f"serving loop: {len(pws)} prefill workers -> 1 decode batch "
        f"(max_batch={dw.max_batch}); {len(trace)} requests\n")
    loop = ServingLoop(pws, dw, tbt_budget_s=tbt_budget,
                       max_queue=max(requests, 8))
    payloads = [(r.req_id, realize_request_tokens(r, cfg.vocab_size),
                 min(max_new, max(r.output_length, 2)),
                 r.hash_ids[0] if r.hash_ids else None) for r in trace]

    def feeder():
        for rid, toks, mn, sess in payloads:
            loop.submit(ServingRequest(req_id=rid, tokens=toks,
                                       max_new=mn, session=sess))
        loop.close_intake()

    t0 = time.monotonic()
    th = threading.Thread(target=feeder, name="repro-loop-feeder")
    th.start()
    ls = loop.run()
    th.join()
    dt = time.monotonic() - t0
    outputs = {rid: list(o.tokens) for rid, o in loop.outputs.items()}
    total_tokens = sum(len(o) for o in outputs.values())
    reused = sum(pw.stats()["reused_blocks"] for pw in pws)
    log(f"served {ls['completed']} requests, {total_tokens} tokens in "
        f"{dt:.1f}s — {ls['decode_steps']} decode steps, "
        f"{ls['prefill_chunks']} prefill chunks interleaved, "
        f"{ls['rejected']} rejected by backpressure, {ls['preemptions']} "
        f"preemptions")
    log(f"prefix reuse: {reused} blocks; TBT p50/p99 "
        f"{ls['tbt_p50_s'] * 1e3:.1f}/{ls['tbt_p99_s'] * 1e3:.1f} ms")
    # every component reports through the same stats() protocol
    snapshots = {"loop": ls, "decode": dw.stats(), "pool[0]": pools[0].stats()}
    if page_pool is not None:
        snapshots["pages"] = page_pool.stats()
    for name, snap in snapshots.items():
        line = ", ".join(f"{k}={v}" for k, v in sorted(snap.items())
                         if not isinstance(v, float))
        log(f"  {name:8s} {line}")
    return dict(lane="loop", served=ls["completed"], rejected=ls["rejected"],
                tokens=total_tokens, seconds=dt,
                decode_tok_s=total_tokens / dt if dt else 0.0,
                reused=reused, loop=ls, outputs=outputs, payloads=payloads,
                paged_calls=dw.counters["paged_calls"],
                prefill_chunks=sum(pw.counters["chunks"] for pw in pws))


def _run_conductor(cfg, conductor, pws, dws, pools, P, msg, trace, *,
                   max_new, clock, log) -> dict:
    """Conductor dispatch: schedule each request (Algorithm 1), run its
    prefill on the chosen instance and join it to the chosen decode
    instance; one continuous-batching step per decode worker per round."""
    log(f"cluster: {len(pws)} prefill + {len(dws)} decode workers; "
        f"{len(trace)} requests\n")
    t0 = clock()
    t_wall = time.monotonic()
    stats = dict(reused=0, computed=0, migrations=0)
    outputs: dict[int, list] = {}
    records: list[dict] = []
    arms: Counter = Counter()
    ssd_ema: list = []
    queue = list(trace)

    while queue or any(dw.n_active for dw in dws):
        # admit as many as fit
        while queue and any(dw.n_active < dw.max_batch for dw in dws):
            req = queue.pop(0)
            dec = conductor.schedule(req, now=clock() - t0)
            if not dec.accepted:
                log(f"req {req.req_id:3d}: REJECTED ({dec.reject_reason})")
                records.append(dict(req_id=req.req_id, accepted=False,
                                    reason=dec.reject_reason))
                continue
            arms[dec.arm_kind] += 1
            pi = dec.prefill.iid
            di = dec.decode.iid - DECODE_IID0
            if dws[di].n_active >= dws[di].max_batch:
                di = next(i for i, d in enumerate(dws)
                          if d.n_active < d.max_batch)
            tokens = realize_request_tokens(req, cfg.vocab_size)
            # hot-spot migration: copy the prefix between the REAL pools,
            # under the engine's keys (the chained hashes of the tokens;
            # the Conductor's metadata speaks the trace's block ids, which
            # key no bytes)
            if dec.migrated_blocks and dec.transfer_from is not None:
                src = pools[dec.transfer_from]
                keys = prefix_hash_ids(tokens)
                hit = src.meta.prefix_len(keys)
                if hit:
                    k, v = src.get(keys[:hit])
                    pools[pi].put(keys[:hit], k, v)
                    stats["migrations"] += 1
            # session key = chain root: turns of one session extend the
            # same chain, so the incremental hasher re-hashes only the
            # suffix
            pres = pws[pi](tokens,
                           session=req.hash_ids[0] if req.hash_ids else None)
            stats["reused"] += pres.reused_blocks
            stats["computed"] += pres.prompt_len \
                - BLOCK_TOKENS * pres.reused_blocks
            # close the modeled-vs-measured loop: the store's measured read
            # EMA feeds the Conductor's arm prices (CostModel) and the
            # Messenger's SSD channel, in the COST MODEL's byte units (the
            # Conductor prices llama2-70b blocks), so one modeled block
            # load costs exactly one measured read
            store = pools[pi].store
            if store is not None and store.read_s_ema is not None:
                P[pi].cost.calibrate_ssd_read(store.read_s_ema)
                msg.set_ssd_bw(P[pi].iid, P[pi].cost.kv_bytes(BLOCK_TOKENS)
                               / store.read_s_ema)
                ssd_ema.append(store.read_s_ema)
            dws[di].join(ServingRequest(
                req_id=req.req_id, tokens=tokens,
                max_new=min(max_new, max(req.output_length, 2))), pres)
            outputs[req.req_id] = [pres.first_token]
            records.append(dict(
                req_id=req.req_id, accepted=True, prefill=pi, decode=di,
                prompt_len=pres.prompt_len, reused=pres.reused_blocks,
                migrated=bool(dec.migrated_blocks), arm=dec.arm_kind,
                peer_blocks=pres.peer_blocks, ssd_blocks=pres.ssd_blocks))
            log(f"req {req.req_id:3d}: prefill@P{pi} "
                f"({pres.prompt_len:5d} tok, reuse {pres.reused_blocks:2d} "
                f"blk{', migrated' if dec.migrated_blocks else ''}) "
                f"-> decode@D{di}")
        # one continuous-batching iteration on every decode worker
        for dw in dws:
            for rid, tok, _fin in dw.step():
                outputs[rid].append(tok)
    if pws[0].device.type == "cuda":
        torch.cuda.synchronize()
    dt = clock() - t0
    wall = time.monotonic() - t_wall
    total_tokens = sum(len(v) for v in outputs.values())
    log(f"\nserved {len(outputs)} requests, {total_tokens} tokens "
        f"in {dt:.1f}s")
    log(f"prefix reuse: {stats['reused']} blocks "
        f"({BLOCK_TOKENS * stats['reused']} tokens skipped), "
        f"computed {stats['computed']} tokens, "
        f"hot-spot migrations: {stats['migrations']}")
    hashed = sum(pw.hasher.blocks_hashed for pw in pws)
    memo = sum(pw.hasher.memo_hits for pw in pws)
    log(f"prefix hashing: {hashed} blocks SHA'd, {memo} session memo hits")
    zc = sum(dw.stats()["zero_copy_joins"] for dw in dws)
    return dict(
        lane="conductor", served=len(outputs),
        rejected=sum(not r["accepted"] for r in records),
        tokens=total_tokens, seconds=wall,
        decode_tok_s=total_tokens / wall if wall else 0.0,
        reused=stats["reused"], computed=stats["computed"],
        migrations=stats["migrations"],
        conductor_migrations=conductor.n_migrations,
        arms=dict(arms), zero_copy_joins=zc, blocks_hashed=hashed,
        memo_hits=memo, records=records, outputs=outputs,
        ssd_read_ema=ssd_ema[-1] if ssd_ema else None,
        paged_calls=sum(dw.counters["paged_calls"] for dw in dws),
        prefill_chunks=sum(pw.counters["chunks"] for pw in pws))


def _report_tiers(summary, conductor, pws, pools, directory, page_pool, *,
                  ssd_blocks, loop, log) -> None:
    """The substrate, global-pool and SSD-tier lines of the reference's
    report, and their counters in ``summary``."""
    if loop:
        return
    if page_pool is not None:
        ps = page_pool.stats()
        log(f"paged substrate: {page_pool.n_pages} pages "
            f"({page_pool.page_tokens} tok), {page_pool.used_pages} held, "
            f"{ps['pages_written']} written, {ps['shared_adoptions']} "
            f"shared-prefix adoptions, {ps['cow_copies']} COW copies, "
            f"{ps['registry_evictions']} registry evictions; "
            f"{summary['zero_copy_joins']} zero-copy joins")
    log(f"conductor migrations (metadata): {conductor.n_migrations}")
    summary.update(
        peer_blocks_fetched=sum(p.peer_blocks_fetched for p in pools),
        peer_fetch_failures=sum(p.peer_fetch_failures for p in pools),
        conductor_ssd_loads=conductor.n_ssd_loads,
        conductor_peer_ssd_loads=conductor.n_peer_ssd_loads)
    if directory is not None:
        d = directory.stats()
        reasons: dict = {}
        for p in pools:
            for k, v in p.fallback_reasons.items():
                reasons[k] = reasons.get(k, 0) + v
        summary["fallback_reasons"] = reasons
        log(f"global pool: directory {d['keys']} keys "
            f"({d['dram_claims']} dram / {d['ssd_claims']} ssd claims), "
            f"conductor peer-SSD arms won {conductor.n_peer_ssd_loads}, "
            f"engine fetched {summary['peer_blocks_fetched']} peer blocks "
            f"({summary['peer_fetch_failures']} failures"
            f"{', ' + str(reasons) if reasons else ''})")
    if ssd_blocks:
        log(f"conductor SSD prefix loads: {conductor.n_ssd_loads}")
        for i, pool in enumerate(pools):
            s = pool.meta.tier_stats()
            log(f"P{i} tiers: dram={s['dram_blocks']} ssd={s['ssd_blocks']} "
                f"hits(dram/ssd)={s['dram_hits']}/{s['ssd_hits']} "
                f"demote={s['demotions']} promote={s['promotions']} "
                f"writebacks={s['n_writebacks']}")
            if pool.store is not None:
                st = pool.store.stats()
                ws = pws[i].stats()
                log(f"   store: {st['blocks']} on disk "
                    f"({st['file_bytes'] >> 10} KiB), wrote "
                    f"{st['blocks_written']} blk / {st['n_flushes']} "
                    f"flushes, read {st['layer_reads']} layers, "
                    f"{st['read_failures']} failures; engine overlapped "
                    f"{ws['overlapped_requests']} prefills "
                    f"({ws['ssd_loaded_blocks']} blocks prefetched)")


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_cluster",
        description="disaggregated serving cluster (Conductor, prefill and "
                    "decode workers) on the GPU")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--dram-blocks", type=int, default=2048,
                    help="per-instance DRAM KVCache tier capacity (blocks)")
    ap.add_argument("--ssd-blocks", type=int, default=0,
                    help="per-instance SSD tier capacity (blocks); "
                         "0 = flat DRAM pool")
    ap.add_argument("--ssd-dir", default=None,
                    help="base directory for the file-backed SSD store "
                         "(one subdir per prefill instance); omit to keep "
                         "demoted bytes in host tensors")
    ap.add_argument("--ssd-mode", default="overlap",
                    choices=("blocking", "overlap"),
                    help="SSD prefix loads: synchronous, or overlapped "
                         "with head-chunk recompute (§5.2)")
    ap.add_argument("--strategy", default="kvcache",
                    choices=list_policies("prefill"),
                    help="prefill routing policy (from the registry)")
    ap.add_argument("--global-pool", action="store_true",
                    help="share one GlobalBlockDirectory across the prefill "
                         "instances' pools: blocks demoted on one node are "
                         "peer-fetchable from the other, and the Conductor "
                         "prices the peer-SSD arm (requires --ssd-blocks)")
    ap.add_argument("--decode-substrate", default="paged",
                    choices=("paged", "dense"),
                    help="decode KV substrate: block-table pages shared "
                         "prefill→decode (zero-copy join, prefix-sharing "
                         "slots), or the dense per-slot arena (the "
                         "bit-exactness oracle)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="shard the paged decode engine over a (data, "
                         "model) device mesh (e.g. 2x2): slots + page "
                         "banks over data, KV-head stripes over model. "
                         "Needs D*M GPUs")
    ap.add_argument("--device-pages", type=int, default=0,
                    help="device page-pool size (0 = sized from the decode "
                         "workers' slot budget)")
    ap.add_argument("--loop", action="store_true",
                    help="drive the always-on ServingLoop (thread-fed "
                         "arrivals, chunked prefill interleaved with decode "
                         "steps, admission backpressure) instead of the "
                         "Conductor's phase-at-a-time dispatch")
    ap.add_argument("--tbt-budget", type=float, default=None,
                    help="loop TBT budget in seconds (default: "
                         "deterministic one-chunk-per-iteration interleave)")
    ap.add_argument("--processes", type=int, default=0,
                    help="run the cluster as N OS processes over the wire "
                         "protocol (directory service + CRC-framed block "
                         "fetches), checked bit-exact against a "
                         "single-process oracle")
    ap.add_argument("--chaos", default="none",
                    choices=("none", "kill-owner"),
                    help="with --processes: SIGKILL the block owner "
                         "mid-FETCH_BLOCK; survivors must stay bit-exact "
                         "with the degradation in fallback_reasons")
    ap.add_argument("--chaos-delay", type=float, default=0.08,
                    help="seconds after the round-2 barrier to fire the "
                         "chaos kill")
    ap.add_argument("--serve-stall", type=float, default=None,
                    help="per-LAYER serving stall in each worker's "
                         "BlockServer (widens the mid-transfer window the "
                         "chaos kill lands in; default 0, or 0.2 under "
                         "--chaos kill-owner)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    # internal: a worker node spawned by the --processes parent
    ap.add_argument("--worker-node", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--directory", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--worker-arch", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.worker_node is not None:
        if args.serve_stall is None:
            args.serve_stall = 0.0
        return _worker_main(args)
    if args.global_pool and not args.ssd_blocks:
        ap.error("--global-pool needs an SSD tier (--ssd-blocks > 0)")
    if args.mesh and args.decode_substrate != "paged":
        ap.error("--mesh shards the PAGED decode substrate")
    cfg, mesh = mesh_from_args(ap, args, get_config("smollm-360m").reduced())
    s = serve_cluster(
        cfg, "cuda", mesh=mesh,
        requests=args.requests, max_new=args.max_new,
        dram_blocks=args.dram_blocks, ssd_blocks=args.ssd_blocks,
        ssd_dir=args.ssd_dir, ssd_mode=args.ssd_mode,
        strategy=args.strategy, global_pool=args.global_pool,
        decode_substrate=args.decode_substrate,
        device_pages=args.device_pages, loop=args.loop,
        tbt_budget=args.tbt_budget, processes=args.processes,
        chaos=args.chaos, chaos_delay=args.chaos_delay,
        serve_stall=args.serve_stall, seed=args.seed)
    return 1 if s.get("failures") else 0


if __name__ == "__main__":
    sys.exit(main())
