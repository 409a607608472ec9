"""The port's serving stack: the reference's workers and ``ServingLoop``
against the port's on the same generated workload (seed 0, weights
bridged), per-request streams held to the greedy rule (equal wherever
the reference's top-1/top-2 gap exceeds 4e-2; a divergence must sit on a
near-tie, counted and reported); then the port's own exactness
properties — a preempted stream restored by reload and by recompute
equals one never preempted, the bucketed step equals the full step,
paged equals dense — and the host-side pool, admission and launcher
pieces."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.core.trace import TraceSpec as JTraceSpec
from repro.core.trace import generate_trace as jax_generate_trace
from repro.data.pipeline import realize_request_tokens as jax_realize
from repro.serving.engine import DecodeWorker as JDecodeWorker
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
from repro.serving.loop import ServingLoop as JServingLoop
from repro.serving.paged_cache import DevicePagePool as JDevicePagePool
from repro.serving.request import ServingRequest as JServingRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.policies import BackpressureSignal, get_policy
from repro_torch.launch.serve import make_payloads, serve
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillResult, PrefillWorker,
                                        plan_restore, stage_run)
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import RequestOutput, ServingRequest

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

GAP = 4e-2
ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _jax_payloads(n, vocab, max_new):
    """The reference launcher's workload, built with the reference's own
    trace generator and token realisation."""
    spec = JTraceSpec(n_requests=n, duration_ms=10_000, seed=0,
                      max_input_tokens=2048, chat_turn_mu=5.0,
                      doc_len_mu=6.5)
    reqs = jax_generate_trace(spec)[:n]
    for r in reqs:
        r.input_length = min(r.input_length, 1536)
        r.hash_ids = r.hash_ids[:max(r.input_length // 512, 1)]
    return [(r.req_id, jax_realize(r, vocab),
             min(max_new, max(r.output_length, 2)),
             r.hash_ids[0] if r.hash_ids else None) for r in reqs]


def _run_loop(loop_cls, req_cls, pws, dw, payloads):
    loop = loop_cls(pws, dw, chunks_per_iter=1, max_queue=16,
                    admission="predictive")
    for rid, toks, mn, sess in payloads:
        assert loop.submit(req_cls(req_id=rid, tokens=toks, max_new=mn,
                                   session=sess))
    loop.close_intake()
    stats = loop.run()
    return {rid: list(o.tokens) for rid, o in loop.outputs.items()}, stats


def test_serving_loop_matches_reference(weights, record_property):
    jcfg, cfg, jp, tp = weights
    payloads = make_payloads(6, cfg.vocab_size, max_new=12, seed=0)[:3]
    ref_payloads = _jax_payloads(6, jcfg.vocab_size, 12)[:3]
    for (a, ta, ma, sa), (b, tb, mb, sb) in zip(payloads, ref_payloads):
        assert (a, ma, sa) == (b, mb, sb) and np.array_equal(ta, tb)

    jpool = JHostKVPool()
    jpp = JDevicePagePool(jcfg, n_pages=1 + 5 * 32, page_tokens=64)
    ref, _ = _run_loop(
        JServingLoop, JServingRequest,
        [JPrefillWorker(jp, jcfg, jpool, prefill_chunk=256, page_pool=jpp)],
        JDecodeWorker(jp, jcfg, max_batch=4, max_len=2048, page_pool=jpp),
        ref_payloads)
    pool = HostKVPool()
    pp = DevicePagePool(cfg, n_pages=1 + 5 * 32, page_tokens=64, device="cpu")
    port, stats = _run_loop(
        ServingLoop, ServingRequest,
        [PrefillWorker(tp, cfg, pool, prefill_chunk=256, page_pool=pp)],
        DecodeWorker(tp, cfg, max_batch=4, max_len=2048, page_pool=pp),
        payloads)
    assert stats["completed"] == len(payloads)
    ties = 0
    for rid, prompt, mn, _ in payloads:
        r, p = ref[rid], port[rid]
        assert len(r) == len(p) == mn
        i = next((i for i in range(mn) if r[i] != p[i]), None)
        if i is None:
            continue
        # a divergence must be a near-tie of the reference's logits there
        ctx = np.concatenate([prompt, np.asarray(r[:i], np.int32)])
        logits, _ = JT.prefill(jp, jnp.asarray(ctx[None]), jcfg)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] <= GAP, (rid, i, top2)
        ties += 1
    record_property("near_ties_skipped", ties)
    print(f"serving: {ties} of {len(payloads)} streams diverged at a "
          f"near-tie")
    pp.check_leaks()


# ---------------------------------------------------------------------------
# exactness properties inside the port
# ---------------------------------------------------------------------------

def _mk(cfg, tp, *, max_batch=4, max_len=512, n_pages=None, chunk=64,
        **dw_kw):
    n_pages = n_pages or 1 + (max_batch + 2) * (max_len // 64)
    pp = DevicePagePool(cfg, n_pages=n_pages, page_tokens=64, device="cpu")
    pool = HostKVPool()
    pws = [PrefillWorker(tp, cfg, pool, prefill_chunk=chunk, page_pool=pp)]
    dw = DecodeWorker(tp, cfg, max_batch=max_batch, max_len=max_len,
                      page_pool=pp, **dw_kw)
    return pws, dw, pp, pool


def _oracle(cfg, tp, reqs, max_news):
    """Request-at-a-time streams, never preempted."""
    pw = PrefillWorker(tp, cfg, HostKVPool(), prefill_chunk=64)
    dw = DecodeWorker(tp, cfg, max_batch=1, max_len=1024)
    out = {}
    for rid, toks in reqs.items():
        res = pw(toks)
        dw.join(ServingRequest(rid, toks, max_news[rid]), res)
        seq = [res.first_token]
        while dw.n_active:
            seq += [tok for _, tok, _ in dw.step()]
        out[rid] = seq
    return out


@pytest.mark.parametrize("restore_mode", ["reload", "recompute"])
def test_preempted_stream_restores_exactly(weights, restore_mode):
    """Tight pool + full batch: a high-priority arrival spills the
    low-priority victim, which restores (by reload or by recompute) and
    completes; every stream equals the never-preempted oracle."""
    _, cfg, _, tp = weights
    pws, dw, pp, pool = _mk(cfg, tp, max_batch=1, max_len=640, n_pages=17)
    loop = ServingLoop(pws, dw, chunks_per_iter=2, max_queue=16,
                       restore_mode=restore_mode)
    rng = np.random.default_rng(10)
    victim = rng.integers(0, cfg.vocab_size, 512)
    sprinter = rng.integers(0, cfg.vocab_size, 128)
    assert loop.submit(ServingRequest(0, victim, 24, priority=0))
    while len(loop.outputs.get(0, RequestOutput(0)).tokens) < 4:
        loop.iterate()
    assert loop.submit(ServingRequest(1, sprinter, 4, priority=1))
    loop.close_intake()
    stats = loop.run()
    assert stats["completed"] == 2 and stats["preemptions"] >= 1
    assert set(loop.outputs[0].restores) == {restore_mode}
    assert loop.outputs[1].preemptions == 0
    oracle = _oracle(cfg, tp, {0: victim, 1: sprinter}, {0: 24, 1: 4})
    for rid in (0, 1):
        assert loop.outputs[rid].tokens == oracle[rid], rid
    assert pool.spill_depth() == 0 and stats["spill_depth"] == 0
    pp.check_leaks()


def _batch_streams(cfg, tp, **dw_kw):
    rng = np.random.default_rng(4)
    prompts = {i: rng.integers(0, cfg.vocab_size, n)
               for i, n in enumerate((40, 300, 130, 520))}
    pws, dw, pp, _ = _mk(cfg, tp, max_batch=4, max_len=1024, **dw_kw)
    out = {}
    for rid, toks in prompts.items():
        res = pws[0](toks)
        dw.join(ServingRequest(rid, toks, 10), res)
        out[rid] = [res.first_token]
    while dw.n_active:
        for rid, tok, _ in dw.step():
            out[rid].append(tok)
    if pp is not None and dw.substrate == "paged":
        pp.check_leaks()
    return out, dw


def test_bucketed_step_equals_full_step(weights):
    _, cfg, _, tp = weights
    full, _ = _batch_streams(cfg, tp)
    bucketed, dw = _batch_streams(cfg, tp, width_buckets=4)
    assert dw.counters["bucket_substeps"] > dw.counters["steps"]
    assert bucketed == full


def test_paged_substrate_equals_dense_substrate(weights):
    _, cfg, _, tp = weights
    paged, _ = _batch_streams(cfg, tp)
    dense, dw = _batch_streams(cfg, tp, substrate="dense")
    assert dw.substrate == "dense"
    assert paged == dense


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------

def test_page_pool_export_import_roundtrip_and_cow(weights):
    _, cfg, _, _ = weights
    pp = DevicePagePool(cfg, n_pages=32, page_tokens=64, device="cpu")
    L, _, _, KV, Dh = pp.k_pages.shape
    k = torch.randn(L, 150, KV, Dh).bfloat16()
    pages = pp.alloc(pp.pages_for(150))
    pp.write_run(pages, k, -k)
    k_ref, _ = pp.read_seq(pages, 150)
    assert torch.equal(k_ref, k)
    ek, ev = pp.export_run(pages, 150)
    junk = pp.alloc(3)                     # recycle the freed pages
    pp.write_run(junk, torch.zeros_like(k), torch.zeros_like(k))
    assert torch.equal(ek, k) and torch.equal(ev, -k)
    back = pp.import_run(ek, ev, 150)
    assert torch.equal(pp.read_seq(back, 150)[0], k)
    pp.retain(back[-1:])                   # share the tail page: COW
    new = pp.make_writable(back[-1])
    assert new != back[-1] and pp.counters["cow_copies"] == 1
    assert torch.equal(pp.k_pages[:, new], pp.k_pages[:, back[-1]])
    pp.release(junk + back[:-1] + [new] + back[-1:])
    pp.check_leaks()
    with pytest.raises(RuntimeError, match="double free"):
        pp.release([new])


def test_stage_run_shares_registered_prefix_blocks(weights):
    _, cfg, _, _ = weights
    pp = DevicePagePool(cfg, n_pages=40, page_tokens=64, device="cpu")
    L, _, _, KV, Dh = pp.k_pages.shape
    k = torch.randn(L, 1100, KV, Dh).bfloat16()
    a = stage_run(pp, [11, 12], k, k, 1100)
    b = stage_run(pp, [11, 12], k, k, 1100)
    assert a[:16] == b[:16] and a[16:] != b[16:]   # blocks shared, tail not
    assert pp.counters["shared_adoptions"] == 2
    pp.release(a)
    pp.release(b)
    assert pp.pressure()["pinned"] == 0 and pp.pressure()["evictable"] == 16
    pp.check_leaks()


def test_host_pool_prefix_reuse_and_spill_slab(weights):
    _, cfg, _, tp = weights
    pool = HostKVPool()
    pw = PrefillWorker(tp, cfg, pool, prefill_chunk=128)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, 1100)
    cold = pw(toks)
    assert cold.new_blocks == 2 and pool.n_blocks == 2
    warm = pw(toks)
    assert warm.reused_blocks == 2 and warm.first_token == cold.first_token
    assert torch.equal(warm.kv_k, cold.kv_k)
    pool.spill_put(7, cold.kv_k, cold.kv_v, 1100)
    with pytest.raises(RuntimeError, match="already has a spilled run"):
        pool.spill_put(7, cold.kv_k, cold.kv_v, 1100)
    assert pool.spill_depth() == 1 and pool.spill_get(7)[2] == 1100
    assert pool.spill_pop(7) and not pool.spill_pop(7)
    assert pool.stats()["spill_restores"] == 1
    assert isinstance(cold, PrefillResult) and cold.pages is None
    pool.close()


def test_plan_restore_and_admission_policies():
    assert plan_restore(1024, reload_s_per_block=1.0,
                        recompute_s_per_block=2.0).mode == "reload"
    assert plan_restore(1024, reload_s_per_block=2.0,
                        recompute_s_per_block=1.0).mode == "recompute"
    assert plan_restore(512, reload_s_per_block=None,
                        recompute_s_per_block=None).mode == "reload"
    with pytest.raises(ValueError, match="unknown restore mode"):
        plan_restore(1, reload_s_per_block=1, recompute_s_per_block=1,
                     mode="x")
    sig = BackpressureSignal(queue_depth=2, queue_capacity=8, slots_used=8,
                             slots_total=8, prefills_active=4)
    assert get_policy("admission", "baseline").engine_admit(sig)
    assert get_policy("admission", "early").engine_admit(sig)      # 10/16
    assert not get_policy("admission", "predictive").engine_admit(sig)  # 14/16
    assert get_policy("admission", "predictive").engine_admit(sig, 1)
    with pytest.raises(ValueError, match="registered"):
        get_policy("admission", "nope")


def test_launcher_body_serves_on_cpu():
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = serve(cfg, "cpu", params=params, requests=12, max_batch=4,
              log=lambda m: None)
    assert s["submitted"] == 8 and s["completed"] == 8
    assert s["paged_calls"] == s["decode_steps"] > 0
    assert s["prefill_chunks"] > 0 and s["ttft_p50_s"] > 0
    for rid, _, mn, _ in s["payloads"]:
        assert len(s["outputs"][rid]) == mn
