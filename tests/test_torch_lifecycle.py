"""The port's ``ServingLoop`` lifecycle, proven inside the port on
smollm-360m's reduced config (the reference's properties,
``tests/test_serving_loop.py`` and ``tests/test_preemption.py``): arrivals
fed from a thread while decodes run, every stream bit-exact against a
request-at-a-time oracle; prefill chunks interleaved between decode
steps; backpressure that sheds and recovers; joins deferred on a full
batch and on a tight page pool; ``stop()`` releasing pending work, a
spilled victim and a restore in flight; pool pressure telling pinned
pages from evictable ones; the queue cap atomic under contention. Every
test ends with the pool's leak check, under the conftest thread and fd
leak checks.

Also the request surface, and the divergence the port keeps on purpose:
the reference still accepts its deprecated legacy forms,
``ServingLoop.submit(req_id, tokens, max_new)`` and
``DecodeWorker.join(req_id, pres, max_new=...)``, behind a
``DeprecationWarning``; the port takes a ``ServingRequest`` only, and a
legacy call raises (ROADMAP §3)."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.serving.engine import DecodeWorker as JDecodeWorker
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
from repro.serving.loop import ServingLoop as JServingLoop
from repro.serving.paged_cache import DevicePagePool as JDevicePagePool
from repro_torch.configs.base import get_config
from repro_torch.core.policies import BackpressureSignal, get_policy
from repro_torch.models.transformer import init_params
from repro_torch.serving import (DecodeWorker, DevicePagePool, HostKVPool,
                                 PrefillWorker, RequestOutput, ServingLoop)
from repro_torch.serving.request import ServingRequest

torch.set_num_threads(1)


def _req(rid, toks, max_new, **kw):
    return ServingRequest(req_id=rid, tokens=toks, max_new=max_new, **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _mk(cfg, params, *, max_batch=4, max_len=512, n_pages=None,
        n_workers=2, chunk=64):
    n_pages = n_pages or 1 + (max_batch + 2) * (max_len // 64)
    pp = DevicePagePool(cfg, n_pages=n_pages, page_tokens=64, device="cpu")
    pool = HostKVPool()
    pws = [PrefillWorker(params, cfg, pool, prefill_chunk=chunk,
                         page_pool=pp) for _ in range(n_workers)]
    dw = DecodeWorker(params, cfg, max_batch=max_batch, max_len=max_len,
                      substrate="paged", page_pool=pp)
    return pws, dw, pp, pool


def _oracle(cfg, params, reqs, max_new):
    """Request-at-a-time streams (fresh engines, one request at a time)."""
    pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=64)
    dw = DecodeWorker(params, cfg, max_batch=1, max_len=1024)
    out = {}
    for rid, toks in reqs.items():
        res = pw(toks)
        dw.join(_req(rid, toks, max_new), res)
        seq = [res.first_token]
        while dw.n_active:
            seq += [tok for _, tok, _ in dw.step()]
        out[rid] = seq
    return out


# ---------------------------------------------------------------------------
# the loop (tests/test_serving_loop.py)
# ---------------------------------------------------------------------------

def test_loop_mixed_load_bit_exact_with_thread_fed_arrivals(setup):
    """Arrivals land from a thread WHILE decodes run; every stream equals
    the request-at-a-time oracle and shutdown leaves the pool leak-free."""
    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params)
    loop = ServingLoop(pws, dw, chunks_per_iter=1, max_queue=16)
    rng = np.random.default_rng(3)
    reqs = {i: rng.integers(0, cfg.vocab_size, int(rng.integers(80, 300)))
            for i in range(6)}

    def feeder():
        for i, t in reqs.items():
            while not loop.submit(_req(i, t, 5)):
                time.sleep(0.01)             # shed → retry (the test wants all)
            time.sleep(0.005)
        loop.close_intake()

    th = threading.Thread(target=feeder, name="repro-loop-feeder")
    th.start()
    stats = loop.run()
    th.join()
    assert stats["completed"] == 6
    oracle = _oracle(cfg, params, reqs, max_new=5)
    for i in reqs:
        assert loop.outputs[i].done
        assert loop.outputs[i].tokens == oracle[i], f"req {i} diverged"
    pp.check_leaks()
    assert stats["tbt_n"] > 0 and stats["tbt_p99_s"] >= stats["tbt_p50_s"]


def test_loop_interleaves_prefill_chunks_between_decode_steps(setup):
    """While a long prefill is mid-chunks, the active slot keeps
    emitting: decode steps interleave with the prefill's chunks."""
    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params, n_workers=1)
    loop = ServingLoop(pws, dw, chunks_per_iter=1, max_queue=16)
    rng = np.random.default_rng(4)
    short = rng.integers(0, cfg.vocab_size, 80)      # 2 chunks
    long = rng.integers(0, cfg.vocab_size, 448)      # 7 chunks
    assert loop.submit(_req(0, short, 12))
    while loop.stats()["joined"] == 0:
        loop.iterate()
    steps_before = loop.stats()["decode_steps"]
    assert loop.submit(_req(1, long, 3))
    while loop.stats()["joined"] < 2:
        loop.iterate()
    # 7 chunks at 1 a loop iteration: ≥ 6 decode steps ran meanwhile
    assert loop.stats()["decode_steps"] - steps_before >= 6
    assert len(loop.outputs[0].tokens) > 6
    loop.close_intake()
    loop.run()
    oracle = _oracle(cfg, params, {0: short, 1: long}, max_new=12)
    assert loop.outputs[0].tokens == oracle[0][:12]
    assert loop.outputs[1].tokens == oracle[1][:3]
    pp.check_leaks()


def test_loop_backpressure_sheds_and_recovers(setup):
    """submit() sheds at the hard queue cap (a shed request runs
    nothing) and the loop drains what it accepted."""
    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params, max_batch=2)
    loop = ServingLoop(pws, dw, chunks_per_iter=1, max_queue=2)
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, cfg.vocab_size, 100) for _ in range(6)]
    accepted = [loop.submit(_req(i, t, 3)) for i, t in enumerate(toks)]
    assert accepted[:2] == [True, True]
    assert not all(accepted), "the hard queue cap never triggered"
    n_acc = sum(accepted)
    assert loop.stats()["rejected"] == 6 - n_acc
    assert loop.stats()["prefill_chunks"] == 0       # shed ⇒ nothing ran
    loop.close_intake()
    loop.run()
    assert loop.stats()["completed"] == n_acc
    pp.check_leaks()


def test_loop_full_batch_defers_joins_until_slots_free(setup):
    """More requests than decode slots: finished prefills wait in
    pending-join (join never raises) and all complete as slots free."""
    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params, max_batch=2)
    loop = ServingLoop(pws, dw, chunks_per_iter=2, max_queue=16)
    rng = np.random.default_rng(6)
    reqs = {i: rng.integers(0, cfg.vocab_size, 100) for i in range(5)}
    for i, t in reqs.items():
        assert loop.submit(_req(i, t, 4))
    loop.close_intake()
    assert loop.run()["completed"] == 5
    oracle = _oracle(cfg, params, reqs, max_new=4)
    for i in reqs:
        assert loop.outputs[i].tokens == oracle[i][:4]
    pp.check_leaks()


def test_loop_tight_pool_defers_joins_instead_of_mid_decode_oom(setup):
    """A join that takes the last free pages would starve an active
    slot's growth a few steps later; the loop holds the join back until
    the headroom covers every active slot's worst case."""
    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params, max_batch=2, max_len=455, n_pages=15,
                         n_workers=1, chunk=64)
    loop = ServingLoop(pws, dw, chunks_per_iter=1, max_queue=16)
    rng = np.random.default_rng(9)
    reqs = {i: rng.integers(0, cfg.vocab_size, 256 if i % 2 else 384)
            for i in range(6)}
    for i, t in reqs.items():
        assert loop.submit(_req(i, t, 7 if i % 2 else 3))
    loop.close_intake()
    stats = loop.run()
    assert stats["completed"] == 6
    assert stats["join_oom"] > 0             # the guard engaged
    pp.check_leaks()


def test_loop_stop_releases_pending_work(setup):
    """stop() mid-flight: queued and mid-prefill work is abandoned and
    the page references of never-joined results are dropped."""
    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params)
    loop = ServingLoop(pws, dw, chunks_per_iter=1, max_queue=16)
    rng = np.random.default_rng(7)
    for i in range(4):
        loop.submit(_req(i, rng.integers(0, cfg.vocab_size, 200), 8))
    for _ in range(3):
        loop.iterate()
    loop.stop()
    loop.run()
    assert dw.n_active == 0 and dw.free_slots == dw.max_batch
    pp.check_leaks()


def test_backpressure_signal_policy_semantics():
    """baseline is blind to decode, early sees occupancy but not
    in-flight prefills, predictive counts them and the spilled victims;
    pinned pages alone trip the pool path; priority buys headroom."""
    base = get_policy("admission", "baseline")
    early = get_policy("admission", "early")
    pred = get_policy("admission", "predictive")
    sig = BackpressureSignal(queue_depth=0, queue_capacity=8, slots_used=4,
                             slots_total=4, prefills_active=4,
                             pages_pinned=10, pages_total=100)
    assert base.engine_load(sig) == 0.0
    assert early.engine_load(sig) == pytest.approx(4 / 12)
    assert pred.engine_load(sig) == pytest.approx(8 / 12)
    assert base.engine_admit(sig)
    assert not pred.engine_admit(sig, priority=0) or \
        pred.engine_load(sig) <= pred.base_limit
    sig2 = BackpressureSignal(queue_depth=8, queue_capacity=8, slots_used=4,
                              slots_total=4)
    assert not early.engine_admit(sig2, priority=0)
    assert early.engine_admit(sig2, priority=1)
    sig3 = BackpressureSignal(queue_depth=0, queue_capacity=8, slots_used=1,
                              slots_total=4, pages_pinned=95,
                              pages_total=100)
    assert early.engine_load(sig3) == pytest.approx(0.95)
    assert not early.engine_admit(sig3)
    sig4 = BackpressureSignal(queue_depth=0, queue_capacity=8, slots_used=2,
                              slots_total=4, spilled=4)
    assert early.engine_load(sig4) == pytest.approx(2 / 12)
    assert pred.engine_load(sig4) == pytest.approx(6 / 12)
    assert sig4.committed_frac(include_prefills=True, include_spilled=True) \
        > sig4.committed_frac(include_prefills=True)


def test_page_pool_pressure_distinguishes_pinned_from_evictable(setup):
    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params, max_batch=2, max_len=640, n_workers=1)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, 512)
    res = pws[0](toks)                       # one full block, staged
    p = pp.pressure()
    assert p["capacity"] == pp.n_pages - 1
    assert p["used"] == p["pinned"] + p["evictable"]
    assert p["pinned"] > 0
    dw.join(_req(0, toks, 2), res)
    assert dw.free_slots == 1
    while dw.n_active:
        dw.step()
    p2 = pp.pressure()
    assert p2["pinned"] < p["pinned"]        # the slot's pins are gone
    assert p2["evictable"] > 0               # its blocks stay registered
    assert 0.0 <= p2["pinned_frac"] <= p2["occupancy"] <= 1.0
    assert dw.free_slots == 2


# ---------------------------------------------------------------------------
# stop() around preemption (tests/test_preemption.py)
# ---------------------------------------------------------------------------

def test_loop_stop_mid_spill_releases_everything(setup):
    """stop() while a victim sits in the spill slab: no stranded slab
    entries, device pages or staged runs."""
    cfg, params = setup
    pws, dw, pp, pool = _mk(cfg, params, max_batch=1, max_len=640,
                            n_pages=17, n_workers=1)
    loop = ServingLoop(pws, dw, chunks_per_iter=2, max_queue=16)
    rng = np.random.default_rng(13)
    assert loop.submit(_req(0, rng.integers(0, cfg.vocab_size, 512), 24))
    while len(loop.outputs.get(0, RequestOutput(0)).tokens) < 4:
        loop.iterate()
    assert loop.submit(_req(1, rng.integers(0, cfg.vocab_size, 128), 64,
                            priority=1))
    while loop.stats()["preemptions"] == 0:
        loop.iterate()
    assert pool.spill_depth() == 1
    loop.stop()
    loop.run()
    assert dw.n_active == 0
    assert pool.spill_depth() == 0
    assert pool.stats()["spill_drops"] == 1      # abandoned, not restored
    pp.check_leaks()
    pool.close()


def test_loop_stop_mid_restore_releases_everything(setup):
    """stop() after the victim re-entered through a recompute prefill
    that is mid-chunks still unwinds everything."""
    cfg, params = setup
    pws, dw, pp, pool = _mk(cfg, params, max_batch=1, max_len=640,
                            n_pages=17, n_workers=1)
    loop = ServingLoop(pws, dw, chunks_per_iter=1, max_queue=16,
                       restore_mode="recompute")
    rng = np.random.default_rng(14)
    assert loop.submit(_req(0, rng.integers(0, cfg.vocab_size, 512), 24))
    while len(loop.outputs.get(0, RequestOutput(0)).tokens) < 4:
        loop.iterate()
    assert loop.submit(_req(1, rng.integers(0, cfg.vocab_size, 128), 4,
                            priority=1))
    while loop.stats()["restores_recompute"] == 0:
        loop.iterate()
    loop.stop()
    loop.run()
    assert dw.n_active == 0
    assert pool.spill_depth() == 0
    pp.check_leaks()
    pool.close()


def test_submit_queue_cap_atomic_under_contention(setup):
    """16 racing submitters against a cap of 4 (every signal() read
    yields the GIL): the cap check and the enqueue are one atomic step,
    so at most 4 get in and the counters add up."""
    cfg, params = setup
    pws, dw, _, _ = _mk(cfg, params)

    class RacyLoop(ServingLoop):
        def signal(self):
            sig = super().signal()
            time.sleep(0.002)
            return sig

    cap, n_threads = 4, 16
    loop = RacyLoop(pws, dw, max_queue=cap, admission="baseline")
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, 64)
    barrier = threading.Barrier(n_threads)
    results = [None] * n_threads

    def submitter(i):
        barrier.wait()
        results[i] = loop.submit(_req(i, toks, 1))

    threads = [threading.Thread(target=submitter, args=(i,),
                                name=f"repro-submit-{i}")
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    accepted = sum(bool(r) for r in results)
    assert loop._arrivals.qsize() == accepted <= cap
    st = loop.stats()
    assert st["submitted"] == n_threads
    assert st["rejected"] == n_threads - accepted
    loop.stop()
    loop.run()


# ---------------------------------------------------------------------------
# the request surface, and the legacy forms
# ---------------------------------------------------------------------------

def test_serving_request_validation(setup):
    with pytest.raises(ValueError, match="max_new"):
        ServingRequest(req_id=0, tokens=np.arange(4), max_new=0)
    assert isinstance(ServingRequest(1, [1, 2, 3], 2).tokens, np.ndarray)
    cfg, params = setup
    pws, dw, _, _ = _mk(cfg, params)
    with pytest.raises(ValueError, match="tokens is required"):
        ServingLoop(pws, dw).submit(ServingRequest(0, None, 2))


@pytest.fixture(scope="module")
def reference():
    jcfg = jax_config("smollm-360m").reduced()
    return jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0))


def test_legacy_submit_raises_where_the_reference_warns(setup, reference):
    """``submit(req_id, tokens, max_new)``: the reference serves it behind
    a DeprecationWarning; the port refuses it and runs nothing."""
    jcfg, jp = reference
    jpp = JDevicePagePool(jcfg, n_pages=1 + 6 * 8, page_tokens=64)
    jloop = JServingLoop(
        [JPrefillWorker(jp, jcfg, JHostKVPool(), prefill_chunk=64,
                        page_pool=jpp)],
        JDecodeWorker(jp, jcfg, max_batch=4, max_len=512, page_pool=jpp),
        max_queue=8)
    toks = np.random.default_rng(15).integers(0, jcfg.vocab_size, 80)
    with pytest.warns(DeprecationWarning, match="pass a ServingRequest"):
        assert jloop.submit(0, toks, max_new=2)
    jloop.close_intake()
    assert jloop.run()["completed"] == 1

    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params)
    loop = ServingLoop(pws, dw, max_queue=8)
    with pytest.raises((TypeError, AttributeError)):
        loop.submit(0, toks, max_new=2)
    with pytest.raises((TypeError, AttributeError)):
        loop.submit(0, toks, 2)
    assert loop.stats()["submitted"] == 0
    loop.close_intake()
    assert loop.run()["completed"] == 0
    pp.check_leaks()


def test_legacy_join_raises_where_the_reference_warns(setup, reference):
    """``join(req_id, pres, max_new=...)``: the reference joins behind a
    DeprecationWarning; the port refuses both legacy forms, leaves the
    batch as it was, and the staged run is released by its owner."""
    jcfg, jp = reference
    jpp = JDevicePagePool(jcfg, n_pages=1 + 6 * 8, page_tokens=64)
    jpw = JPrefillWorker(jp, jcfg, JHostKVPool(), prefill_chunk=64,
                         page_pool=jpp)
    jdw = JDecodeWorker(jp, jcfg, max_batch=4, max_len=512, page_pool=jpp)
    toks = np.random.default_rng(16).integers(0, jcfg.vocab_size, 80)
    with pytest.warns(DeprecationWarning, match="pass a ServingRequest"):
        jdw.join(0, jpw(toks), max_new=2)
    assert jdw.n_active == 1

    cfg, params = setup
    pws, dw, pp, _ = _mk(cfg, params, n_workers=1)
    res = pws[0](toks)
    with pytest.raises((TypeError, AttributeError)):
        dw.join(0, res, max_new=2)
    with pytest.raises((TypeError, AttributeError)):
        dw.join(0, res)
    assert dw.n_active == 0 and dw.free_slots == dw.max_batch
    res.release_pages()
    pp.check_leaks()
