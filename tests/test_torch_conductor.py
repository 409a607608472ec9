"""The port's scheduler against the reference: cost model, layer-wise
timeline, Messenger, every registered prefill and decode policy, and the
Conductor — plus the port-internal mirrors of ``tests/test_conductor.py``,
``tests/test_costmodel.py`` and the Conductor-only cases of
``tests/test_policies.py``.

Equalities are EXACT (``==`` on floats): the port's modules are the
reference's arithmetic term for term, so under the reference's ``V5E``
hardware values (``dataclasses.asdict(repro.core.costmodel.V5E)``) and
the same ``now``s every price and every decision must come out
bit-identical. Both packages' metadata pools, directories and
messengers are built side by side from the same seeded operations."""
import dataclasses
import random

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # sandboxed env: vendored shim (seeded random)
    from _hypothesis_shim import given, settings, strategies as st

import repro.core.policies as JPolicies
from repro.configs.base import get_config as jax_config
from repro.core.cache import CachePool as JCachePool
from repro.core.conductor import Conductor as JConductor
from repro.core.conductor import DecodeInstance as JDecodeInstance
from repro.core.conductor import PrefillInstance as JPrefillInstance
from repro.core.costmodel import V5E
from repro.core.costmodel import CostModel as JCostModel
from repro.core.costmodel import InstanceSpec as JInstanceSpec
from repro.core.directory import GlobalBlockDirectory as JDirectory
from repro.core.messenger import Messenger as JMessenger
from repro.core.tiered import TieredCachePool as JTieredCachePool
from repro.core.trace import TraceSpec as JTraceSpec
from repro.core.trace import generate_trace as jax_generate_trace
from repro.serving.layerwise import occupation_cost as jax_occupation_cost
from repro.serving.layerwise import schedule as jax_schedule
from repro_torch.configs.base import get_config
from repro_torch.core.cache import CachePool, make_policy
from repro_torch.core.conductor import (Conductor, DecodeInstance,
                                        PrefillInstance)
from repro_torch.core.costmodel import H100, CostModel, Hardware, InstanceSpec
from repro_torch.core.directory import GlobalBlockDirectory
from repro_torch.core.messenger import Messenger
from repro_torch.core.policies import (get_policy, list_policies,
                                       register_policy)
from repro_torch.core.policies.base import _REGISTRY
from repro_torch.core.policies.routing import recompute_arm
from repro_torch.core.tiered import TieredCachePool
from repro_torch.core.trace import (BLOCK_TOKENS, Request, TraceSpec,
                                    generate_trace)
from repro_torch.serving.layerwise import occupation_cost, schedule

torch.set_num_threads(1)

ARCHS = ["smollm-360m", "llama2-70b", "mamba2-2.7b"]
PREFILL_POLICIES = list_policies("prefill")
DECODE_POLICIES = list_policies("decode")
V5E_INST = InstanceSpec(n_chips=16, hw=Hardware(**dataclasses.asdict(V5E)))
CFG = get_config("llama2-70b")


def _windowed(cfg):
    """A sliding-window variant (the reference prices mixtral's 4096-token
    window; the port has no MoE config, so the window goes on llama)."""
    return dataclasses.replace(cfg, name=cfg.name + "-swa",
                               sliding_window=4096)


# ---------------------------------------------------------------------------
# cost model and layer-wise timeline: exact parity
# ---------------------------------------------------------------------------

def _cost_pair(arch, window=False):
    cfg, jcfg = get_config(arch), jax_config(arch)
    if window:
        cfg, jcfg = _windowed(cfg), _windowed(jcfg)
    return CostModel(cfg, V5E_INST), JCostModel(jcfg, JInstanceSpec())


@pytest.mark.parametrize("arch,window", [(a, False) for a in ARCHS]
                         + [("llama2-70b", True)])
def test_costmodel_equals_reference(arch, window):
    cm, jcm = _cost_pair(arch, window)
    assert cm.cfg.param_count() == jcm.cfg.param_count()
    assert cm.cfg.active_param_count() == jcm.cfg.active_param_count()
    assert (cm.n_params_active, cm.kv_token_bytes, cm.weight_bytes) == \
        (jcm.n_params_active, jcm.kv_token_bytes, jcm.weight_bytes)
    rng = np.random.default_rng(7)
    for _ in range(200):
        L = int(rng.integers(0, 300_000))
        prefix = int(rng.integers(-10, L + 2048))
        b = int(rng.integers(1, 512))
        ctx = float(rng.uniform(0, 200_000))
        tok = int(rng.integers(0, 100_000))
        bw = float(rng.uniform(1e9, 1e12))
        frac = float(rng.uniform(0.1, 1.0))
        assert cm.prefill_flops(L, prefix) == jcm.prefill_flops(L, prefix)
        if L:
            assert cm.prefill_time(L, prefix) == jcm.prefill_time(L, prefix)
        assert cm.decode_iter_time(b, ctx) == jcm.decode_iter_time(b, ctx)
        assert cm.decode_capacity_tokens(frac) == \
            jcm.decode_capacity_tokens(frac)
        for f in ("kv_bytes", "dram_load_time", "ssd_load_time",
                  "ssd_write_time", "peer_ssd_load_time"):
            assert getattr(cm, f)(tok) == getattr(jcm, f)(tok), f
        assert cm.transfer_time(tok) == jcm.transfer_time(tok)
        assert cm.transfer_time(tok, bw) == jcm.transfer_time(tok, bw)
    # the measured SSD read replaces the configured bandwidth in both
    cm.calibrate_ssd_read(0.0123, block_tokens=512)
    jcm.calibrate_ssd_read(0.0123, block_tokens=512)
    assert cm.ssd_calibrated and jcm.ssd_calibrated
    for tok in (0, 1, 512, 4097, 131072):
        assert cm.ssd_load_time(tok) == jcm.ssd_load_time(tok)
        assert cm.peer_ssd_load_time(tok) == jcm.peer_ssd_load_time(tok)
    with pytest.raises(ValueError):
        cm.calibrate_ssd_read(0.0)


def test_h100_hardware_names_no_tpu_number():
    """The port's defaults describe an H100 node: none of the reference's
    TPU values survives, and the node is the paper's 8-accelerator
    instance."""
    ref = dataclasses.asdict(V5E)
    own = dataclasses.asdict(H100)
    assert set(own) == set(ref)
    assert own["peak_flops"] == 989e12 and own["hbm_bw"] == 3.35e12
    assert own["hbm_bytes"] == 80e9 and own["ici_bw"] == 450e9
    for name in ("peak_flops", "hbm_bw", "ici_bw", "dram_bw", "ssd_read_bw",
                 "ssd_write_bw", "hbm_bytes", "mfu_prefill", "mbu_decode"):
        assert own[name] != ref[name], name
    assert 0 < own["mfu_prefill"] <= 1 and 0 < own["mbu_decode"] <= 1
    assert InstanceSpec().n_chips == 8 and InstanceSpec().hw == H100


@pytest.mark.parametrize("L,prefix,store_bw", [
    (4096, 0, None), (32768, 8192, None), (131072, 0, 25e9),
    (65536, 60000, 1e12)])
def test_layerwise_schedule_equals_reference(L, prefix, store_bw):
    tl = schedule(CFG, L, prefix, inst=V5E_INST, store_bw=store_bw)
    jtl = jax_schedule(jax_config("llama2-70b"), L, prefix,
                       inst=JInstanceSpec(), store_bw=store_bw)
    assert dataclasses.asdict(tl) == dataclasses.asdict(jtl)
    assert tl.n_layers == jtl.n_layers and tl.overhead == jtl.overhead
    assert occupation_cost(CFG, L, inst=V5E_INST) == \
        jax_occupation_cost(jax_config("llama2-70b"), L, inst=JInstanceSpec())


# ---------------------------------------------------------------------------
# Messenger: exact parity over a seeded op sequence
# ---------------------------------------------------------------------------

def _links(m):
    return ({k: dataclasses.asdict(v) for k, v in m.links.items()},
            {k: dataclasses.asdict(v) for k, v in m.ssd_links.items()})


def test_messenger_equals_reference():
    nodes = [0, 1, 2, 100]
    m, jm = Messenger(nodes, bw=100e9), JMessenger(nodes, bw=100e9)
    rng = random.Random(3)
    now = 0.0
    for step in range(400):
        now += rng.uniform(0.0, 0.05)
        node = rng.choice(nodes + [7])
        nbytes = rng.uniform(0, 5e9)
        op = rng.choice(["estimate", "enqueue", "congestion", "add_node",
                         "add_ssd", "has_ssd", "est_ssd", "enq_ssd",
                         "set_ssd_bw", "set_link_bw", "est_peer_ssd",
                         "enq_peer_ssd"])
        args = dict(
            estimate=(node, nbytes, now), enqueue=(node, nbytes, now),
            congestion=(node, now), add_node=(node, rng.uniform(1e9, 2e11)),
            add_ssd=(node, rng.uniform(1e9, 1e10)), has_ssd=(node,),
            est_ssd=(node, nbytes, now), enq_ssd=(node, nbytes, now),
            set_ssd_bw=(node, rng.uniform(1e8, 1e10)),
            set_link_bw=(node, rng.uniform(1e8, 1e11)),
            est_peer_ssd=(node, nbytes, now),
            enq_peer_ssd=(node, nbytes, now))[op]
        name = dict(add_ssd="add_ssd_channel", has_ssd="has_ssd_channel",
                    est_ssd="estimate_ssd", enq_ssd="enqueue_ssd",
                    est_peer_ssd="estimate_peer_ssd",
                    enq_peer_ssd="enqueue_peer_ssd").get(op, op)

        def call(msg):
            try:
                return ("ok", getattr(msg, name)(*args))
            except KeyError as e:
                return ("KeyError", str(e))
        assert call(m) == call(jm), (step, op, args)
        assert _links(m) == _links(jm), (step, op)


# ---------------------------------------------------------------------------
# every registered policy through both Conductors
# ---------------------------------------------------------------------------

def _cluster(pkg, pool_kind, strategy, decode_policy):
    """Three prefill and two decode instances of one package over
    ``pool_kind`` pools (flat, tiered, tiered with a shared directory)."""
    if pkg == "port":
        cfg, inst = CFG, V5E_INST
        CP, TP, Dir, CM = CachePool, TieredCachePool, GlobalBlockDirectory, \
            CostModel
        PI, DI, Msg, Cond = PrefillInstance, DecodeInstance, Messenger, \
            Conductor
    else:
        cfg, inst = jax_config("llama2-70b"), JInstanceSpec()
        CP, TP, Dir, CM = JCachePool, JTieredCachePool, JDirectory, \
            JCostModel
        PI, DI, Msg, Cond = JPrefillInstance, JDecodeInstance, JMessenger, \
            JConductor
    directory = Dir() if pool_kind == "directory" else None
    pools = [CP(96) if pool_kind == "flat" else TP(24, 256)
             for _ in range(3)]
    if directory is not None:
        for i, p in enumerate(pools):
            directory.bind(i, p)
    P = [PI(iid=i, pool=pools[i], cost=CM(cfg, inst)) for i in range(3)]
    D = [DI(iid=100 + i, cost=CM(cfg, inst)) for i in range(2)]
    msg = Msg([p.iid for p in P] + [d.iid for d in D], bw=100e9)
    if pool_kind != "flat":
        for p in P:
            msg.add_ssd_channel(p.iid, inst.hw.ssd_read_bw)
    return Cond(P, D, msg, ttft_slo=30.0, tbt_slo=0.1, strategy=strategy,
                decode_policy=decode_policy, directory=directory)


def _decision(d):
    return (d.accepted, d.prefill.iid if d.prefill else None,
            d.decode.iid if d.decode else None, d.expected_ttft,
            d.expected_tbt, d.prefix_blocks, d.migrated_blocks,
            d.transfer_from, d.ssd_blocks, d.peer_ssd_blocks,
            d.ssd_load_time, d.compute_time, d.arm_kind, d.reject_reason)


def _state(c):
    return (
        [(p.queue_free_at, p.total_busy, p.n_scheduled) for p in c.P],
        [(d.active, d.kv_tokens, d.pending, d.pending_tokens, d.n_scheduled)
         for d in c.D],
        _links(c.messenger),
        (c.n_migrations, c.migrated_bytes, c.n_ssd_loads,
         c.ssd_loaded_bytes, c.n_peer_ssd_loads, c.peer_ssd_bytes))


@pytest.fixture(scope="module")
def traces():
    spec = dict(n_requests=160, duration_ms=40_000, seed=4,
                max_input_tokens=32_768)
    port, ref = generate_trace(TraceSpec(**spec)), \
        jax_generate_trace(JTraceSpec(**spec))
    assert [(r.timestamp, r.input_length, r.output_length, r.hash_ids)
            for r in port] == [(r.timestamp, r.input_length, r.output_length,
                                r.hash_ids) for r in ref]
    return port, ref


@pytest.mark.parametrize("pool_kind", ["flat", "tiered", "directory"])
@pytest.mark.parametrize("decode_policy", DECODE_POLICIES)
@pytest.mark.parametrize("strategy", PREFILL_POLICIES)
def test_conductor_decisions_equal_reference(traces, strategy,
                                             decode_policy, pool_kind):
    port, ref = traces
    c = _cluster("port", pool_kind, strategy, decode_policy)
    jc = _cluster("ref", pool_kind, strategy, decode_policy)
    kinds = set()
    for r, jr in zip(port, ref):
        now = r.timestamp / 1000.0
        d, jd = c.schedule(r, now), jc.schedule(jr, now)
        assert _decision(d) == _decision(jd), r.req_id
        kinds.add(d.arm_kind or d.reject_reason)
    assert _state(c) == _state(jc)
    assert len(kinds) > 1       # the trace exercised more than one outcome


def test_policy_lists_equal_reference():
    assert list_policies("prefill") == JPolicies.list_policies("prefill")
    assert list_policies("decode") == JPolicies.list_policies("decode")


# ---------------------------------------------------------------------------
# mirrors of tests/test_conductor.py
# ---------------------------------------------------------------------------

def make_cluster(n_p=3, n_d=2, *, strategy="kvcache", threshold=1.3,
                 ttft_slo=30.0, tbt_slo=0.1):
    cost = lambda: CostModel(CFG, InstanceSpec())
    P = [PrefillInstance(iid=i, pool=CachePool(), cost=cost())
         for i in range(n_p)]
    D = [DecodeInstance(iid=100 + i, cost=cost()) for i in range(n_d)]
    msg = Messenger([p.iid for p in P] + [d.iid for d in D], bw=100e9)
    c = Conductor(P, D, msg, ttft_slo=ttft_slo, tbt_slo=tbt_slo,
                  balancing_threshold=threshold, strategy=strategy)
    return c, P, D


def req(rid, n_blocks=8, out=128, base=0):
    return Request(req_id=rid, timestamp=0,
                   input_length=n_blocks * BLOCK_TOKENS, output_length=out,
                   hash_ids=[base + i for i in range(n_blocks)])


def test_prefers_instance_with_prefix():
    c, P, D = make_cluster()
    P[1].pool.insert(range(8))
    dec = c.schedule(req(0, 8), now=0.0)
    assert dec.accepted and dec.prefill is P[1]
    assert dec.prefix_blocks == 8


def test_balances_away_from_busy_instance():
    c, P, D = make_cluster()
    P[1].pool.insert(range(8))
    P[1].queue_free_at = 100.0
    dec = c.schedule(req(0, 8), now=0.0)
    assert dec.accepted and dec.prefill is not P[1]
    assert dec.migrated_blocks == 8
    assert dec.prefill.pool.prefix_len(list(range(8))) == 8
    assert c.n_migrations == 1


def test_no_migration_when_local_prefix_close():
    c, P, D = make_cluster(n_p=2, threshold=1.3)
    P[0].pool.insert(range(8))
    P[1].pool.insert(range(7))
    P[0].queue_free_at = 50.0
    dec = c.schedule(req(0, 8), now=0.0)
    assert dec.prefill is P[1]
    assert dec.migrated_blocks == 0


def test_rejects_on_ttft_slo():
    c, P, D = make_cluster(ttft_slo=0.5)
    for p in P:
        p.queue_free_at = 10.0
    dec = c.schedule(req(0, 8), now=0.0)
    assert not dec.accepted and "TTFT" in dec.reject_reason


def test_rejects_on_decode_vram():
    c, P, D = make_cluster(n_d=1)
    D[0].kv_tokens = D[0].cost.decode_capacity_tokens()
    dec = c.schedule(req(0, 8), now=0.0)
    assert not dec.accepted and "decode" in dec.reject_reason


def test_queue_time_accumulates():
    c, P, D = make_cluster(n_p=1)
    d1 = c.schedule(req(0, 8), now=0.0)
    free1 = P[0].queue_free_at
    d2 = c.schedule(req(1, 8, base=100), now=0.0)
    assert P[0].queue_free_at > free1
    assert d2.expected_ttft > d1.expected_ttft


def test_cache_aware_never_migrates():
    c, P, D = make_cluster(strategy="cache_aware")
    P[1].pool.insert(range(8))
    P[1].queue_free_at = 100.0
    dec = c.schedule(req(0, 8), now=0.0)
    assert dec.migrated_blocks == 0 and c.n_migrations == 0


def test_transfer_congestion_discourages_migration():
    c, P, D = make_cluster()
    P[1].pool.insert(range(64))
    P[1].queue_free_at = 8.0
    c.messenger.links[P[1].iid].busy_until = 1e4
    dec = c.schedule(req(0, 64), now=0.0)
    assert dec.accepted
    assert dec.migrated_blocks == 0


# ---------------------------------------------------------------------------
# mirrors of tests/test_costmodel.py (on the H100 defaults)
# ---------------------------------------------------------------------------

CM = CostModel(CFG, InstanceSpec())


def test_prefill_superlinear_in_length():
    per_tok = [CM.prefill_time(L) / L for L in (4096, 16384, 65536, 262144)]
    assert all(b > a for a, b in zip(per_tok, per_tok[1:]))


def test_decode_sublinear_in_batch():
    ts = [CM.decode_iter_time(b, 8192) for b in (1, 8, 64)]
    assert ts[1] < 8 * ts[0]
    assert ts[2] < 8 * ts[1]
    assert ts[1] >= ts[0] and ts[2] > ts[1]


@given(st.integers(1024, 100_000), st.integers(0, 50_000))
@settings(max_examples=40, deadline=None)
def test_prefix_cache_always_helps(L, prefix):
    prefix = min(prefix, L)
    assert CM.prefill_time(L, prefix) <= CM.prefill_time(L, 0) + 1e-12
    assert 0 < CM.prefill_flops(L, L) <= CM.prefill_flops(L, 0) * 0.01
    assert CM.prefill_flops(L, 2 * L) == CM.prefill_flops(L, L)


@given(st.integers(1, 256), st.integers(512, 65536))
@settings(max_examples=40, deadline=None)
def test_decode_iter_positive_and_monotone_in_ctx(b, ctx):
    t1 = CM.decode_iter_time(b, ctx)
    t2 = CM.decode_iter_time(b, ctx * 2)
    assert 0 < t1 <= t2


def test_sliding_window_caps_decode_cost():
    swa = CostModel(_windowed(CFG), InstanceSpec())
    assert swa.decode_iter_time(16, 500_000) == \
        pytest.approx(swa.decode_iter_time(16, 4096))


def test_ssm_decode_cost_ctx_free():
    ssm = CostModel(get_config("mamba2-2.7b"), InstanceSpec())
    assert ssm.decode_iter_time(16, 1000) == \
        pytest.approx(ssm.decode_iter_time(16, 500_000))


def test_layerwise_schedule_bounds():
    for L in (4096, 32768, 131072):
        tl = schedule(CFG, L)
        assert tl.total_overlapped <= tl.total_serial + 1e-9
        assert tl.t_store_layer >= 0 and tl.t_compute_layer > 0


def test_layerwise_store_hidden_at_long_context():
    assert schedule(CFG, 65536).store_hidden


def test_occupation_cost_favours_layerwise():
    oc = occupation_cost(CFG, 32768)
    assert oc["layerwise_cost"] < oc["inline_cost"]


# ---------------------------------------------------------------------------
# mirrors of the Conductor cases of tests/test_policies.py
# ---------------------------------------------------------------------------

def make_pcluster(strategy="kvcache", n_p=3, n_d=2, *, ttft_slo=30.0,
                  tbt_slo=0.1, tiered=True, ssd_bw=6e9):
    """Instance 1 holds a full DRAM prefix, instance 2 a partial one
    spilling into SSD, instance 0 is cold (every arm kind is live)."""
    cost = lambda: CostModel(CFG, InstanceSpec())
    mk = (lambda: TieredCachePool(64, 512)) if tiered else CachePool
    P = [PrefillInstance(iid=i, pool=mk(), cost=cost()) for i in range(n_p)]
    D = [DecodeInstance(iid=100 + i, cost=cost()) for i in range(n_d)]
    msg = Messenger([p.iid for p in P] + [d.iid for d in D], bw=100e9)
    if tiered:
        for p in P:
            msg.add_ssd_channel(p.iid, ssd_bw)
    P[1].pool.insert(range(8))
    if tiered:
        P[2].pool.insert(range(5))
        for k in (3, 4):
            meta = P[2].pool.remove(k)
            P[2].pool.ssd.insert_meta(meta)
    c = Conductor(P, D, msg, ttft_slo=ttft_slo, tbt_slo=tbt_slo,
                  strategy=strategy)
    return c, P, D


def preq(rid=0, n_blocks=8, out=64):
    return Request(req_id=rid, timestamp=0,
                   input_length=n_blocks * BLOCK_TOKENS, output_length=out,
                   hash_ids=list(range(n_blocks)))


def snapshot(c):
    return (
        tuple((p.queue_free_at, p.total_busy, p.n_scheduled,
               tuple(sorted(p.pool.blocks)),
               tuple(sorted(getattr(p.pool, "ssd", p.pool).blocks)))
              for p in c.P),
        tuple((d.pending, d.pending_tokens, d.n_scheduled) for d in c.D),
        tuple(sorted((k, l.busy_until, l.n_transfers)
                     for k, l in c.messenger.links.items())),
        tuple(sorted((k, l.busy_until, l.n_transfers)
                     for k, l in c.messenger.ssd_links.items())),
        (c.n_migrations, c.n_ssd_loads),
    )


def test_unknown_policy_raises_valueerror_listing_names():
    with pytest.raises(ValueError) as e:
        get_policy("prefill", "nope")
    for name in PREFILL_POLICIES:
        assert name in str(e.value)


def test_conductor_unknown_strategy():
    with pytest.raises(ValueError, match="kvcache"):
        make_pcluster(strategy="definitely_not_registered")


def test_eviction_make_policy_unknown_name():
    with pytest.raises(ValueError, match="lru"):
        make_policy("nope")


def test_register_policy_roundtrip():
    @register_policy("prefill", "_test_local_only")
    class LocalOnly:
        def __init__(self, ctx):
            self.ctx = ctx

        def propose(self, req, instances, now):
            return [recompute_arm(instances[0], req, now)]

    try:
        assert "_test_local_only" in list_policies("prefill")
        c, P, D = make_pcluster(strategy="_test_local_only")
        dec = c.schedule(preq(), 0.0)
        assert dec.accepted and dec.prefill is P[0]
    finally:
        del _REGISTRY[("prefill", "_test_local_only")]


def test_register_policy_bad_kind():
    with pytest.raises(ValueError, match="kind"):
        register_policy("sideways", "x")


@pytest.mark.parametrize("strategy", PREFILL_POLICIES)
def test_propose_is_pure_and_wellformed(strategy):
    c, P, D = make_pcluster(strategy)
    P[0].queue_free_at = 3.0
    before = snapshot(c)
    c.ctx.rng = random.Random(0)
    arms = c.propose(preq(), now=0.0)
    assert arms
    for a in arms:
        assert a.ttft >= 0.0 and a.compute_time >= 0.0
        assert a.sort_key >= 0.0
        assert a.instance in P
        assert a.prefix_blocks >= 0 and a.ssd_blocks >= 0
    assert snapshot(c) == before
    c.ctx.rng = random.Random(0)
    arms2 = c.propose(preq(), now=0.0)
    assert [a.ttft for a in arms] == [a.ttft for a in arms2]
    assert snapshot(c) == before


@pytest.mark.parametrize("strategy", PREFILL_POLICIES)
def test_accept_assigns_instances_and_commits_once(strategy):
    c, P, D = make_pcluster(strategy)
    before = snapshot(c)
    dec = c.schedule(preq(), now=0.0)
    assert dec.accepted
    assert dec.prefill is not None and dec.decode is not None
    assert dec.expected_ttft >= 0.0 and dec.compute_time > 0.0
    assert dec.prefill.queue_free_at > 0.0
    assert dec.prefill.n_scheduled == 1
    assert dec.decode.pending == 1
    assert snapshot(c) != before
    assert dec.prefill.pool.lookup(preq().hash_ids, touch=False) \
        == preq().n_blocks


@pytest.mark.parametrize("strategy", PREFILL_POLICIES)
def test_reject_leaves_state_untouched(strategy):
    c, P, D = make_pcluster(strategy, ttft_slo=1e-12)
    before = snapshot(c)
    dec = c.schedule(preq(), now=0.0)
    assert not dec.accepted and dec.reject_reason
    assert snapshot(c) == before


@pytest.mark.parametrize("strategy", PREFILL_POLICIES)
def test_flat_pool_still_schedules(strategy):
    c, P, D = make_pcluster(strategy, tiered=False)
    dec = c.schedule(preq(), now=0.0)
    assert dec.accepted and dec.ssd_blocks == 0


@pytest.mark.parametrize("dec", DECODE_POLICIES)
def test_decode_select_is_pure_and_honest(dec):
    c, P, D = make_pcluster()
    D[0].active, D[0].kv_tokens = 2, 60_000.0
    D[1].pending, D[1].pending_tokens = 1, 30_000.0
    pol = get_policy("decode", dec)(c.ctx)
    before = snapshot(c)
    r = preq()
    tokens = r.input_length + r.output_length
    pick1, tbt1 = pol.select(r, D, 0.0)
    pick2, tbt2 = pol.select(r, D, 0.0)
    assert pick1 is pick2 and tbt1 == tbt2
    assert snapshot(c) == before
    assert pick1.vram_ok(tokens)
    assert tbt1 == pick1.predicted_tbt(1, tokens, include_pending=True)


def test_why_not_both_never_predicts_slower_than_kvcache():
    for n_blocks in (4, 8, 12):
        a, _, _ = make_pcluster("kvcache")
        b, _, _ = make_pcluster("why_not_both")
        r = preq(n_blocks=n_blocks)
        t_kv = min(x.ttft for x in a.propose(r, 0.0))
        t_wnb = min(x.ttft for x in b.propose(r, 0.0))
        assert t_wnb <= t_kv + 1e-12


def test_why_not_both_overlap_beats_pure_arms():
    """With an idle queue and an SSD whose block load takes as long as a
    block's recompute (the regime the split exists for: the reference's
    6 GB/s channel against its slower node; the H100 node recomputes
    3.5x faster, so its channel is scaled to match), the split arm beats
    both pure plans on the same instance."""
    cm = CostModel(CFG, InstanceSpec())
    bw = cm.kv_bytes(BLOCK_TOKENS) / cm.prefill_time(4 * BLOCK_TOKENS,
                                                     3 * BLOCK_TOKENS)
    c, P, D = make_pcluster("why_not_both", ssd_bw=bw)
    kv, _, _ = make_pcluster("kvcache", ssd_bw=bw)
    r = preq(n_blocks=5)
    overlap = [a for a in c.propose(r, 0.0) if a.kind == "overlap"]
    assert overlap
    arm = min(overlap, key=lambda a: a.ttft)
    assert 0 < arm.ssd_blocks < 2
    pure_load = [a for a in kv.propose(r, 0.0) if a.kind == "ssd_load"
                 and a.instance.iid == arm.instance.iid]
    assert pure_load and arm.ttft <= min(a.ttft for a in pure_load) + 1e-12
    inst = next(p for p in c.P if p.iid == arm.instance.iid)
    assert arm.ttft <= recompute_arm(inst, r, 0.0).ttft + 1e-12


def test_load_aware_prices_transfers_the_ratio_gate_skips():
    cost = lambda: CostModel(CFG, InstanceSpec())
    P = [PrefillInstance(iid=i, pool=CachePool(), cost=cost())
         for i in range(2)]
    D = [DecodeInstance(iid=100, cost=cost())]
    msg = Messenger([0, 1, 100], bw=100e9)
    P[0].pool.insert(range(8))
    P[1].pool.insert(range(7))
    kv = Conductor(P, D, msg, ttft_slo=30, tbt_slo=0.1, strategy="kvcache")
    la = Conductor(P, D, msg, ttft_slo=30, tbt_slo=0.1, strategy="load_aware")
    r = preq(n_blocks=8)
    assert not any(a.kind == "peer_fetch" for a in kv.propose(r, 0.0))
    fetches = [a for a in la.propose(r, 0.0) if a.kind == "peer_fetch"]
    assert fetches and fetches[0].instance is P[1]
    assert fetches[0].migrate_blocks == 1


def test_load_aware_penalty_biases_score_not_ttft():
    c, P, D = make_pcluster("load_aware")
    P[1].queue_free_at = 50.0
    arms = c.propose(preq(), now=0.0)
    hot = [a for a in arms if a.instance is P[1]]
    assert hot and all(a.score is not None and a.score > a.ttft for a in hot)
    cold = [a for a in arms if a.instance is P[0]]
    assert all(a.score == pytest.approx(a.ttft) for a in cold)
