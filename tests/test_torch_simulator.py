"""The port's simulator against the reference: ``MooncakeCluster`` for
every registered prefill strategy × admission policy, the tiered and
global-pool scenario, priority relief, ``CoupledCluster``, the trace
helpers, the Table-1 analysis, ``ClusterSpec`` and ``make_admission``.

Equalities are EXACT (``==`` on floats): the port's simulator, Conductor,
policies and cost model are the reference's arithmetic term for term, so
under the reference's ``V5E`` hardware values
(``dataclasses.asdict(repro.core.costmodel.V5E)``) every record, every
load sample and every counter must come out bit-identical. The reference
side is built with its own default instance; the port's with the
V5E-valued ``InstanceSpec``, since the port's default is an H100 node."""
import dataclasses
import math

import pytest

import repro.core as J
from repro.configs.base import get_config as jax_config
from repro.configs.base import list_configs as jax_list_configs
from repro.core.costmodel import V5E
from repro_torch import core as P
from repro_torch.configs.base import get_config, list_configs
from repro_torch.core.costmodel import H100, Hardware, InstanceSpec

V5E_INST = InstanceSpec(n_chips=16, hw=Hardware(**dataclasses.asdict(V5E)))
ARCH = "llama2-70b"
PREFILL_POLICIES = P.list_policies("prefill")
ADMISSION_POLICIES = P.list_policies("admission")


@pytest.fixture(scope="module")
def traces():
    """(port, reference) copies of the prescribed trace and of the
    reference's overload trace (``tests/test_policies.py``)."""
    out = {}
    for name, kw in (("main", dict(n_requests=300, duration_ms=240_000,
                                   seed=1)),
                     ("overload", dict(n_requests=600, duration_ms=100_000,
                                       seed=5, out_mu=5.9))):
        out[name] = (P.generate_trace(P.TraceSpec(**kw)),
                     J.generate_trace(J.TraceSpec(**kw)))
    return out


def _same(a, b) -> bool:
    """``==``, with NaN equal to NaN (empty aggregates)."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def _record(r) -> tuple:
    q = r.req
    return ((q.req_id, q.timestamp, q.input_length, q.output_length,
             q.hash_ids, q.priority),
            r.arrival, r.accepted, r.reject_stage, r.reject_reason,
            r.prefill_start, r.ttft, r.tbts, r.done, r.prefix_blocks,
            r.ssd_blocks, r.peer_ssd_blocks, r.ssd_load_time,
            getattr(r, "_last_tok", None), getattr(r, "_emitted", None))


def _result(res, slos=((30.0, 0.1), (10.0, 0.05))) -> tuple:
    aggregates = [res.reject_breakdown(), res.ttft_p90(), res.tbt_p90(),
                  res.avg_ttft(), len(res.completed()), len(res.rejected())]
    for ttft, tbt in slos:
        aggregates += [res.slo_ok_count(ttft, tbt), res.goodput(ttft, tbt),
                       res.goodput(ttft, tbt, window=100.0),
                       res.slo_attainment(ttft, tbt)]
    return ([_record(r) for r in res.records], res.duration,
            res.load_samples, res.n_migrations, res.n_ssd_loads,
            res.n_peer_ssd_loads, aggregates)


def _cluster_state(mc) -> tuple:
    """Everything the run leaves behind in the cluster's components."""
    c = mc.conductor
    pools = []
    for p in mc.prefills:
        ssd = getattr(p.pool, "ssd", None)
        pools.append((p.queue_free_at, p.total_busy, p.n_scheduled,
                      sorted(p.pool.blocks), p.pool.hits, p.pool.misses,
                      sorted(ssd.blocks) if ssd is not None else None))
    return (pools,
            [(d.active, d.kv_tokens, d.pending, d.pending_tokens,
              d.n_scheduled) for d in mc.decodes],
            sorted((k, v.busy_until, v.n_transfers)
                   for k, v in mc.messenger.links.items()),
            sorted((k, v.busy_until, v.n_transfers)
                   for k, v in mc.messenger.ssd_links.items()),
            (c.n_migrations, c.migrated_bytes, c.n_ssd_loads,
             c.ssd_loaded_bytes, c.n_peer_ssd_loads, c.peer_ssd_bytes,
             c.accounting),
            [dataclasses.astuple(f) for f in mc.admission.in_flight])


def _assert_equal(res, jres, mc, jmc):
    a, b = _result(res), _result(jres)
    assert a[0] == b[0], "records differ"
    assert a[1:6] == b[1:6], "duration, load samples or counters differ"
    assert all(_same(x, y) for x, y in zip(a[6], b[6])), (a[6], b[6])
    assert _cluster_state(mc) == _cluster_state(jmc)


# ---------------------------------------------------------------------------
# MooncakeCluster: every strategy × every admission policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adm", ADMISSION_POLICIES)
@pytest.mark.parametrize("strategy", PREFILL_POLICIES)
def test_mooncake_cluster_equals_reference(strategy, adm, traces):
    """Three scenarios per pair: the legacy-kwargs 4P+4D flat cluster at
    real time; a 2P+2D tiered global pool at 16x; the reference's
    overload trace at 6x on 2P+2D (decode-side rejections)."""
    assert P.list_policies("prefill") == J.list_policies("prefill")
    assert P.list_policies("admission") == J.list_policies("admission")
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    tr, jtr = traces["main"]
    mc = P.MooncakeCluster(cfg, n_prefill=4, n_decode=4, strategy=strategy,
                           admission=adm, inst_spec=V5E_INST)
    jmc = J.MooncakeCluster(jcfg, n_prefill=4, n_decode=4,
                            strategy=strategy, admission=adm)
    _assert_equal(mc.run(tr), jmc.run(jtr), mc, jmc)

    spec = dict(n_prefill=2, n_decode=2, strategy=strategy, admission=adm,
                t_d=20.0, seed=3)
    cache = dict(dram_blocks=300, ssd_blocks=3000)
    mc = P.MooncakeCluster.from_spec(cfg, P.ClusterSpec(
        cache=P.CacheTierSpec(**cache), inst_spec=V5E_INST, **spec))
    jmc = J.MooncakeCluster.from_spec(jcfg, J.ClusterSpec(
        cache=J.CacheTierSpec(**cache), **spec))
    assert mc.directory is not None and jmc.directory is not None
    _assert_equal(mc.run(tr, speedup=16.0, load_sample_dt=5.0),
                  jmc.run(jtr, speedup=16.0, load_sample_dt=5.0), mc, jmc)

    otr, jotr = traces["overload"]
    mc = P.MooncakeCluster.from_spec(cfg, P.ClusterSpec(
        inst_spec=V5E_INST, **spec))
    jmc = J.MooncakeCluster.from_spec(jcfg, J.ClusterSpec(**spec))
    res, jres = mc.run(otr, speedup=6.0), jmc.run(jotr, speedup=6.0)
    _assert_equal(res, jres, mc, jmc)
    assert res.rejected(), "the overload scenario must reject"


def test_tiered_global_pool_scenario_equals_reference():
    """``tests/test_global_pool.py``'s two-node doc-revisit scenario,
    with and without the global directory."""
    kw = dict(n_requests=300, duration_ms=240_000, seed=7, frac_chat=0.25,
              frac_doc=0.55, frac_oneshot=0.20, doc_len_mu=9.6,
              doc_len_sigma=0.6)
    tr, jtr = P.generate_trace(P.TraceSpec(**kw)), \
        J.generate_trace(J.TraceSpec(**kw))
    uniq = len({h for r in tr for h in r.hash_ids})
    dram = max(int(uniq * 0.02), 64)
    spec = P.ClusterSpec(n_prefill=2, n_decode=2, tbt_slo=0.2,
                         cache=P.CacheTierSpec(dram_blocks=dram,
                                               ssd_blocks=8 * dram),
                         inst_spec=V5E_INST)
    jspec = J.ClusterSpec(n_prefill=2, n_decode=2, tbt_slo=0.2,
                          cache=J.CacheTierSpec(dram_blocks=dram,
                                                ssd_blocks=8 * dram))
    peer = {}
    for gp in (False, True):
        mc = P.MooncakeCluster.from_spec(get_config(ARCH),
                                         spec.replace(global_pool=gp))
        jmc = J.MooncakeCluster.from_spec(jax_config(ARCH),
                                          jspec.replace(global_pool=gp))
        res = mc.run(tr)
        _assert_equal(res, jmc.run(jtr), mc, jmc)
        peer[gp] = res.n_peer_ssd_loads
    assert peer[True] > 0 and peer[False] == 0


@pytest.mark.parametrize("relief", [0.5, 0.0])
def test_priority_relief_equals_reference(relief):
    """``tests/test_priority.py``'s overloaded 2P+2D replay at 6x with
    every 4th request high-priority."""
    kw = dict(n_requests=1200, duration_ms=200_000, seed=5, out_mu=5.9)
    tr, jtr = P.generate_trace(P.TraceSpec(**kw)), \
        J.generate_trace(J.TraceSpec(**kw))
    for reqs in (tr, jtr):
        for r in reqs:
            r.priority = 2 if r.req_id % 4 == 0 else 0
    mc = P.MooncakeCluster(get_config(ARCH), n_prefill=2, n_decode=2,
                           ttft_slo=30, tbt_slo=0.1, admission="early",
                           inst_spec=V5E_INST)
    jmc = J.MooncakeCluster(jax_config(ARCH), n_prefill=2, n_decode=2,
                            ttft_slo=30, tbt_slo=0.1, admission="early")
    mc.admission.priority_relief = relief
    jmc.admission.priority_relief = relief
    res = mc.run(tr, speedup=6.0)
    _assert_equal(res, jmc.run(jtr, speedup=6.0), mc, jmc)
    assert any(r.reject_stage == "admission" for r in res.records)


@pytest.mark.parametrize("kw", [dict(n_instances=4),
                                dict(n_instances=1),
                                dict(n_instances=2, cache_policy="lfu",
                                     cache_capacity_blocks=300,
                                     admit_load=3, max_batch=8)],
                         ids=["vllm-x4", "x1-vram-bound", "x2-lfu-admit3"])
def test_coupled_cluster_equals_reference(kw):
    """The Figure-12 scenario: ``simulated_requests`` on the coupled
    baseline (``decode_capacity_tokens(kv_frac=0.5)``), and Mooncake
    2P+2D on the same requests."""
    args = (150, 32768, 512)
    sim = dict(cache_ratio=0.5, rps=2.0)
    reqs = P.simulated_requests(*args, **sim)
    jreqs = J.simulated_requests(*args, **sim)
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    vl = P.CoupledCluster(cfg, inst_spec=V5E_INST, **kw)
    jvl = J.CoupledCluster(jcfg, **kw)
    a, b = _result(vl.run(reqs)), _result(jvl.run(jreqs))
    assert a[:6] == b[:6]
    assert all(_same(x, y) for x, y in zip(a[6], b[6]))
    assert [(i.kv_tokens, i.queued_prefill_s, sorted(i.pool.blocks))
            for i in vl.insts] == \
        [(i.kv_tokens, i.queued_prefill_s, sorted(i.pool.blocks))
         for i in jvl.insts]
    mc = P.MooncakeCluster(cfg, n_prefill=2, n_decode=2, inst_spec=V5E_INST)
    jmc = J.MooncakeCluster(jcfg, n_prefill=2, n_decode=2)
    _assert_equal(mc.run(reqs), jmc.run(jreqs), mc, jmc)


# ---------------------------------------------------------------------------
# trace helpers and Table 1
# ---------------------------------------------------------------------------

def test_trace_stats_equal(traces):
    for tr, jtr in traces.values():
        assert P.trace_stats(tr) == J.trace_stats(jtr)


def test_save_trace_bytes_and_round_trip_both_ways(tmp_path, traces):
    tr, jtr = traces["main"]
    p, jp = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    P.save_trace(tr, str(p))
    J.save_trace(jtr, str(jp))
    assert p.read_bytes() == jp.read_bytes()
    assert [r.to_json() for r in tr] == [r.to_json() for r in jtr]
    for path in (p, jp):
        a, b = P.load_trace(str(path)), J.load_trace(str(path))
        assert [dataclasses.astuple(r) for r in a] == \
            [dataclasses.astuple(r) for r in b]
        assert [r.to_json() for r in a] == [r.to_json() for r in tr]


@pytest.mark.parametrize("args", [
    (150, 32768, 512, 0.5, 2.0, 0), (40, 4000, 64, 0.0, 1.0, 3),
    (60, 9000, 128, 0.9, 0.5, 11), (5, 512, 1, 1.0, 1e-12, 2)])
def test_simulated_requests_equal(args):
    n, il, ol, ratio, rps, seed = args
    a = P.simulated_requests(n, il, ol, cache_ratio=ratio, rps=rps,
                             seed=seed)
    b = J.simulated_requests(n, il, ol, cache_ratio=ratio, rps=rps,
                             seed=seed)
    assert [dataclasses.astuple(r) for r in a] == \
        [dataclasses.astuple(r) for r in b]


@pytest.mark.parametrize("policy", ["lru", "lfu", "length_aware"])
def test_cache_hit_analysis_equal(policy, traces):
    tr, jtr = traces["main"]
    for cap in (None, 10_000, 1_000, 64, 1):
        assert P.cache_hit_analysis(tr, policy, cap) == \
            J.cache_hit_analysis(jtr, policy, cap)


# ---------------------------------------------------------------------------
# ClusterSpec, list_configs, make_admission, the public API
# ---------------------------------------------------------------------------

def test_cluster_spec_fields_and_defaults():
    pf = dataclasses.fields(P.ClusterSpec)
    jf = dataclasses.fields(J.ClusterSpec)
    assert [f.name for f in pf] == [f.name for f in jf]
    for f, g in zip(pf, jf):
        if f.name == "cache":
            assert dataclasses.asdict(f.default) == \
                dataclasses.asdict(g.default)
        else:
            assert f.default == g.default, f.name
    assert P.ClusterSpec().inst_spec is None
    assert P.ClusterSpec.__dataclass_params__.frozen
    s = P.ClusterSpec(strategy="kvcache")
    assert s.replace(strategy="load_aware").strategy == "load_aware"
    assert s.strategy == "kvcache"
    # the port's None is an H100 node; the reference's is its own default
    mc = P.MooncakeCluster.from_spec(get_config(ARCH), P.ClusterSpec())
    assert mc.prefills[0].cost.inst == InstanceSpec()
    assert mc.prefills[0].cost.inst.hw == H100
    assert mc.prefills[0].cost.inst.n_chips == 8


def test_list_configs_is_a_sorted_subset():
    names = list_configs()
    assert names == sorted(names)
    assert set(names) <= set(jax_list_configs())
    assert {"smollm-360m", "llama2-70b", "mamba2-2.7b"} <= set(names)


def _conductor(pkg, cfg, inst):
    cost = lambda: pkg.CostModel(cfg, inst)
    pre = [pkg.PrefillInstance(iid=i, pool=pkg.CachePool(), cost=cost())
           for i in range(2)]
    dec = [pkg.DecodeInstance(iid=100 + i, cost=cost()) for i in range(2)]
    msg = pkg.Messenger([0, 1, 100, 101], bw=100e9)
    return pkg.Conductor(pre, dec, msg, ttft_slo=30.0, tbt_slo=0.1)


def test_make_admission_errors_equal():
    c = _conductor(P, get_config(ARCH), V5E_INST)
    jc = _conductor(J, jax_config(ARCH), J.InstanceSpec())
    with pytest.raises(ValueError) as e:
        P.make_admission("nope", c)
    with pytest.raises(ValueError) as je:
        J.make_admission("nope", jc)
    assert str(e.value) == str(je.value)
    assert "early" in str(e.value) and "predictive" in str(e.value)
    for name in ("baseline", "early"):
        with pytest.raises(TypeError):
            P.make_admission(name, c, t_d=5.0)
        with pytest.raises(TypeError):
            J.make_admission(name, jc, t_d=5.0)
    pol = P.make_admission("predictive", c, t_d=5.0, priority_relief=0.1)
    jpol = J.make_admission("predictive", jc, t_d=5.0, priority_relief=0.1)
    assert (pol.t_d, pol.priority_relief, c.accounting) == \
        (jpol.t_d, jpol.priority_relief, jc.accounting)
    for name in ADMISSION_POLICIES:
        pol, jpol = P.make_admission(name, c), J.make_admission(name, jc)
        assert (type(pol).__name__, pol.accounting, pol.decode_double_check,
                c.accounting) == (type(jpol).__name__, jpol.accounting,
                                  jpol.decode_double_check, jc.accounting)


def test_predictive_load_prediction_equals_reference(traces):
    """Mid-run, the predictive policy's load estimates and admit calls
    at arbitrary horizons equal the reference's."""
    tr, jtr = traces["overload"]
    kw = dict(n_prefill=2, n_decode=2, admission="predictive", t_d=20.0)
    mc = P.MooncakeCluster(get_config(ARCH), inst_spec=V5E_INST, **kw)
    jmc = J.MooncakeCluster(jax_config(ARCH), **kw)
    mc.run(tr[:300], speedup=6.0)
    jmc.run(jtr[:300], speedup=6.0)
    now = tr[299].timestamp / 6000.0
    for dt in (0.0, 0.5, 3.0, 40.0):
        for h in (0.0, 1.0, 7.5, 30.0):
            assert mc.admission.predicted_decode_load(now + dt, h) == \
                jmc.admission.predicted_decode_load(now + dt, h)
        assert (mc.admission.prefill_load(now + dt),
                mc.admission.decode_load(now + dt)) == \
            (jmc.admission.prefill_load(now + dt),
             jmc.admission.decode_load(now + dt))
        for r, jr in zip(tr[300:340], jtr[300:340]):
            assert mc.admission.admit(r, now + dt) == \
                jmc.admission.admit(jr, now + dt)


def test_core_exports_match_reference():
    import repro.core.overload as JO
    import repro_torch.core.overload as PO

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(mod))}
    assert public(P) - {"H100"} == public(J) - {"V5E"}
    assert "H100" in public(P)
    assert public(PO) == public(JO)
