"""Sharded paged decode of the port on CPU meshes: the (data, model) mesh
must be a pure physical re-layout — page banks data-parallel over the
decode slots, KV-head stripes model-parallel — with every host-side
logical operation (alloc, refcount, COW, export) and every decoded token
bit-identical to the unmeshed pool. The port's own proofs of the
reference's ``tests/test_sharded_paged.py`` properties, plus parity with
the reference: the mesh argument and the shard rules' strings, the
unmeshed streams under the greedy rule (equal wherever the reference's
top-1/top-2 gap exceeds 4e-2), and on (2, 2) the reference's bank
decisions from a 4-device run.

A CPU mesh puts the CPU at every position (``make_decode_mesh(...,
device="cpu")``), the counterpart of the reference's forced host
devices; every position still holds its own slabs."""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from conftest import run_subprocess
from repro.configs.base import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.launch.mesh import parse_mesh_arg as jax_parse_mesh_arg
from repro.serving.engine import DecodeWorker as JDecodeWorker
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
from repro.serving.paged_cache import DevicePagePool as JDevicePagePool
from repro.serving.request import ServingRequest as JServingRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config, list_configs
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_sharded)
from repro_torch.launch import serve as port_serve
from repro_torch.launch.mesh import (Mesh, make_decode_mesh, make_stage_mesh,
                                     parse_mesh_arg, replicate_params)
from repro_torch.launch.serve import serve
from repro_torch.launch.serve_cluster import main as cluster_main
from repro_torch.launch.serve_cluster import serve_cluster
from repro_torch.models.transformer import (decode_step_paged,
                                            decode_step_paged_sharded,
                                            paged_shard_reason)
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillResult, PrefillWorker,
                                        stage_run)
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

GAP = 4e-2
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]


def _grouped(cfg):
    """smollm-360m.reduced() pads 4 query heads to 16 over 2 KV heads;
    16 over 4 is grouped GQA, which stripes over a model axis — the
    reference's own test layout."""
    return dataclasses.replace(cfg, n_heads=16, n_kv_heads=4)


@pytest.fixture(scope="module")
def weights():
    jcfg = _grouped(jax_config("smollm-360m").reduced())
    cfg = _grouped(get_config("smollm-360m").reduced())
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _mesh(dm):
    return None if dm is None else make_decode_mesh(*dm, device="cpu")


# ---------------------------------------------------------------------------
# the mesh argument, the shard rules, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["2x2", "4x1", "1x2", "2X4", "16x16", "2",
                                  "0x2", "2x0", "x", "axb", "2x2x2", "-1x2",
                                  ""])
def test_parse_mesh_arg_matches_reference(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(parse_mesh_arg) == outcome(jax_parse_mesh_arg)


@pytest.mark.parametrize("name", list_configs())
def test_paged_shard_reason_matches_reference(name):
    for cfg, jcfg in ((get_config(name), jax_config(name)),
                      (get_config(name).reduced(),
                       jax_config(name).reduced())):
        for m in (1, 2, 4, 8):
            for d in (1, 2):
                assert paged_shard_reason(cfg, m, d) == \
                    JT.paged_shard_reason(jcfg, m, d), (cfg.name, m, d)


def test_decode_worker_mesh_refusals(weights):
    _, cfg, _, tp = weights
    mesh = _mesh((1, 1))
    plain = DevicePagePool(cfg, n_pages=32, device="cpu")
    with pytest.raises(ValueError, match="disagrees with page_pool.mesh"):
        DecodeWorker(tp, cfg, max_batch=2, max_len=256, page_pool=plain,
                     mesh=mesh)
    meshed = DevicePagePool(cfg, n_pages=32, mesh=mesh)
    with pytest.raises(ValueError, match="width_buckets"):
        DecodeWorker(tp, cfg, max_batch=2, max_len=256, page_pool=meshed,
                     mesh=mesh, width_buckets=2)
    with pytest.raises(ValueError, match="must divide over the mesh"):
        DecodeWorker(tp, cfg, max_batch=3, max_len=256, mesh=_mesh((2, 1)))
    padded = get_config("smollm-360m").reduced()        # 4 → 16 over 2
    with pytest.raises(ValueError, match="model-parallel KV heads need"):
        DecodeWorker(tp, padded, max_batch=2, max_len=256,
                     mesh=_mesh((1, 2)))
    with pytest.raises(ValueError, match="do not stripe"):
        DevicePagePool(padded, n_pages=8, mesh=make_decode_mesh(
            1, 4, device="cpu"))


def test_make_mesh_refuses_missing_gpus():
    """The default device is the GPU: a host with fewer GPUs than mesh
    positions is refused, never stacked onto one device."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this host has four GPUs")
    with pytest.raises(RuntimeError, match=r"mesh 2x2 needs 4 devices but "
                                           r"torch sees \d+ GPUs"):
        make_decode_mesh(2, 2)
    with pytest.raises(RuntimeError, match="4 stages needs 4 devices"):
        make_stage_mesh(4)
    m = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    assert m.shape == {"data": 2, "model": 2}
    assert m.distinct_devices() == [torch.device("cpu")]
    assert make_decode_mesh(2, 1, device="cpu").shape == {"data": 2,
                                                          "model": 1}


# ---------------------------------------------------------------------------
# the op and the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dm", MESHES)
def test_sharded_op_equals_unsharded_bitwise(dm):
    rng = np.random.default_rng(3)
    B, H, KV, D, P, page = 4, 8, 4, 16, 9, 8
    q = torch.from_numpy(rng.standard_normal((B, H, D))).bfloat16()
    kp = torch.from_numpy(rng.standard_normal((P, page, KV, D))).bfloat16()
    vp = torch.from_numpy(rng.standard_normal((P, page, KV, D))).bfloat16()
    tbl = torch.from_numpy(rng.integers(1, P, (B, 4))).int()
    lens = torch.tensor([30, 17, 8, 25], dtype=torch.int32)
    ref = paged_decode_attention(q, kp, vp, tbl, lens)
    got = paged_decode_attention_sharded(q, kp, vp, tbl, lens,
                                         mesh=_mesh(dm))
    assert torch.equal(got, ref)


def test_sharded_step_equals_unsharded_step(weights):
    """One ``decode_step_paged_sharded`` call on (2, 2) over bank-local
    tables equals ``decode_step_paged`` over the same KV in one bank:
    logits bitwise, and the new token's KV written into every stripe."""
    _, cfg, _, tp = weights
    mesh = _mesh((2, 2))
    rng = np.random.default_rng(5)
    L, KV, Dh, pt, n = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 16, 12
    k = torch.from_numpy(rng.standard_normal((L, n, pt, KV, Dh))).bfloat16()
    v = torch.from_numpy(rng.standard_normal((L, n, pt, KV, Dh))).bfloat16()
    tbl = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 7, 8], [9, 10, 11]],
                       dtype=torch.int32)
    lens = torch.tensor([40, 20, 33, 47], dtype=torch.int32)
    toks = torch.tensor([[5], [7], [11], [13]])
    kf, vf = k.clone(), v.clone()
    ref, _, _ = decode_step_paged(tp, toks, kf, vf, tbl, lens, cfg)
    # bank b holds rows [2b, 2b+2)'s pages at the same local ids
    half = KV // 2
    ks = [[k[:, :, :, :half].clone(), k[:, :, :, half:].clone()]
          for _ in range(2)]
    vs = [[v[:, :, :, :half].clone(), v[:, :, :, half:].clone()]
          for _ in range(2)]
    got, ks, vs = decode_step_paged_sharded(
        replicate_params(tp, mesh), toks, ks, vs, tbl, lens, cfg, mesh)
    assert torch.equal(got, ref)
    for b in range(2):
        for p in tbl[2 * b:2 * b + 2].flatten().tolist():
            assert torch.equal(torch.cat(ks[b], dim=3)[:, p], kf[:, p])
            assert torch.equal(torch.cat(vs[b], dim=3)[:, p], vf[:, p])


# ---------------------------------------------------------------------------
# the banked pool
# ---------------------------------------------------------------------------

def test_banked_pool_host_invariants(weights):
    """Per-bank free lists and null pages, per-bank registry and
    adoption, same-bank COW, per-bank OOM, cross-bank export/import and
    mesh-wide logical pressure (mirrors the reference's test)."""
    _, cfg, _, _ = weights
    pp = DevicePagePool(cfg, n_pages=16, page_tokens=64,
                        mesh=_mesh((2, 2)))
    assert pp.n_banks == 2 and pp.bank_pages == 16 and pp.n_pages == 32
    assert pp.bank_of(1) == 0 and pp.bank_of(17) == 1
    assert sorted(pp._bank_free[1]) == list(range(17, 32))
    assert pp.free is pp._bank_free[0] and pp.runs is pp._bank_runs[0]
    # one slab pair per position, separate tensors, KV/m heads each
    slabs = [t for row in pp.slabs for kv in row for t in kv]
    assert len({t.data_ptr() for t in slabs}) == 8
    assert slabs[0].shape == (cfg.n_layers, 16, 64, cfg.n_kv_heads // 2,
                              cfg.head_dim)
    press = pp.pressure()
    assert press["capacity"] == 30 and press["free"] == 30

    a0 = pp.alloc(3, bank=0)
    blk = pp.alloc(8, bank=1)               # one full 512-token block run
    assert all(pp.bank_of(p) == 0 for p in a0)
    assert all(pp.bank_of(p) == 1 for p in blk)
    assert pp.free_pages == 19 and pp.pressure()["pinned"] == 11
    with pytest.raises(MemoryError, match="in bank 0"):
        pp.alloc(13, bank=0)                # bank 0 has 12 free, bank 1 7
    assert pp.free_pages == 19              # a failed alloc holds nothing

    L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator().manual_seed(0)
    k = torch.randn((L, 512, KV, Dh), generator=g).bfloat16()
    v = torch.randn((L, 512, KV, Dh), generator=g).bfloat16()
    pp.write_run(blk, k, v)
    pp.register_block(77, blk)              # the registry holds a reference
    assert pp.lookup_chain([77], bank=1) == 1
    assert pp.lookup_chain([77], bank=0) == 0
    assert pp.best_stage_bank([77]) == 1
    n, got = pp.adopt_chain([77], bank=1)
    assert n == 1 and got == blk
    pp.release(got)
    assert pp.adopt_chain([77], bank=0) == (0, [])
    with pytest.raises(AssertionError, match="straddles banks"):
        pp.register_block(78, a0[:2] + blk[:6])

    pp.retain(blk[0:1])                     # COW stays inside the bank
    moved = pp.make_writable(blk[0])
    assert moved != blk[0] and pp.bank_of(moved) == 1
    rk, _ = pp.read_seq([moved], 64)
    assert torch.equal(rk, k[:, :64])
    pp.release([moved])

    ek, ev = pp.export_run(blk, 512)        # head order across the stripes
    assert torch.equal(ek, k) and torch.equal(ev, v)
    back = pp.import_run(ek, ev, 512, bank=0)
    assert all(pp.bank_of(p) == 0 for p in back)
    rk, rv = pp.read_seq(back, 512)
    assert torch.equal(rk, k) and torch.equal(rv, v)
    mixed = back[:2] + [blk[2]]             # a run over both banks reads too
    pp.retain([blk[2]])
    rk, _ = pp.read_seq(mixed, 150)
    assert torch.equal(rk, torch.cat([k[:, :128], k[:, 128:150]], dim=1))
    pp.release([blk[2]])
    pp.release(back)
    pp.release(a0)
    pp.unregister(77, bank=None)
    pp.check_leaks()

    pp._bank_free[0].append(pp._bank_free[1].pop())
    with pytest.raises(AssertionError, match="foreign pages"):
        pp.check_leaks()
    pp._bank_free[1].append(pp._bank_free[0].pop())
    pp.check_leaks()


def test_unmeshed_pool_is_the_single_bank_pool(weights):
    _, cfg, _, _ = weights
    pp = DevicePagePool(cfg, n_pages=16, device="cpu")
    assert pp.n_banks == 1 and pp.n_model == 1 and pp.n_pages == 16
    assert pp.k_pages is pp.slabs[0][0][0]
    assert pp.best_stage_bank([1, 2]) == 0


# ---------------------------------------------------------------------------
# the engine on meshes
# ---------------------------------------------------------------------------

def _prompts(cfg):
    rng = np.random.default_rng(7)
    common = rng.integers(0, cfg.vocab_size, 512)      # one shared block
    return [np.concatenate([common,
                            rng.integers(0, cfg.vocab_size, 88 + 37 * r)])
            for r in range(3)]


# the n-best fan-out first (shares the partial tail -> COW) while its
# bank still has two free slots, then the others
JOIN_ORDER = [(2, 2), (3, 2), (0, 0), (1, 1)]


def _engine_run(cfg, tp, dm, max_new=6):
    """Prefill -> bank-aware joins -> decode. Returns (streams, decode
    counters, per-join decisions)."""
    mesh = _mesh(dm)
    pp = DevicePagePool(cfg, n_pages=64, mesh=mesh, page_tokens=64,
                        device="cpu")
    pool = HostKVPool()
    pw = PrefillWorker(tp, cfg, pool, prefill_chunk=256, page_pool=pp)
    dw = DecodeWorker(tp, cfg, max_batch=4, max_len=1024, page_pool=pp)
    press = [pw(t) for t in _prompts(cfg)]
    outs, joins = {}, []
    for rid, i in JOIN_ORDER:
        slot = dw.join(ServingRequest(req_id=rid, tokens=None,
                                      max_new=max_new), press[i])
        n = int(dw.n_pages_slot[slot])
        joins.append(dict(
            slot=slot, banks=sorted({pp.bank_of(int(p))
                                     for p in dw.block_table[slot, :n]}),
            free=[len(f) for f in pp._bank_free]))
        outs[rid] = [press[i].first_token]
    while dw.n_active:
        for rid, tok, _ in dw.step():
            outs[rid].append(tok)
    assert pp.stats()["cow_copies"] >= 1, pp.stats()
    pp.check_leaks()
    pool.close()
    st = dw.stats()
    return outs, st, joins + [dict(free=[len(f) for f in pp._bank_free])]


@pytest.fixture(scope="module")
def unmeshed(weights):
    _, cfg, _, tp = weights
    return _engine_run(cfg, tp, None)


@pytest.mark.parametrize("dm", MESHES)
def test_mesh_streams_equal_unmeshed(weights, unmeshed, dm):
    """The port's proof of ``test_mesh_shard_invariance_bit_exact``:
    every stream on every mesh is the unmeshed run's, bit for bit."""
    _, cfg, _, tp = weights
    base, _, _ = unmeshed
    assert base[3] == base[2]
    got, st, _ = _engine_run(cfg, tp, dm)
    assert got == base
    assert st["zero_copy_joins"] + st["staged_joins"] == 4


def test_unmeshed_streams_match_reference(weights, unmeshed,
                                          record_property):
    """The same joins through the reference's unmeshed engine: streams
    equal wherever the reference's top-1/top-2 gap exceeds 4e-2."""
    jcfg, cfg, jp, _ = weights
    port, _, _ = unmeshed
    pp = JDevicePagePool(jcfg, n_pages=64, page_tokens=64)
    pw = JPrefillWorker(jp, jcfg, JHostKVPool(), prefill_chunk=256,
                        page_pool=pp)
    dw = JDecodeWorker(jp, jcfg, max_batch=4, max_len=1024, page_pool=pp)
    prompts = _prompts(cfg)
    press = [pw(t) for t in prompts]
    ref = {}
    for rid, i in JOIN_ORDER:
        dw.join(JServingRequest(req_id=rid, tokens=None, max_new=6),
                press[i])
        ref[rid] = [press[i].first_token]
    while dw.n_active:
        for rid, tok, _ in dw.step():
            ref[rid].append(tok)
    ties = 0
    for rid, i in JOIN_ORDER:
        r, p = ref[rid], port[rid]
        j = next((j for j in range(len(r)) if r[j] != p[j]), None)
        if j is None:
            continue
        ctx = np.concatenate([prompts[i], np.asarray(r[:j], np.int32)])
        logits, _ = JT.prefill(jp, jnp.asarray(ctx[None]), jcfg)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] <= GAP, (rid, j, top2)
        ties += 1
    record_property("near_ties_skipped", ties)


_REF_DECISIONS = """
import dataclasses, json
import jax
import numpy as np
from repro.configs.base import get_config
from repro.launch.mesh import make_decode_mesh
from repro.models.transformer import init_params
from repro.serving.engine import DecodeWorker, HostKVPool, PrefillWorker
from repro.serving.paged_cache import DevicePagePool
from repro.serving.request import ServingRequest
assert jax.device_count() == 4, jax.devices()
cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                          n_heads=16, n_kv_heads=4)
params = init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(7)
common = rng.integers(0, cfg.vocab_size, 512)
prompts = [np.concatenate([common, rng.integers(0, cfg.vocab_size,
                                                88 + 37 * r)])
           for r in range(3)]
pp = DevicePagePool(cfg, n_pages=64, mesh=make_decode_mesh(2, 2),
                    page_tokens=64)
pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=256,
                   page_pool=pp)
dw = DecodeWorker(params, cfg, max_batch=4, max_len=1024, page_pool=pp)
press = [pw(t) for t in prompts]
joins = []
for rid, i in %s:
    slot = dw.join(ServingRequest(req_id=rid, tokens=None, max_new=6),
                   press[i])
    n = int(dw.n_pages_slot[slot])
    joins.append(dict(slot=slot, banks=sorted(
        {pp.bank_of(int(p)) for p in dw.block_table[slot, :n]}),
        free=[len(f) for f in pp._bank_free]))
while dw.n_active:
    dw.step()
pp.check_leaks()
st = dw.stats()
print("DECISIONS " + json.dumps(dict(
    joins=joins + [dict(free=[len(f) for f in pp._bank_free])],
    zero_copy_joins=st["zero_copy_joins"], staged_joins=st["staged_joins"],
    cow_copies=pp.stats()["cow_copies"])))
""" % (JOIN_ORDER,)


def test_bank_decisions_match_reference_2x2(weights):
    """The reference on 4 forced host devices and the port on a (2, 2)
    CPU mesh make the same host-side decisions: each request's slot and
    page bank, zero-copy against staged joins, COW copies, and every
    bank's free pages after each join and at the end."""
    _, cfg, _, tp = weights
    out = run_subprocess(_REF_DECISIONS, devices=4)
    line = next(s for s in out.splitlines() if s.startswith("DECISIONS "))
    ref = json.loads(line[len("DECISIONS "):])
    _, st, joins = _engine_run(cfg, tp, (2, 2))
    assert joins == ref["joins"]
    assert st["zero_copy_joins"] == ref["zero_copy_joins"] == 2
    assert st["staged_joins"] == ref["staged_joins"] == 2


@pytest.mark.parametrize("arm", ["reload", "recompute"])
def test_mesh_preempt_restore_bitwise(weights, arm):
    """Preemption on (2, 2): the victim's export leaves the banked pool,
    and the restore arm resumes the stream bitwise against the unmeshed
    never-preempted run (mirrors ``test_mesh_preempt_restore_bit_exact``)."""
    _, cfg, _, tp = weights
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, 600)
    max_new = 8

    def mk(dm):
        pp = DevicePagePool(cfg, n_pages=64, mesh=_mesh(dm), page_tokens=64,
                            device="cpu")
        pw = PrefillWorker(tp, cfg, HostKVPool(), prefill_chunk=256,
                           page_pool=pp)
        dw = DecodeWorker(tp, cfg, max_batch=2, max_len=1024, page_pool=pp)
        return pp, pw, dw

    pp, pw, dw = mk(None)
    res = pw(toks)
    dw.join(ServingRequest(req_id=0, tokens=toks, max_new=max_new), res)
    oracle = [res.first_token]
    while dw.n_active:
        oracle += [tok for _, tok, _ in dw.step()]
    pp.check_leaks()

    pp, pw, dw = mk((2, 2))
    res = pw(toks)
    slot = dw.join(ServingRequest(req_id=0, tokens=toks, max_new=max_new),
                   res)
    emitted = [res.first_token]
    for _ in range(3):
        emitted += [tok for _, tok, _ in dw.step()]
    run = dw.preempt(slot)
    assert dw.n_active == 0
    assert run.n_tokens == len(toks) + len(run.emitted) - 1
    prefix = np.concatenate([toks, np.asarray(run.emitted[:-1], toks.dtype)])
    if arm == "reload":
        ids = pw.hasher.hash_ids(prefix)
        pages = stage_run(pp, ids, run.k, run.v, run.n_tokens)
        assert pages is not None
        assert len({pp.bank_of(p) for p in pages if p}) == 1
        pres = PrefillResult(
            first_token=run.emitted[-1], kv_k=run.k, kv_v=run.v,
            prompt_len=run.n_tokens, reused_blocks=0, new_blocks=0,
            hash_ids=ids, pages=pages, page_pool=pp,
            page_gens=pp.gens_of(pages))
    else:
        pres = pw(prefix)
    dw.join(run.request, pres, resume_emitted=run.emitted)
    while dw.n_active:
        emitted += [tok for _, tok, _ in dw.step()]
    assert emitted == oracle
    pp.check_leaks()


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_on_a_cpu_2x1_mesh():
    """``serve(..., mesh=)`` serves the launcher's workload 8 of 8 on a
    2x1 CPU mesh (the padded reduced arch: data-only sharding needs no
    grouped GQA), every stream the unmeshed run's."""
    cfg = get_config("smollm-360m").reduced()
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logs = []
    s = serve(cfg, "cpu", params=params, requests=12, max_batch=4,
              mesh=_mesh((2, 1)), log=logs.append)
    assert s["submitted"] == 8 and s["completed"] == 8
    assert s["paged_calls"] == s["decode_steps"] > 0
    assert any(m.startswith("mesh 2x1: 2 page banks × 97 pages (capacity "
                            "192 logical pages), 2 slots per data shard")
               for m in logs), logs
    base = serve(cfg, "cpu", params=params, requests=12, max_batch=4,
                 log=lambda m: None)
    assert s["outputs"] == base["outputs"]
    with pytest.raises(ValueError, match="max_batch=3 must divide"):
        serve(cfg, "cpu", params=params, max_batch=3, mesh=_mesh((2, 1)))
    with pytest.raises(ValueError, match="PAGED decode engine"):
        serve(cfg, "cpu", params=params, decode_substrate="dense",
              mesh=_mesh((2, 1)))


def test_serve_cluster_on_a_cpu_2x2_mesh(weights):
    """The cluster launcher's Conductor lane with its page pool banked
    over a (2, 2) CPU mesh serves what the unmeshed lane serves, token
    for token, leak-free."""
    _, cfg, _, tp = weights
    logs = []
    got = serve_cluster(cfg, "cpu", params=tp, requests=8,
                        mesh=_mesh((2, 2)), log=logs.append)
    base = serve_cluster(cfg, "cpu", params=tp, requests=8,
                         log=lambda m: None)
    assert "decode mesh 2x2: 2 page banks × 193 pages, KV heads / 2 model " \
        "shards" in logs
    assert got["pages_leak_free"] and got["outputs"] == base["outputs"]
    assert got["outputs"]


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x2", "--decode-substrate", "dense"],
    ["--mesh", "2x3"],
    ["--mesh", "3x1", "--max-batch", "8"],
])
def test_serve_mesh_flag_checks_match_reference(argv, capsys):
    """``--mesh``'s argument errors are the reference launcher's, word
    for word (both exit 2 before any device is touched)."""
    def run(main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        return e.value.code, capsys.readouterr()
    ref_code, ref = run(jax_serve.main)
    code, got = run(port_serve.main)
    assert code == ref_code == 2
    assert got.err.strip().splitlines()[-1] \
        == ref.err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x2", "--decode-substrate", "dense"],
    ["--mesh", "1x3"],
])
def test_cluster_mesh_flag_checks_match_reference(argv, capsys):
    """The cluster launcher's ``--mesh`` errors are the reference
    example's, word for word."""
    spec = importlib.util.spec_from_file_location(
        "ref_serve_cluster", os.path.join(os.path.dirname(__file__), "..",
                                          "examples", "serve_cluster.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["serve_cluster.py", *argv]
    try:
        with pytest.raises(SystemExit) as ref_exit:
            mod.main()
    finally:
        sys.argv = old
    ref = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as port_exit:
        cluster_main(argv)
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert ref_exit.value.code == port_exit.value.code == 2
    assert got.split(": error: ")[1] == ref.split(": error: ")[1]
