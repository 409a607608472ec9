"""The port's KVCache storage hierarchy against the reference: the tiered
metadata pool, the checksummed SSD block store (whose byte format both
packages share, checked in both directions), the async layer-wise
prefetch, the load-vs-recompute split, the global directory and the
in-process peers, and the engine paths that serve a prefix off disk or
off a peer (``smollm-360m.reduced()``, weights carried by
``bridge.params_from_jax``).

Equalities: metadata, splits and store bytes are held EXACTLY equal to
the reference's; greedy tokens of a tiered run EXACTLY equal the port's
own flat-pool run (wrong bytes would show as different tokens), and equal
the reference's under the ROADMAP parity rule (identical wherever the
reference's top-2 logit gap exceeds 4e-2). Every test closes its pools,
so the conftest thread and fd checks pass."""
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

import jax

import repro.models.transformer as JT
import repro.serving.engine as JE
from repro.configs.base import CacheTierSpec as JCacheTierSpec
from repro.configs.base import get_config as jax_config
from repro.core.cache import CachePool as JCachePool
from repro.core.cache import kv_block_bytes as jax_kv_block_bytes
from repro.core.directory import GlobalBlockDirectory as JDirectory
from repro.core.tiered import TieredCachePool as JTieredCachePool
from repro.launch.serve import main as jax_serve_main
from repro.serving.engine import DecodeWorker as JDecodeWorker
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
from repro.serving.layerwise import overlap_split as jax_overlap_split
from repro.serving.request import ServingRequest as JServingRequest
from repro.serving.ssd_store import SSDBlockStore as JSSDBlockStore
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs.base import CacheTierSpec, get_config
from repro_torch.core.cache import CachePool, kv_block_bytes, make_policy
from repro_torch.core.directory import GlobalBlockDirectory
from repro_torch.core.tiered import TieredCachePool
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models.transformer import prefill
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillWorker, connect_pools,
                                        prefix_hash_ids)
from repro_torch.serving.layerwise import overlap_split, verify_stream_order
from repro_torch.serving.request import ServingRequest
from repro_torch.serving.ssd_store import AsyncPrefetcher, SSDBlockStore
from repro_torch.serving.transport import (InProcPeer, PeerUnreachable,
                                           StaleDirectory, StorePeer,
                                           TornFrame, fallback_reason)

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

GAP = 4e-2
ARCH = "smollm-360m"
POLICIES = ["lru", "lfu", "length_aware"]
L, KV, DH = 2, 1, 4     # tiny per-layer KV geometry for store-level tests


# ---------------------------------------------------------------------------
# metadata: CachePool policies and the tiered pool, op for op
# ---------------------------------------------------------------------------

def _apply(pool, op, key, key2):
    """One metadata operation; returns what it returned."""
    chain = [key, key2, (key + 3) % 12]
    if op == 0:
        return sorted(pool.insert(chain, start_pos=key % 3))
    if op == 1:
        return pool.lookup(chain)
    if op == 2:
        return pool.touch_keys([key, key2])
    if op == 3:
        return pool.pin([key])
    if op == 4:
        return pool.unpin([key])
    if op == 5:
        return pool.discard(key)
    if op == 6:
        return pool.lookup([key], touch=False)
    return sorted(pool.insert([key], start_pos=key2))


def _flat_state(pool):
    return (sorted((k, m.position, m.hits, m.pinned)
                   for k, m in pool.blocks.items()),
            pool.hits, pool.misses, pool.evictions)


OPS = st.lists(st.tuples(st.integers(0, 7), st.integers(0, 11),
                         st.integers(0, 11)), min_size=1, max_size=60)


@settings(max_examples=80, deadline=None)
@given(st.sampled_from(POLICIES), OPS)
def test_cache_pool_matches_reference(policy, ops):
    """The flat pool under each Table 1 policy: same returns, residency,
    hit/pin counts and counters as the reference after every op."""
    ours = CachePool(5, policy, block_bytes=7)
    ref = JCachePool(5, policy, block_bytes=7)
    for op, key, key2 in ops:
        assert _apply(ours, op, key, key2) == _apply(ref, op, key, key2)
        assert _flat_state(ours) == _flat_state(ref)
        assert ours.hit_rate == ref.hit_rate


def test_make_policy_rejects_unknown_names():
    assert [make_policy(p).name for p in POLICIES] == POLICIES
    with pytest.raises(ValueError, match="registered"):
        make_policy("mru")


def _hooked(pool):
    """Record every tier event of a tiered pool, in order."""
    log = []
    pool.on_demote = lambda k: log.append(("demote", k))
    pool.on_promote = lambda k, c: log.append(("promote", k, c))
    pool.on_drop = lambda k: log.append(("drop", k))
    pool.on_insert = lambda k, t: log.append(("insert", k, t))
    return log


@settings(max_examples=80, deadline=None)
@given(st.sampled_from(POLICIES), OPS)
def test_tiered_pool_matches_reference(policy, ops):
    """The same random insert/lookup/touch/pin/discard/flush sequence
    through both packages' ``TieredCachePool``: equal returns,
    ``tier_stats()``, residency per tier and tier events after every
    step."""
    ours = TieredCachePool(3, 4, policy=policy, ssd_policy=policy,
                           writeback_batch=2)
    ref = JTieredCachePool(3, 4, policy=policy, ssd_policy=policy,
                           writeback_batch=2)
    log_o, log_r = _hooked(ours), _hooked(ref)
    for op, key, key2 in ops:
        if op == 7 and key2 % 2:
            got = (ours.flush_writeback(), ref.flush_writeback())
            assert got[0] == got[1]
        else:
            assert _apply(ours, op, key, key2) == _apply(ref, op, key, key2)
        assert ours.tier_stats() == ref.tier_stats()
        assert _flat_state(ours) == _flat_state(ref)
        assert _flat_state(ours.ssd) == _flat_state(ref.ssd)
        assert log_o == log_r
        chain = [key, key2, (key + 1) % 12]
        assert ours.tier_prefix(chain).__dict__ == \
            ref.tier_prefix(chain).__dict__


@settings(max_examples=60, deadline=None)
@given(OPS, st.tuples(st.integers(1, 4), st.integers(0, 5)))
def test_tiered_pool_invariants(ops, caps):
    """The three invariants of ``core/tiered.py``: one tier per block,
    neither tier over capacity, pinned blocks never leave the hierarchy
    (their pin counts travel with them)."""
    dram, ssd = caps
    pool = TieredCachePool(dram, ssd)
    pins: dict = {}
    for op, key, key2 in ops:
        if op == 5 and pins.get(key):
            op = 6                       # discard drops pinned blocks too
        was_resident = key in pool
        _apply(pool, op, key, key2)
        if op == 3 and was_resident:
            pins[key] = pins.get(key, 0) + 1
        elif op == 4 and pins.get(key):
            pins[key] -= 1
        assert not set(pool.blocks) & set(pool.ssd.blocks)
        assert len(pool.blocks) <= dram and len(pool.ssd.blocks) <= ssd
        for k, n in pins.items():
            if n:
                meta = pool.blocks.get(k) or pool.ssd.blocks.get(k)
                assert meta is not None and meta.pinned == n, (k, n)


def test_cache_tier_spec_builds_the_reference_pools():
    for kw in (dict(), dict(ssd_blocks=8, writeback_batch=3,
                            dram_policy="lfu", ssd_policy="length_aware"),
               dict(ssd_blocks=None)):
        ours, ref = CacheTierSpec(**kw), JCacheTierSpec(**kw)
        assert ours.tiered == ref.tiered
        pool, jpool = ours.make_pool(block_bytes=64), \
            ref.make_pool(block_bytes=64)
        assert type(pool).__name__ == type(jpool).__name__
        assert (pool.capacity, pool.policy.name, pool.block_bytes) == \
            (jpool.capacity, jpool.policy.name, jpool.block_bytes)
        if ours.tiered:
            assert isinstance(pool, TieredCachePool)
            assert (pool.ssd.capacity, pool.ssd.policy.name,
                    pool.writeback_batch) == (jpool.ssd.capacity,
                                              jpool.ssd.policy.name,
                                              jpool.writeback_batch)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b"])
def test_kv_block_bytes_matches_reference(arch):
    for ours, ref in ((get_config(arch), jax_config(arch)),
                      (get_config(arch).reduced(),
                       jax_config(arch).reduced())):
        assert kv_block_bytes(ours) == jax_kv_block_bytes(ref)
    # one full-width smollm block: 2 × 32 layers × 512 × 5 heads × 64 × 2 B
    assert kv_block_bytes(get_config("smollm-360m")) == 20_971_520


@settings(max_examples=200, deadline=None)
@given(st.lists(st.sampled_from(["dram", "ssd"]), min_size=0, max_size=10),
       st.floats(0.0, 2.0), st.floats(0.0, 2.0))
def test_overlap_split_matches_reference(tiers, tc, tl):
    ours = overlap_split(tiers, tc, tl)
    ref = jax_overlap_split(tiers, tc, tl)
    assert ours.__dict__ == ref.__dict__
    assert ours.predicted_speedup == ref.predicted_speedup
    # never predicted slower than all-load or all-recompute
    assert ours.t_overlapped <= ours.t_blocking + 1e-12


# ---------------------------------------------------------------------------
# the SSD block store
# ---------------------------------------------------------------------------

def _blk(rng, dtype=torch.bfloat16, tokens=BLOCK_TOKENS):
    return tuple(torch.from_numpy(rng.standard_normal(
        (L, tokens, KV, DH)).astype(np.float32)).to(dtype) for _ in range(2))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit patterns (bf16 compared as int16)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _same(a, b) -> bool:
    return np.array_equal(_bits(a[0]), _bits(b[0])) and \
        np.array_equal(_bits(a[1]), _bits(b[1]))


@pytest.fixture()
def store(tmp_path):
    s = SSDBlockStore(str(tmp_path / "ssd"), writeback_batch=2)
    yield s
    s.close()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_store_roundtrip_bit_exact(store, dtype):
    k, v = _blk(np.random.default_rng(0), dtype)
    store.put(1, k, v)
    store.flush()
    out = store.read_block(1)
    assert out is not None and out[0].dtype == dtype
    assert _same(out, (k, v))
    # owned and writable: mutating the result leaves the store intact
    out[0].zero_()
    assert _same(store.read_block(1), (k, v))


def test_store_read_layer_matches_block_slices(store):
    k, v = _blk(np.random.default_rng(1))
    store.put(7, k, v)
    store.flush()
    for l in range(L):
        assert _same(store.read_layer(7, l), (k[l], v[l]))
    assert store.layer_reads == L


def test_store_staging_read_your_writes_and_batching(store):
    rng = np.random.default_rng(2)
    k, v = _blk(rng)
    store.put(1, k, v)                    # staged (batch of 2 not reached)
    assert store.staged_blocks == 1 and store.n_flushes == 0
    k[:] = 0                              # the store kept its own copy
    assert 1 in store and store.keys() == []
    assert not _same(store.read_block(1), (k, v))
    store.put(2, *_blk(rng))              # batch full → one flush
    assert store.staged_blocks == 0 and store.n_flushes == 1
    assert sorted(store.keys()) == [1, 2] and store.blocks_written == 2


def test_store_refuses_a_block_of_another_geometry(store):
    """Slots are fixed-size: a block whose shape or dtype differs from
    the store's first one would tear the layout, so it is refused."""
    rng = np.random.default_rng(14)
    store.put(1, *_blk(rng))
    with pytest.raises(ValueError, match="does not match"):
        store.put(2, *_blk(rng, torch.float32))
    with pytest.raises(ValueError, match="does not match"):
        store.put(3, *_blk(rng, tokens=256))
    assert 2 not in store and 3 not in store and 1 in store


def test_store_slot_reuse(store):
    rng = np.random.default_rng(3)
    for key in (1, 2):
        store.put(key, *_blk(rng))
    size = os.path.getsize(store.path)
    store.delete(1)
    k, v = _blk(rng)
    store.put(3, k, v)
    store.put(4, *_blk(rng))
    store.flush()
    assert os.path.getsize(store.path) == size + store._slot_size
    assert _same(store.read_block(3), (k, v))
    assert store.read_block(1) is None and 1 not in store


@pytest.mark.parametrize("damage", ["truncated", "payload", "header"])
def test_store_integrity_failures_read_none(store, damage):
    rng = np.random.default_rng(4)
    good = _blk(rng)
    store.put(1, *good)
    store.put(2, *_blk(rng))              # flushed as one batch
    off = store._offsets[2]
    with open(store.path, "r+b") as f:
        if damage == "truncated":
            f.truncate(off + store._slot_size - 5)
        elif damage == "payload":
            f.seek(off + store._hdr_size + store._layer_bytes * 2 + 3)
            f.write(b"\x55\xaa")
        else:
            f.seek(off)
            f.write(b"XXXX")
    if damage == "payload":               # layer 0 is intact, layer 1 not
        assert store.read_layer(2, 0) is not None
        assert store.read_layer(2, 1) is None
    assert store.read_block(2) is None
    assert store.read_failures >= 1
    assert _same(store.read_block(1), good)


def test_store_restart_recovery(tmp_path):
    d = str(tmp_path / "ssd")
    rng = np.random.default_rng(5)
    blocks = {key: _blk(rng) for key in (11, 12, 13)}
    s = SSDBlockStore(d, writeback_batch=8)
    for key, kv in blocks.items():
        s.put(key, *kv)
    s.close()                             # close flushes the staged batch
    with open(os.path.join(d, "kvblocks.dat"), "r+b") as f:
        f.seek(s._offsets[12])
        f.write(b"MKV0")                  # a torn header: a free slot now
    s2 = SSDBlockStore(d)
    try:
        assert sorted(s2.keys()) == [11, 13]
        for key in (11, 13):
            assert _same(s2.read_block(key), blocks[key])
        k, v = _blk(rng)
        s2.put(14, k, v)
        s2.flush()                        # reuses the torn slot
        assert os.path.getsize(s2.path) == 3 * s2._slot_size
        assert _same(s2.read_block(14), (k, v))
    finally:
        s2.close()


def test_store_torn_meta_is_a_fresh_store(tmp_path):
    d = str(tmp_path / "ssd")
    s = SSDBlockStore(d)
    s.put(1, *_blk(np.random.default_rng(6)))
    s.close()
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write('{"shape": [2, 512')
    s2 = SSDBlockStore(d)
    try:
        assert s2.keys() == [] and s2.n_layers == 0
        assert s2.read_block(1) is None
    finally:
        s2.close()


def test_prefetch_layer_major_order(store):
    rng = np.random.default_rng(7)
    blocks = {key: _blk(rng) for key in (1, 2, 3)}
    for key, kv in blocks.items():
        store.put(key, *kv)
    store.flush()
    pf = AsyncPrefetcher(store)
    try:
        h = pf.fetch([1, 2, 3])
        assert h.wait(timeout=30)
        layers = [layer for _, layer, _ in h.layer_log]
        assert layers == sorted(layers) == [0, 0, 0, 1, 1, 1]
        assert [key for key, _, _ in h.layer_log[:3]] == [1, 2, 3]
        for key, kv in blocks.items():
            assert _same(h.result(key), kv)
        assert not h.failed
    finally:
        pf.close()
    assert pf._thread.name.startswith("repro-")
    assert not pf._thread.is_alive()


def test_prefetch_marks_corrupt_block_failed(store):
    rng = np.random.default_rng(8)
    blocks = {key: _blk(rng) for key in (1, 2, 3)}
    for key, kv in blocks.items():
        store.put(key, *kv)
    store.flush()
    with open(store.path, "r+b") as f:    # layer 1 of block 2
        f.seek(store._offsets[2] + store._hdr_size
               + 2 * store._layer_bytes + 1)
        f.write(b"\x01\x02\x03")
    pf = AsyncPrefetcher(store)
    try:
        h = pf.fetch([1, 2, 3])
        assert h.wait(timeout=30)
        assert h.failed == {2} and h.result(2) is None
        assert _same(h.result(1), blocks[1]) and _same(h.result(3), blocks[3])
    finally:
        pf.close()


def test_prefetcher_close_is_idempotent_and_fails_late_fetches(store):
    store.put(1, *_blk(np.random.default_rng(9)))
    pf = AsyncPrefetcher(store)
    pf.close()
    pf.close()
    assert pf.closed and not pf._thread.is_alive()
    h = pf.fetch([1])
    assert h.wait(timeout=1) and h.failed == {1}


# ---------------------------------------------------------------------------
# the byte format across packages, both ways
# ---------------------------------------------------------------------------

def _np_blk(rng, dtype):
    """A reference-side block: numpy, bf16 as the ``ml_dtypes`` arrays
    jax hands out."""
    a = [rng.standard_normal((L, BLOCK_TOKENS, KV, DH)).astype(np.float32)
         for _ in range(2)]
    return tuple(x.astype(jnp.bfloat16) if dtype == "bfloat16" else x
                 for x in a)


def _np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _meta(d):
    with open(os.path.join(d, "meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_store_recovers_in_the_port(tmp_path, dtype):
    """A store the reference wrote (and closed) recovers in the port with
    bit-equal blocks, by whole block and by layer."""
    d = str(tmp_path / "ref")
    rng = np.random.default_rng(10)
    blocks = {key: _np_blk(rng, dtype) for key in (3, 2**63 + 5, 9)}
    js = JSSDBlockStore(d, writeback_batch=2)
    for key, kv in blocks.items():
        js.put(key, *kv)
    js.close()
    assert _meta(d)["dtype"] == dtype
    s = SSDBlockStore(d)
    try:
        assert sorted(s.keys()) == sorted(blocks)
        for key, (k, v) in blocks.items():
            out = s.read_block(key)
            assert out[0].dtype == getattr(torch, dtype)
            assert np.array_equal(_bits(out[0]), _np_bits(k))
            assert np.array_equal(_bits(out[1]), _np_bits(v))
            kl, vl = s.read_layer(key, 1)
            assert np.array_equal(_bits(kl), _np_bits(k[1]))
            assert np.array_equal(_bits(vl), _np_bits(v[1]))
        assert s.read_failures == 0
    finally:
        s.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_store_reads_in_the_reference(tmp_path, dtype):
    """A store the port wrote is read by the reference's store, bit for
    bit, and its meta.json equals the one the reference writes for the
    same geometry."""
    d, dj = str(tmp_path / "port"), str(tmp_path / "ref")
    rng = np.random.default_rng(11)
    blocks = {key: _np_blk(rng, dtype) for key in (4, 2**64 - 1, 8)}
    s = SSDBlockStore(d, writeback_batch=2)
    for key, (k, v) in blocks.items():
        s.put(key, tensor_from_numpy(k, "cpu"), tensor_from_numpy(v, "cpu"))
    s.close()
    js = JSSDBlockStore(dj)
    js.put(1, *blocks[4])
    js.close()
    assert _meta(d) == _meta(dj)
    js = JSSDBlockStore(d)
    try:
        assert sorted(js.keys()) == sorted(blocks)
        for key, (k, v) in blocks.items():
            out = js.read_block(key)
            assert out[0].dtype == k.dtype
            assert np.array_equal(_np_bits(out[0]), _np_bits(k))
            assert np.array_equal(_np_bits(out[1]), _np_bits(v))
        assert js.read_failures == 0
    finally:
        js.close()


def test_throttled_store_matches_reference(tmp_path):
    """The optional bandwidth throttle: before any blocking read both
    packages estimate a block's read at ``block_bytes / read_bw``; a
    flush takes at least its bytes over ``write_bw``, a blocking read at
    least its payload over ``read_bw``, and that read becomes the
    estimate."""
    rbw, wbw = 4e6, 8e6
    rng = np.random.default_rng(13)
    blocks = {key: _np_blk(rng, "bfloat16") for key in (1, 2)}
    s = SSDBlockStore(str(tmp_path / "port"), writeback_batch=2,
                      read_bw=rbw, write_bw=wbw)
    js = JSSDBlockStore(str(tmp_path / "ref"), writeback_batch=2,
                        read_bw=rbw, write_bw=wbw)
    try:
        for key, (k, v) in blocks.items():
            js.put(key, k, v)
            s.put(key, tensor_from_numpy(k, "cpu"),
                  tensor_from_numpy(v, "cpu"))
        assert s.n_flushes == js.n_flushes == 1
        assert s.bytes_written == js.bytes_written
        assert s.flush_s >= s.bytes_written / wbw
        assert s.est_block_read_s() == js.est_block_read_s() \
            == s.block_bytes / rbw
        t0 = time.monotonic()
        out = s.read_block(1)
        assert time.monotonic() - t0 >= s.block_bytes / rbw
        assert np.array_equal(_bits(out[0]), _np_bits(blocks[1][0]))
        assert s.read_s_ema >= s.block_bytes / rbw
        assert s.est_block_read_s() == s.read_s_ema
        js.read_block(1)
        assert js.read_s_ema >= js.block_bytes / rbw
    finally:
        s.close()
        js.close()


# ---------------------------------------------------------------------------
# directory and transport
# ---------------------------------------------------------------------------

@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 7),
                          st.integers(0, 2)), min_size=0, max_size=60))
def test_directory_matches_reference(ops):
    ours, ref = GlobalBlockDirectory(), JDirectory()
    for op, key, node in ops:
        for d in (ours, ref):
            if op < 2:
                d.register(key, node, ("dram", "ssd")[op])
            elif op == 2:
                d.unregister(key, node)
            else:
                d.drop_node(node)
        assert ours.snapshot() == ref.snapshot()
        assert ours.pick_owner(key, exclude=(node,)) == \
            ref.pick_owner(key, exclude=(node,))
        chain = list(range(key, 8))
        assert ours.best_ssd_extension(chain) == ref.best_ssd_extension(chain)
    assert ours.stats() == ref.stats()
    with pytest.raises(ValueError, match="tier"):
        ours.register(1, 0, "tape")


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 9)),
                min_size=0, max_size=50))
def test_bound_pool_view_stays_consistent(ops):
    """A port ``TieredCachePool`` bound to the port directory: the
    directory's view equals the pool's residency after every op."""
    d = GlobalBlockDirectory()
    pool = TieredCachePool(3, 5)
    d.bind("n0", pool)
    for op, key in ops:
        if op == 0:
            pool.insert([key])
        elif op == 1:
            pool.lookup([key])
        elif op == 2:
            pool.discard(key)
        else:
            pool.insert([key, (key + 1) % 10])
        view = {k: h["n0"] for k, h in d.snapshot().items() if "n0" in h}
        actual = {k: "dram" for k in pool.blocks}
        actual.update({k: "ssd" for k in pool.ssd.blocks})
        assert view == actual


def test_transport_taxonomy_and_peers(tmp_path):
    assert [fallback_reason(e("x")) for e in
            (PeerUnreachable, StaleDirectory, TornFrame)] == \
        ["peer_unreachable", "stale_directory", "verify_failed"]
    s = SSDBlockStore(str(tmp_path / "ssd"), writeback_batch=1)
    k, v = _blk(np.random.default_rng(12))
    s.put(1, k, v)
    s.put(2, *_blk(np.random.default_rng(13)))
    peer = StorePeer(s)
    assert peer.n_layers == L and _same(peer.read_layer(1, 0), (k[0], v[0]))
    with pytest.raises(StaleDirectory):
        peer.read_layer(3, 0)
    with open(s.path, "r+b") as f:
        f.seek(s._offsets[2] + s._hdr_size + 1)
        f.write(b"\xff\xfe")
    with pytest.raises(TornFrame):
        peer.read_layer(2, 0)
    pool = HostKVPool(capacity_blocks=4)
    pool.put([5], k, v)
    inproc = InProcPeer(pool)
    assert inproc.n_layers == L and _same(inproc.read_layer(5, 1),
                                          (k[1], v[1]))
    with pytest.raises(StaleDirectory):
        inproc.read_layer(6, 0)
    pool.kill()
    with pytest.raises(PeerUnreachable):
        inproc.read_layer(5, 0)
    pool.close()
    s.close()


# ---------------------------------------------------------------------------
# the engine: prefixes served off disk and off a peer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def prompts(weights):
    """Two prompts sharing a two-block document (the reference's
    ``tests/test_ssd_store.py`` setup)."""
    vocab = weights[1].vocab_size
    rng = np.random.default_rng(42)
    doc = rng.integers(0, vocab, 2 * BLOCK_TOKENS)
    q1 = np.concatenate([doc, rng.integers(0, vocab, 48)])
    q2 = np.concatenate([doc, rng.integers(0, vocab, 48)])
    return q1, q2


def _decode(params, cfg, pres, tokens, n=3):
    dw = DecodeWorker(params, cfg, max_batch=1,
                      max_len=pres.prompt_len + n + 4)
    dw.join(ServingRequest(req_id=0, tokens=tokens, max_new=n), pres)
    out = [pres.first_token]
    while dw.n_active:
        out.extend(tok for _rid, tok, _f in dw.step())
    return out


def _jdecode(params, cfg, pres, tokens, n=3):
    dw = JDecodeWorker(params, cfg, max_batch=1,
                       max_len=pres.prompt_len + n + 4)
    dw.join(JServingRequest(req_id=0, tokens=tokens, max_new=n), pres)
    out = [pres.first_token]
    while dw.n_active:
        out.extend(tok for _rid, tok, _f in dw.step())
    return out


def _assert_parity(jp, jcfg, prompt, ref, port):
    """ROADMAP's parity rule: the streams agree up to their first
    divergence, which must sit on a near-tie of the reference's logits."""
    assert len(ref) == len(port)
    i = next((i for i in range(len(ref)) if ref[i] != port[i]), None)
    if i is None:
        return
    ctx = np.concatenate([prompt, np.asarray(ref[:i], prompt.dtype)])
    logits, _ = JT.prefill(jp, jnp.asarray(ctx[None]), jcfg)
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    assert top2[1] - top2[0] <= GAP, (i, top2)


@pytest.fixture(scope="module")
def flat_tokens(weights, prompts):
    """The port's flat-pool run: q1 cold, then q2 reusing the document
    from DRAM."""
    _, cfg, _, tp = weights
    q1, q2 = prompts
    pool = HostKVPool()
    pw = PrefillWorker(tp, cfg, pool, prefill_chunk=128)
    pw(q1)
    out = _decode(tp, cfg, pw(q2), q2)
    pool.close()
    return out


def _tiered(tp, cfg, d, mode, **kw):
    pool = HostKVPool(capacity_blocks=1, ssd_capacity_blocks=32,
                      ssd_dir=str(d), writeback_batch=1, **kw)
    return pool, PrefillWorker(tp, cfg, pool, prefill_chunk=128,
                               ssd_mode=mode)


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_tiered_prefill_equals_flat_pool(weights, prompts, flat_tokens,
                                         tmp_path, mode):
    """A DRAM tier of one block over the SSD tier: the revisit reuses both
    document blocks (off disk) and decodes the flat pool's tokens."""
    _, cfg, _, tp = weights
    q1, q2 = prompts
    pool, pw = _tiered(tp, cfg, tmp_path / mode, mode)
    pw(q1)
    pool.store.flush()
    assert len(pool.store) >= 1           # the revisit must hit the disk
    pres = pw(q2)
    assert pres.reused_blocks == 2
    assert pres.overlapped == (mode == "overlap")
    if mode == "overlap":
        assert pres.ssd_blocks >= 1 and len(pw.overlap_plans) == 1
        assert pw.stats()["ssd_loaded_blocks"] == pres.ssd_blocks
    assert _decode(tp, cfg, pres, q2) == flat_tokens
    assert pool.stats()["store_read_failures"] == 0
    pool.close()


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_tiered_prefill_matches_reference(weights, prompts, tmp_path, mode):
    """The same tiered run through both packages: equal reuse counters,
    greedy tokens under the parity rule."""
    jcfg, cfg, jp, tp = weights
    q1, q2 = prompts
    jpool = JHostKVPool(capacity_blocks=1, ssd_capacity_blocks=32,
                        ssd_dir=str(tmp_path / "ref"), writeback_batch=1)
    jpw = JPrefillWorker(jp, jcfg, jpool, prefill_chunk=128, ssd_mode=mode)
    jpw(q1)
    jpool.store.flush()
    jres = jpw(q2)
    ref = _jdecode(jp, jcfg, jres, q2)
    jpool.close()
    pool, pw = _tiered(tp, cfg, tmp_path / "port", mode)
    pw(q1)
    pool.store.flush()
    pres = pw(q2)
    port = _decode(tp, cfg, pres, q2)
    pool.close()
    assert (pres.reused_blocks, pres.new_blocks, pres.overlapped) == \
        (jres.reused_blocks, jres.new_blocks, jres.overlapped)
    _assert_parity(jp, jcfg, q2, ref, port)


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_corrupt_store_falls_back_to_recompute(weights, prompts,
                                               flat_tokens, tmp_path, mode):
    _, cfg, _, tp = weights
    q1, q2 = prompts
    pool, pw = _tiered(tp, cfg, tmp_path / mode, mode)
    pw(q1)
    store = pool.store
    store.flush()
    with open(store.path, "r+b") as f:    # every slot's payload
        for off in range(0, os.path.getsize(store.path), store._slot_size):
            f.seek(off + store._hdr_size + 11)
            f.write(b"\xde\xad\xbe\xef")
    pres = pw(q2)
    # wrong tokens are impossible: the engine recomputed what it lost
    assert _decode(tp, cfg, pres, q2) == flat_tokens
    assert store.read_failures > 0 or pw.stats()["fallback_blocks"] > 0
    pool.close()


def test_full_hit_revisit_with_store(weights, prompts, tmp_path):
    """A full-prefix hit: the capped plan recomputes the tail block, so
    the first token equals a cold prefill's."""
    _, cfg, _, tp = weights
    doc = prompts[0][:2 * BLOCK_TOKENS]
    logits, _ = prefill(tp, torch.as_tensor(doc[None]), cfg)
    pool, pw = _tiered(tp, cfg, tmp_path, "overlap")
    first = pw(doc)
    again = pw(doc)
    assert first.first_token == again.first_token == int(logits[0].argmax())
    assert again.reused_blocks == 1
    pool.close()


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_port_pool_serves_prefix_off_a_reference_store(weights, prompts,
                                                       tmp_path, mode):
    """The reference's engine writes the document to its store; a port
    pool recovers that store after the restart and serves the prefix off
    it: the loaded blocks are the reference's bytes, bit for bit."""
    jcfg, cfg, jp, tp = weights
    q1, q2 = prompts
    d = tmp_path / "shared"
    jpool = JHostKVPool(capacity_blocks=1, ssd_capacity_blocks=32,
                        ssd_dir=str(d), writeback_batch=1)
    jpw = JPrefillWorker(jp, jcfg, jpool, prefill_chunk=128)
    jres = jpw(q1)
    ref = _jdecode(jp, jcfg, jpw(q2), q2)
    jpool.close()
    ids = prefix_hash_ids(q1)
    pool, pw = _tiered(tp, cfg, d, mode)
    assert set(pool.meta.ssd.blocks) == set(ids)   # restart recovery
    pres = pw(q2)
    loaded = range(2 - pres.ssd_blocks, 2) if mode == "overlap" \
        else range(2)
    assert pres.reused_blocks == (2 if mode == "blocking" else
                                  pres.ssd_blocks)
    assert len(loaded) >= 1
    for i in loaded:
        sl = slice(i * BLOCK_TOKENS, (i + 1) * BLOCK_TOKENS)
        assert np.array_equal(_bits(pres.kv_k[:, sl]),
                              _np_bits(np.asarray(jres.kv_k[:, sl])))
        assert np.array_equal(_bits(pres.kv_v[:, sl]),
                              _np_bits(np.asarray(jres.kv_v[:, sl])))
    _assert_parity(jp, jcfg, q2, ref, _decode(tp, cfg, pres, q2))
    pool.close()


def _two_nodes(weights, prompts, tmp_path, mode, a_dram=1):
    """Shared-directory pair of port pools: the cold prefill lands on A,
    whose one-block DRAM tier demotes the document to A's store."""
    _, cfg, _, tp = weights
    d = GlobalBlockDirectory()
    pa = HostKVPool(capacity_blocks=a_dram, ssd_capacity_blocks=64,
                    ssd_dir=str(tmp_path / "a"), writeback_batch=1,
                    directory=d, node_id=0)
    pb = HostKVPool(capacity_blocks=None, ssd_capacity_blocks=64,
                    ssd_dir=str(tmp_path / "b"), directory=d, node_id=1)
    connect_pools([pa, pb])
    PrefillWorker(tp, cfg, pa, prefill_chunk=128, ssd_mode=mode)(prompts[0])
    pa.store.flush()
    return d, pa, pb, PrefillWorker(tp, cfg, pb, prefill_chunk=128,
                                    ssd_mode=mode)


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_peer_fetch_between_port_pools(weights, prompts, flat_tokens,
                                       tmp_path, mode):
    _, cfg, _, tp = weights
    q2 = prompts[1]
    d, pa, pb, pw_b = _two_nodes(weights, prompts, tmp_path, mode)
    pres = pw_b(q2)
    assert pres.peer_blocks == 2 and pres.reused_blocks == 2
    assert _decode(tp, cfg, pres, q2) == flat_tokens
    assert pb.peer_fetch_failures == 0 and not pb.fallback_reasons
    assert pb.stats()["peer_blocks_fetched"] == 2
    # B now holds the blocks too: the directory shows the replica
    assert all(1 in d.holders(h) for h in prefix_hash_ids(q2))
    pa.close()
    pb.close()


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_killed_peer_falls_back_to_recompute(weights, prompts, flat_tokens,
                                             tmp_path, mode):
    _, cfg, _, tp = weights
    q2 = prompts[1]
    d, pa, pb, pw_b = _two_nodes(weights, prompts, tmp_path, mode)
    pa.kill()
    pres = pw_b(q2)
    assert pres.peer_blocks == 0
    assert _decode(tp, cfg, pres, q2) == flat_tokens
    assert pb.fallback_reasons.get("peer_unreachable", 0) >= 1
    assert pb.peer_fetch_failures >= 1
    pa.close()
    pb.close()


def test_stale_directory_entry_heals(weights, prompts, flat_tokens,
                                     tmp_path):
    """The directory names a slot A has since freed: the fetch fails with
    ``stale_directory``, the claim is withdrawn, decoding stays exact."""
    _, cfg, _, tp = weights
    q2 = prompts[1]
    d, pa, pb, pw_b = _two_nodes(weights, prompts, tmp_path, "overlap")
    ids = prefix_hash_ids(q2)
    plan = pb.plan_fetch(ids)
    assert plan.tiers == ["peer", "peer"]
    for h in ids:
        pa.store.delete(h)
    assert pb.finish_fetch(plan) == 0
    assert pb.fallback_reasons.get("stale_directory", 0) >= 1
    assert 0 not in d.holders(ids[0]), "the stale claim must be withdrawn"
    assert _decode(tp, cfg, pw_b(q2), q2) == flat_tokens
    pa.close()
    pb.close()


def test_serve_twice_on_one_store_reuses_blocks_from_disk(weights,
                                                          tmp_path):
    """The launcher's body with an SSD tier, twice on one directory: the
    second run recovers the first's flushed blocks and serves prefixes
    off disk through the overlapped path, with the same streams."""
    _, cfg, _, tp = weights
    kw = dict(params=tp, requests=8, max_batch=4, max_new=4, pool_blocks=1,
              ssd_blocks=64, ssd_dir=str(tmp_path / "d"), log=lambda m: None)
    cold = serve(cfg, "cpu", **kw)
    warm = serve(cfg, "cpu", **kw)
    assert cold["completed"] == cold["submitted"] == warm["completed"]
    assert cold["store"]["blocks_written"] > 0
    assert warm["ssd_loaded_blocks"] > 0 and warm["overlapped_requests"] > 0
    assert warm["store"]["read_failures"] == 0
    assert warm["overlap_plans"]
    assert warm["prefill_chunks"] < cold["prefill_chunks"]
    assert warm["outputs"] == cold["outputs"]


def test_serve_counts_each_peer_block_once(weights, tmp_path, monkeypatch):
    """The launcher's global-pool run interleaves prefills on one pool.
    The port counts a request's peer blocks around its own fetch, so the
    workers' sum equals the pool's fetches. The reference's launcher
    body, on the same peer store, counts every fetch made while a prefill
    was in flight, and over-counts (ROADMAP §3)."""
    _, cfg, _, tp = weights
    a = str(tmp_path / "a")
    kw = dict(params=tp, requests=8, max_batch=4, max_new=4, pool_blocks=1,
              ssd_blocks=64, log=lambda m: None)
    serve(cfg, "cpu", ssd_dir=a, **kw)
    run = serve(cfg, "cpu", ssd_dir=str(tmp_path / "b"), peer_ssd_dir=a,
                **kw)
    assert run["peer_blocks_fetched"] > 0 and run["peer_fetch_failures"] == 0
    assert run["peer_blocks"] == run["peer_blocks_fetched"]

    workers, pools = [], []

    class Worker(JE.PrefillWorker):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            workers.append(self)

    class Pool(JE.HostKVPool):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pools.append(self)

    monkeypatch.setattr(JE, "PrefillWorker", Worker)
    monkeypatch.setattr(JE, "HostKVPool", Pool)
    assert jax_serve_main(
        ["--requests", "8", "--max-batch", "4", "--max-new", "4",
         "--pool-blocks", "1", "--ssd-blocks", "64", "--ssd-dir",
         str(tmp_path / "c"), "--peer-ssd-dir", a]) == 0
    local = next(p for p in pools if p.node_id == 0)
    assert local.peer_blocks_fetched > 0
    assert sum(w.stats()["peer_blocks"] for w in workers) \
        > local.peer_blocks_fetched


@pytest.mark.parametrize("read_bw,loads", [(1.0, False), (1e15, True)])
def test_throttled_pool_splits_as_the_reference(weights, prompts, tmp_path,
                                                read_bw, loads):
    """``ssd_read_bw`` reaches the store, whose estimate (no blocking read
    has been measured yet) prices the overlapped split: at 1 B/s a block
    read costs more than any recompute and both packages recompute the
    demoted block; at 1 PB/s both load it."""
    jcfg, cfg, jp, tp = weights
    q1, q2 = prompts
    jpool = JHostKVPool(capacity_blocks=1, ssd_capacity_blocks=32,
                        ssd_dir=str(tmp_path / "ref"), writeback_batch=1,
                        ssd_read_bw=read_bw, ssd_write_bw=1e12)
    jpw = JPrefillWorker(jp, jcfg, jpool, prefill_chunk=128,
                         ssd_mode="overlap")
    jpw(q1)
    j_est = jpool.est_block_read_s()      # what the revisit's split reads
    jres = jpw(q2)
    jpool.close()
    pool, pw = _tiered(tp, cfg, tmp_path / "port", "overlap",
                       ssd_read_bw=read_bw, ssd_write_bw=1e12)
    assert (pool.store.read_bw, pool.store.write_bw) == (read_bw, 1e12)
    pw(q1)
    est = pool.est_block_read_s()
    pres = pw(q2)
    pool.close()
    assert est == j_est == pool.store.block_bytes / read_bw
    assert pres.overlapped and jres.overlapped
    assert (pres.reused_blocks, pres.ssd_blocks, pres.skipped_blocks) == \
        (jres.reused_blocks, jres.ssd_blocks, jres.skipped_blocks)
    plan = pw.overlap_plans[-1]
    assert plan["loaded_tail"] == pres.ssd_blocks
    # the demoted document block: recomputed in the head, or loaded
    assert (plan["head_recompute"] == 0) == loads


def test_launcher_accepts_the_tier_flags(tmp_path):
    """``--ssd-blocks/--ssd-dir/--ssd-mode/--peer-ssd-dir`` parse; the
    launcher then asks for the GPU and refuses to fall back to the CPU."""
    with pytest.raises(RuntimeError, match="no GPU"):
        serve_main(["--ssd-blocks", "64", "--ssd-dir", str(tmp_path / "d"),
                    "--ssd-mode", "blocking", "--peer-ssd-dir",
                    str(tmp_path / "p"), "--requests", "1"])
    with pytest.raises(SystemExit):
        serve_main(["--ssd-mode", "sometimes"])


def test_verify_stream_order_on_port_prefill(weights, prompts):
    _, cfg, _, tp = weights
    assert verify_stream_order(cfg, tp, prompts[0][:96])


def test_pool_refuses_a_store_without_an_ssd_tier(tmp_path):
    with pytest.raises(ValueError, match="SSD tier is disabled"):
        HostKVPool(capacity_blocks=4, ssd_dir=str(tmp_path))
    with pytest.raises(ValueError, match="ssd_mode"):
        PrefillWorker({"embed": torch.zeros(1)}, get_config(ARCH).reduced(),
                      HostKVPool(), ssd_mode="eventually")
