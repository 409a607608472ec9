"""The port's functional paged KV cache (``PagedKVCache`` and its
helpers): ``tests/test_paged_cache.py``'s seven tests mirrored in the
port — write/gather round trips, appends across a page boundary, frees,
OOM, a gather of a partial page, an overrun that raises without
touching any page, and page conservation over random assign/free
cycles — plus the same writes gathered by both packages, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # sandboxed env: vendored shim (seeded random)
    from _hypothesis_shim import given, settings, strategies as st

import repro.serving.paged_cache as JPC
from repro.configs.base import get_config as jax_config
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy
from repro_torch.configs.base import get_config
from repro_torch.serving import (PagedKVCache, assign_seq, free_seq,
                                 gather_kv, grow_seq, init_paged_cache,
                                 write_kv)
from repro_torch.serving.paged_cache import alloc_pages

torch.set_num_threads(1)

CFG = get_config("smollm-360m").reduced()
L, KV, Dh = CFG.n_layers, CFG.n_kv_heads, CFG.head_dim


def _cache(**kw) -> PagedKVCache:
    return init_paged_cache(CFG, device="cpu", **kw)


def _randn(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).bfloat16()


def test_write_gather_round_trip():
    cache = _cache(batch=2, n_pages=32, page_tokens=16, max_seq=128)
    cache = assign_seq(cache, 0, 40)
    cache = assign_seq(cache, 1, 70)
    k0 = _randn(0, (L, 40, KV, Dh))
    cache = write_kv(cache, 0, 0, k0, -k0)
    k1 = _randn(1, (L, 70, KV, Dh))
    cache = write_kv(cache, 1, 0, k1, k1 + 1)
    kg, vg = gather_kv(cache, 80)
    assert torch.equal(kg[:, 0, :40], k0)
    assert torch.equal(vg[:, 0, :40], -k0)
    assert torch.equal(kg[:, 1, :70], k1)
    assert torch.equal(vg[:, 1, :70], k1 + 1)


def test_append_write_crosses_page_boundary():
    cache = _cache(batch=1, n_pages=16, page_tokens=16, max_seq=64)
    cache = assign_seq(cache, 0, 30)
    k = torch.ones((L, 30, KV, Dh), dtype=torch.bfloat16)
    cache = write_kv(cache, 0, 0, k, k)
    cache = grow_seq(cache, 0, 10)                  # 30 → 40, new page
    assert int(cache.seq_lens[0]) == 40
    k2 = 2 * torch.ones((L, 10, KV, Dh), dtype=torch.bfloat16)
    cache = write_kv(cache, 0, 30, k2, k2)
    kg, _ = gather_kv(cache, 48)
    assert torch.equal(kg[0, 0, :30, 0, 0].float(), torch.ones(30))
    assert torch.equal(kg[0, 0, 30:40, 0, 0].float(), 2 * torch.ones(10))


def test_free_returns_pages():
    cache = _cache(batch=2, n_pages=8, page_tokens=16, max_seq=64)
    n0 = len(cache.free)
    assert n0 == 7                                  # page 0 is the null page
    cache = assign_seq(cache, 0, 60)                # 4 pages
    assert len(cache.free) == n0 - 4
    assert 0 not in cache.block_table[0, :4].tolist()
    cache = free_seq(cache, 0)
    assert len(cache.free) == n0
    assert int(cache.seq_lens[0]) == 0
    assert cache.block_table[0].abs().sum() == 0


def test_oom_raises():
    cache = _cache(batch=1, n_pages=4, page_tokens=16, max_seq=256)
    with pytest.raises(MemoryError):
        assign_seq(cache, 0, 16 * 10)
    with pytest.raises(MemoryError):
        alloc_pages(cache, 4)
    assert len(alloc_pages(cache, 3)) == 3


def test_gather_kv_non_multiple_max_tokens_keeps_tail():
    """max_tokens not a multiple of page_tokens rounds UP to whole pages
    and slices, never truncating the partial page."""
    cache = _cache(batch=1, n_pages=16, page_tokens=16, max_seq=64)
    cache = assign_seq(cache, 0, 40)
    k = _randn(2, (L, 40, KV, Dh))
    cache = write_kv(cache, 0, 0, k, -k)
    kg, vg = gather_kv(cache, 40)                   # 2.5 pages
    assert kg.shape[2] == 40
    assert torch.equal(kg[:, 0], k) and torch.equal(vg[:, 0], -k)


def test_write_kv_overrun_raises_not_corrupts():
    """A write past the assigned pages raises before touching any page:
    neither the null page (entry 0) nor the slot's assigned pages."""
    cache = _cache(batch=1, n_pages=16, page_tokens=16, max_seq=64)
    cache = assign_seq(cache, 0, 20)                # 2 pages assigned
    k = torch.ones((L, 20, KV, Dh), dtype=torch.bfloat16)
    before_k, before_v = cache.k_pages.clone(), cache.v_pages.clone()
    with pytest.raises(IndexError, match="unassigned page"):
        write_kv(cache, 0, 30, k, k)        # page 1 fits, page 2 is entry 0
    with pytest.raises(IndexError, match="overruns the block table"):
        write_kv(cache, 0, 64, k, k)        # past the table itself
    assert torch.equal(cache.k_pages, before_k)
    assert torch.equal(cache.v_pages, before_v)


@given(st.lists(st.tuples(st.integers(0, 3), st.integers(1, 60)),
                min_size=1, max_size=12))
@settings(max_examples=40, deadline=None)
def test_alloc_free_cycles_conserve_pages(ops):
    """Random assign/free cycles: no page leaked, no page double-owned."""
    cache = _cache(batch=4, n_pages=64, page_tokens=16, max_seq=64)
    total = len(cache.free)
    active = set()
    for slot, tokens in ops:
        if slot in active:
            cache = free_seq(cache, slot)
            active.discard(slot)
        else:
            try:
                cache = assign_seq(cache, slot, tokens)
                active.add(slot)
            except MemoryError:
                pass
        table = cache.block_table.numpy()
        lens = cache.seq_lens.numpy()
        owned = []
        for s in range(4):
            n = int(np.ceil(lens[s] / cache.page_tokens))
            owned.extend(int(p) for p in table[s, :n] if p != 0)
        assert len(owned) == len(set(owned)), "page double-owned"
        assert len(owned) + len(cache.free) == total, "page leaked"


def test_same_writes_gather_the_same_in_both_packages():
    """The reference's helpers and the port's, driven by the same calls
    and KV: equal tables, lengths and free lists, and bit-for-bit equal
    gathers."""
    jcfg = jax_config("smollm-360m").reduced()
    ref = JPC.init_paged_cache(jcfg, batch=2, n_pages=16, page_tokens=16,
                               max_seq=64)
    mine = _cache(batch=2, n_pages=16, page_tokens=16, max_seq=64)
    rng = np.random.default_rng(0)
    for slot, n, start in ((0, 40, 0), (1, 17, 0)):
        ref = JPC.assign_seq(ref, slot, n)
        mine = assign_seq(mine, slot, n)
        kv = jnp.asarray(rng.standard_normal((L, n, KV, Dh)), jnp.bfloat16)
        ref = JPC.write_kv(ref, slot, start, kv, -kv)
        t = tensor_from_numpy(np.asarray(kv), "cpu")
        mine = write_kv(mine, slot, start, t, -t)
    ref, mine = JPC.grow_seq(ref, 1, 20), grow_seq(mine, 1, 20)
    kv = jnp.asarray(rng.standard_normal((L, 20, KV, Dh)), jnp.bfloat16)
    ref = JPC.write_kv(ref, 1, 17, kv, kv)
    t = tensor_from_numpy(np.asarray(kv), "cpu")
    mine = write_kv(mine, 1, 17, t, t)
    ref, mine = JPC.free_seq(ref, 0), free_seq(mine, 0)
    np.testing.assert_array_equal(mine.block_table.numpy(),
                                  np.asarray(ref.block_table))
    np.testing.assert_array_equal(mine.seq_lens.numpy(),
                                  np.asarray(ref.seq_lens))
    assert mine.free == ref.free
    for a, b in zip(gather_kv(mine, 40), JPC.gather_kv(ref, 40)):
        np.testing.assert_array_equal(tensor_to_numpy(a),
                                      np.asarray(b, np.float32))
