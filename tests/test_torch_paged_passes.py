"""The paged decode kernel's decomposition, as plain PyTorch on the CPU,
against the reference: per (slot, KV head, split) partials over the KV
head's query-head group, merged in split order
(``paged_attention_splits_ref``), on irregular head maps, forced split
counts, ragged lengths, windows and a poisoned null page; the group and
split helpers; the host's choice of the split count; and the cached
grouped head map. Inputs come from numpy seeds and go to both packages.

Tolerance: 2e-2 in bf16 (the reference's paged-attention tests)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels.paged_attention.kernel import choose_splits
from repro_torch.kernels.paged_attention.ops import grouped_map
from repro_torch.kernels.paged_attention.ref import (
    TILE, kv_head_groups, paged_attention_layers_splits_ref,
    paged_attention_splits_ref, split_ranges)

torch.set_num_threads(1)

BF16_TOL = 2e-2
SMOLLM_MAP_FULL = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 0]
SMOLLM_MAP_REDUCED = [0, 0, 1, 1] + [0] * 12

# name: H, KV, head map (None = grouped), D, page size
MAP_CASES = {
    "smollm-full": (16, 5, SMOLLM_MAP_FULL, 64, 64),
    "smollm-reduced": (16, 2, SMOLLM_MAP_REDUCED, 32, 16),
    "grouped-g8": (16, 2, None, 32, 32),
    "kv1-g16": (16, 1, None, 32, 64),
    "kv1-g32": (32, 1, None, 32, 16),          # two 16-row query tiles
    "unused-kv": (8, 3, [0, 0, 0, 0, 2, 2, 2, 2], 32, 32),
}
MAX_TOKENS = 384                                # six 64-token tiles a slot


def _inputs(B, H, KV, D, page, lens, seed, P=None, L=None):
    """q, pages (null page 0 poisoned), a block table of distinct live
    pages (0 past each slot's live pages) and the lengths, as numpy."""
    rng = np.random.default_rng(seed)
    mp = MAX_TOKENS // page
    P = P or B * mp + 1
    lead = () if L is None else (L,)
    f = lambda *s: rng.standard_normal(s).astype(np.float32).astype(
        jnp.bfloat16)
    q = f(*lead, B, H, D)
    kp, vp = f(*lead, P, page, KV, D), f(*lead, P, page, KV, D)
    kp[..., 0, :, :, :] = 1e4
    vp[..., 0, :, :, :] = -1e4
    table = np.zeros((B, mp), np.int32)
    perm = rng.permutation(np.arange(1, P))
    nxt = 0
    for b, n in enumerate(lens):
        live = -(-n // page)
        table[b, :live] = perm[nxt:nxt + live]
        nxt += live
    return q, kp, vp, table, np.asarray(lens, np.int32)


def _both(inputs, qh2kv, window, n_splits):
    q, kp, vp, table, lens = inputs
    ref = jax_ref(*map(jnp.asarray, inputs), window=window,
                  qh2kv=None if qh2kv is None else jnp.asarray(qh2kv,
                                                               jnp.int32))
    port = paged_attention_splits_ref(
        *(tensor_from_numpy(a, "cpu") for a in inputs), window=window,
        qh2kv=None if qh2kv is None else torch.tensor(qh2kv,
                                                      dtype=torch.int32),
        n_splits=n_splits)
    return tensor_to_numpy(port), np.asarray(ref, np.float32)


@pytest.mark.parametrize("n_splits", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(MAP_CASES))
def test_splits_ref_matches_reference(name, n_splits):
    """Lengths of 1 (most splits empty), one whole tile, a tile and one
    token, and the full table; the null page is poisoned and never read."""
    H, KV, qh2kv, D, page = MAP_CASES[name]
    inputs = _inputs(4, H, KV, D, page, [1, 64, 65, MAX_TOKENS],
                     seed=n_splits + H + KV)
    port, ref = _both(inputs, qh2kv, 0, n_splits)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("window,n_splits", [(100, 2), (200, 4), (70, 8),
                                             (300, 3)])
def test_splits_ref_window_starts_inside_a_split(window, n_splits):
    H, KV, qh2kv, D, page = MAP_CASES["smollm-full"]
    lens = [MAX_TOKENS, 301, 90, 5]
    inputs = _inputs(4, H, KV, D, page, lens, seed=window)
    runs = split_ranges(lens[0], window, MAX_TOKENS, n_splits)
    assert runs[0][0] == MAX_TOKENS - window and runs[0][0] % TILE
    port, ref = _both(inputs, qh2kv, window, n_splits)
    np.testing.assert_allclose(port, ref, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("n_splits", [2, 4])
def test_splits_ref_matches_pallas_interpret(n_splits):
    """The grouped case tests/test_torch_kernels.py runs through the Pallas
    kernel in interpret mode, against the split decomposition."""
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32).astype(
        jnp.bfloat16)
    q, kp, vp = f(4, 8, 64), f(32, 64, 2, 64), f(32, 64, 2, 64)
    table = rng.integers(1, 32, (4, 4)).astype(np.int32)
    lens = np.asarray([1, 64, 200, 256], np.int32)
    out = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
                    interpret=True)
    port = paged_attention_splits_ref(
        *(tensor_from_numpy(a, "cpu") for a in (q, kp, vp, table, lens)),
        n_splits=n_splits)
    np.testing.assert_allclose(tensor_to_numpy(port), np.asarray(out,
                                                                 np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("qh2kv,H,KV,want", [
    (SMOLLM_MAP_FULL, 16, 5, [[0, 1, 2, 15], [3, 4, 5], [6, 7, 8],
                              [9, 10, 11], [12, 13, 14]]),
    (SMOLLM_MAP_REDUCED, 16, 2, [[0, 1] + list(range(4, 16)), [2, 3]]),
    ([0, 0, 0, 0, 2, 2, 2, 2], 8, 3, [[0, 1, 2, 3], [], [4, 5, 6, 7]]),
    (None, 8, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),
])
def test_kv_head_groups_in_ascending_order(qh2kv, H, KV, want):
    m = None if qh2kv is None else torch.tensor(qh2kv, dtype=torch.int32)
    assert kv_head_groups(m, H, KV) == want


@pytest.mark.parametrize("seq_len,window,n_splits", [
    (1, 0, 8), (64, 0, 2), (65, 0, 4), (384, 0, 8), (384, 100, 2),
    (301, 200, 4), (500, 0, 3)])
def test_split_ranges_cover_the_live_range_in_whole_tiles(seq_len, window,
                                                          n_splits):
    runs = split_ranges(seq_len, window, MAX_TOKENS, n_splits)
    n_tok = min(seq_len, MAX_TOKENS)
    lo = max(seq_len - window, 0) if window else 0
    assert len(runs) == n_splits
    live = [(a, b) for a, b in runs if b > a]
    assert live[0][0] == lo and live[-1][1] == n_tok
    for (a, b), (c, _) in zip(live, live[1:]):
        assert b == c and b % TILE == 0       # contiguous, tile boundaries
    assert all(a == b for a, b in runs[len(live):])  # empty splits last


@pytest.mark.parametrize("n_blocks,n_tiles,sms,want", [
    (40, 32, 132, 8),      # the serving step: 8 slots x 5 KV heads
    (100, 32, 132, 4),
    (264, 32, 132, 1),     # the grid already fills two blocks per SM
    (40, 3, 132, 2),       # capped by the tiles
    (40, 1, 132, 1),       # one tile: nothing to split
    (2, 32, 132, 8),       # capped by the cluster size
    (5, 8, 132, 8),        # capped by the tiles, not by the card
    (80, 32, 114, 4),      # a card with fewer SMs
])
def test_paged_split_count_fills_the_card(n_blocks, n_tiles, sms, want):
    assert choose_splits(n_blocks, n_tiles, sms) == want
    assert choose_splits(n_blocks, n_tiles, sms) == want   # pure


@pytest.mark.parametrize("name,window,n_splits", [("smollm-full", 0, 8),
                                                  ("grouped-g8", 100, 2)])
def test_layers_splits_ref_equals_per_layer_stack(name, window, n_splits):
    H, KV, qh2kv, D, page = MAP_CASES[name]
    q, kp, vp, table, lens = (tensor_from_numpy(a, "cpu") for a in _inputs(
        3, H, KV, D, page, [7, 130, MAX_TOKENS], seed=5, L=3))
    m = None if qh2kv is None else torch.tensor(qh2kv, dtype=torch.int32)
    out = paged_attention_layers_splits_ref(q, kp, vp, table, lens, qh2kv=m,
                                            window=window, n_splits=n_splits)
    per = torch.stack([paged_attention_splits_ref(
        q[l], kp[l], vp[l], table, lens, qh2kv=m, window=window,
        n_splits=n_splits) for l in range(3)])
    assert torch.equal(out, per)


def test_grouped_map_is_built_once_per_shape_and_device():
    a = grouped_map(16, 2, "cpu")
    assert a is grouped_map(16, 2, torch.device("cpu"))
    assert a.dtype == torch.int32 and a.tolist() == [h // 8 for h in
                                                     range(16)]
    assert grouped_map(16, 4, "cpu") is not a
