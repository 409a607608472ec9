"""The decompositions the CUDA kernels compute, as plain PyTorch on the
CPU, against the reference: the chunked-prefill split over keys (partials
per run of 64-key tiles, merged by log-sum-exp) and the host's choice of
the split count; the SSD scan as four passes (C·Bᵀ, chunk states, the
recurrence over chunks, outputs) and the strided views the SSD op hands
to its kernel.

Tolerances: 2e-2 for bf16 attention (the reference's kernel tests), 5e-3
for the fp32 SSD scan (``tests/test_kernels.py:155``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill.kernel import flash_prefill as jax_flash
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_flash_ref
from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_kernel
from repro.kernels.ssd_scan.ref import ssd_naive_ref as jax_naive
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy
from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_prefill.kernel import choose_splits
from repro_torch.kernels.flash_prefill.ref import (TILE, flash_prefill_ref,
                                                   flash_prefill_split_ref,
                                                   split_tiles)
from repro_torch.kernels.ssd_scan.kernel import row_layout_ok
from repro_torch.kernels.ssd_scan.ref import (chunk_cb, chunk_scan,
                                              chunk_state, ssd_chunked,
                                              ssd_naive_ref, state_pass)

torch.set_num_threads(1)

BF16_TOL = 2e-2
F32_TOL = 5e-3
SMOLLM_MAP_FULL = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 0]


def _close(port, ref, tol):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _flash_inputs(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(
        np.float32).astype(jnp.bfloat16)
    return f(B, Sq, H, D), f(B, Sk, KV, D), f(B, Sk, KV, D)


def _cpu(*arrays):
    return [tensor_from_numpy(a, "cpu") for a in arrays]


# ------------------------------------------------------------ prefill ----

@pytest.mark.parametrize("n_splits", [1, 2, 3, 5])
def test_split_decomposition_matches_pallas_and_plain(n_splits):
    """The reference's grouped case (as tests/test_torch_kernels.py runs
    it): the Pallas kernel in interpret mode and the plain version against
    the split decomposition."""
    q, k, v = _flash_inputs(1, 128, 256, 8, 2, 64, seed=5)
    pallas = jax_flash(*map(jnp.asarray, (q, k, v)), q_offset=128, bq=64,
                       bk=64, interpret=True)
    tq, tk, tv = _cpu(q, k, v)
    split = flash_prefill_split_ref(tq, tk, tv, q_offset=128,
                                    n_splits=n_splits)
    _close(split, pallas, BF16_TOL)
    _close(split, tensor_to_numpy(flash_prefill_ref(tq, tk, tv,
                                                    q_offset=128)), BF16_TOL)


@pytest.mark.parametrize("q_offset,Sq,Sk,window,n_splits", [
    (0, 256, 256, 0, 5),        # early query tiles: most splits empty
    (1280, 131, 1411, 0, 6),    # the ragged last serving chunk
    (768, 256, 1024, 200, 4),   # a window starting inside a split
    (299, 1, 300, 0, 3),        # one query row
])
def test_split_decomposition_matches_reference_oracle(q_offset, Sq, Sk,
                                                      window, n_splits):
    q, k, v = _flash_inputs(1, Sq, Sk, 4, 2, 32, seed=Sq)
    ref = jax_flash_ref(*map(jnp.asarray, (q, k, v)), q_offset=q_offset,
                        window=window)
    split = flash_prefill_split_ref(*_cpu(q, k, v), q_offset=q_offset,
                                    window=window, n_splits=n_splits)
    _close(split, ref, BF16_TOL)
    assert np.isfinite(tensor_to_numpy(split)).all()


def test_split_decomposition_irregular_head_map():
    """smollm-360m's padded map (KV head 0 serves 4 of 16 heads)."""
    q, k, v = _flash_inputs(1, 256, 1536, 16, 5, 64, seed=1)
    tq, tk, tv = _cpu(q, k, v)
    m = torch.tensor(SMOLLM_MAP_FULL, dtype=torch.int32)
    _close(flash_prefill_split_ref(tq, tk, tv, q_offset=1280, qh2kv=m,
                                   n_splits=5),
           tensor_to_numpy(flash_prefill_ref(tq, tk, tv, q_offset=1280,
                                             qh2kv=m)), BF16_TOL)


@pytest.mark.parametrize("m0,Sq,Sk,q_offset,window,n_splits", [
    (0, 256, 256, 0, 0, 5), (192, 256, 1536, 1280, 0, 5),
    (128, 131, 1411, 1280, 0, 6), (64, 256, 1024, 768, 200, 4),
    (0, 1, 300, 299, 0, 3), (0, 64, 64, 0, 0, 1)])
def test_split_tiles_cover_the_causal_range_in_whole_tiles(m0, Sq, Sk,
                                                           q_offset, window,
                                                           n_splits):
    runs = split_tiles(m0, Sq, Sk, q_offset, window, n_splits)
    assert len(runs) == n_splits
    last = min(m0 + TILE, Sq) - 1
    k_hi = min(Sk, q_offset + last + 1)
    lo = runs[0][0]
    assert lo % TILE == 0 and lo <= max(0, q_offset + m0 - window + 1
                                        if window else 0)
    for (a, b), (c, _) in zip(runs, runs[1:] + [(k_hi, k_hi)]):
        assert a <= b == c or (a == b == c)       # contiguous, in order
        assert a % TILE == 0 or a == b == k_hi    # whole tiles
    assert runs[-1][1] == k_hi


@pytest.mark.parametrize("n_blocks,key_tiles,sms,want", [
    (64, 24, 132, 5),      # the serving chunk: 4 query tiles x 16 heads
    (48, 23, 132, 6),      # the ragged 131-token tail chunk
    (16, 3, 132, 3),       # capped by the key tiles
    (264, 24, 132, 1),     # the grid already fills two blocks per SM
    (16, 1, 132, 1),       # one key tile: nothing to split
    (64, 24, 114, 4),      # a card with fewer SMs
])
def test_split_count_fills_the_card(n_blocks, key_tiles, sms, want):
    assert choose_splits(n_blocks, key_tiles, sms) == want


# ---------------------------------------------------------------- ssd ----

def _ssd_inputs(b, s, h, p, n, with_h0, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, B, C = (a.astype(jnp.bfloat16) for a in (f(b, s, h, p), f(b, s, n),
                                                f(b, s, n)))
    dt = np.log1p(np.exp(f(b, s, h))).astype(np.float32)      # softplus
    A = -np.exp(0.5 * f(h)).astype(np.float32)
    h0 = f(b, h, p, n) if with_h0 else None
    return x, dt, A, B, C, h0


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [
    (1, 96, 2, 16, 32, 32, True), (2, 80, 3, 8, 16, 16, False),
    (1, 102, 2, 8, 16, 17, True)])
def test_ssd_state_pass_gives_the_recurrence_at_chunk_boundaries(
        b, s, h, p, n, chunk, with_h0):
    """h_in[c] is the per-token recurrence's state after c·l positions."""
    x, dt, A, B, C, h0 = _ssd_inputs(b, s, h, p, n, with_h0, seed=s)
    tx, tdt, tA, tB, tC = _cpu(x, dt, A, B, C)
    th0 = None if h0 is None else torch.from_numpy(h0)
    cum, states = chunk_state(tx, tdt, tA, tB, chunk)
    h_in, hT = state_pass(states, cum, th0)
    for c in range(s // chunk):
        if c == 0:
            want = np.zeros((b, h, p, n), np.float32) if h0 is None else h0
        else:
            _, want = jax_naive(*map(jnp.asarray, (x[:, :c * chunk],
                                                   dt[:, :c * chunk], A,
                                                   B[:, :c * chunk],
                                                   C[:, :c * chunk])),
                                h0=None if h0 is None else jnp.asarray(h0))
        _close(h_in[:, c], want, F32_TOL)
    _, want = jax_naive(*map(jnp.asarray, (x, dt, A, B, C)),
                        h0=None if h0 is None else jnp.asarray(h0))
    _close(hT, want, F32_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 128, 2, 16, 32, 64),
                                             (2, 64, 3, 8, 16, 32)])
def test_ssd_passes_compose_to_the_pallas_scan(b, s, h, p, n, chunk):
    x, dt, A, B, C, h0 = _ssd_inputs(b, s, h, p, n, True, seed=b + s)
    y_k, hT_k = jax_ssd_kernel(*map(jnp.asarray, (x, dt, A, B, C, h0)),
                               chunk=chunk, interpret=True)
    tx, tdt, tA, tB, tC, th0 = _cpu(x, dt, A, B, C, h0)
    cb = chunk_cb(tB, tC, chunk)
    cum, states = chunk_state(tx, tdt, tA, tB, chunk)
    h_in, hT = state_pass(states, cum, th0)
    y = chunk_scan(tx, tdt, tC, cb, cum, h_in)
    _close(y, y_k, F32_TOL)
    _close(hT, hT_k, F32_TOL)
    y2, hT2 = ssd_chunked(tx, tdt, tA, tB, tC, chunk, h0=th0)
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    # pass 1 is C·Bᵀ per chunk, and the naive oracle agrees end to end
    c0 = tC[:, :chunk].float() @ tB[:, :chunk].float().transpose(1, 2)
    assert torch.allclose(cb[:, 0], c0)
    _close(y, tensor_to_numpy(ssd_naive_ref(tx, tdt, tA, tB, tC, h0=th0)[0]),
           F32_TOL)


@pytest.mark.parametrize("model", ["mamba2-2.7b", "reduced"])
def test_mamba_views_go_to_the_kernel_without_copies(model):
    """x, B and C as ``mamba_block`` splits them from the conv output are
    read in place (rows of 5376 and 544 elements); a layout the kernel
    cannot read (a transposed view, a row stride off the 8-element grid)
    is not."""
    cfg = get_config("mamba2-2.7b")
    if model == "reduced":
        cfg = cfg.reduced()
    s_cfg = cfg.ssm
    di, n = s_cfg.d_inner(cfg.d_model), s_cfg.d_state
    nh, hd = s_cfg.n_heads(cfg.d_model), s_cfg.head_dim
    conv_out = torch.empty((1, 8, di + 2 * n), dtype=torch.bfloat16,
                           device="meta")
    xs, B, C = torch.split(conv_out, [di, n, n], dim=-1)
    x = xs.reshape(1, 8, nh, hd)
    assert not x.is_contiguous()
    assert all(row_layout_ok(t) for t in (x, B, C))
    assert (di + 2 * n) in (5376, 544)
    assert not row_layout_ok(B.transpose(1, 2))
    odd = torch.empty((1, 8, n + 4), dtype=torch.bfloat16, device="meta")
    assert not row_layout_ok(odd[..., :n])
