"""The port's attention kernels against the reference's: the plain PyTorch
versions (what a CPU tensor takes) vs the jnp oracles on the reference's
own cases, one grouped case per Pallas kernel in interpret mode, and the
CPU/CUDA dispatch rules (the CUDA kernels themselves are held against
their plain versions in ``test_torch_cuda.py``). Inputs come from numpy
seeds and go to both packages.
Tolerances: 2e-2 in bf16, 2e-5 in f32 (the reference's kernel tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill.kernel import flash_prefill as jax_flash
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_flash_ref
from repro.kernels.paged_attention.kernel import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref
from repro.models.layers import causal_attention as jax_causal
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.kernel import flash_prefill
from repro_torch.kernels.flash_prefill.ops import flash_prefill_attention
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ops import (grouped_map,
                                                     paged_decode_attention)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

BF16_TOL = 2e-2
F32_TOL = 2e-5

# the two padded query-head maps of smollm-360m: full width (15 heads over
# 5 KV heads, padded to 16) and .reduced() (4 heads over 2, padded to 16)
SMOLLM_MAP_FULL = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 0]
SMOLLM_MAP_REDUCED = [0, 0, 1, 1] + [0] * 12


def _arr(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(jnp.bfloat16) if dtype == "bf16" else a


def _close(port, ref, tol):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------- paged ----
PAGED_CASES = [  # the reference's cases: B, H, KV, D, P, page, max_pages
    (4, 8, 2, 64, 32, 64, 4),
    (2, 4, 4, 128, 16, 128, 2),
    (3, 15, 5, 32, 64, 64, 8),
    (1, 2, 1, 128, 8, 64, 3),
]


def _paged_inputs(B, H, KV, D, P, page, mp, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    q = _arr(rng, (B, H, D), "bf16")
    kp = _arr(rng, (P, page, KV, D), "bf16")
    vp = _arr(rng, (P, page, KV, D), "bf16")
    table = rng.integers(1, P, (B, mp)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, mp * page + 1, (B,))
    return q, kp, vp, table, np.asarray(lens, np.int32)


def _paged_pair(q, kp, vp, table, lens, qh2kv=None, window=0):
    jm = None if qh2kv is None else jnp.asarray(qh2kv, jnp.int32)
    tm = None if qh2kv is None else torch.tensor(qh2kv, dtype=torch.int32)
    ref = jax_paged_ref(*(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
                        qh2kv=jm, window=window)
    port = paged_attention_ref(*(tensor_from_numpy(a, "cpu")
                                 for a in (q, kp, vp, table, lens)),
                               qh2kv=tm, window=window)
    return port, ref


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_reference_oracle(case):
    port, ref = _paged_pair(*_paged_inputs(*case))
    _close(port, ref, BF16_TOL)


@pytest.mark.parametrize("qh2kv,KV", [(SMOLLM_MAP_FULL, 5),
                                      (SMOLLM_MAP_REDUCED, 2)])
def test_paged_plain_smollm_head_maps(qh2kv, KV):
    inputs = _paged_inputs(4, 16, KV, 64, 32, 64, 4, seed=7)
    port, ref = _paged_pair(*inputs, qh2kv=qh2kv)
    _close(port, ref, BF16_TOL)


@pytest.mark.parametrize("lens", [[1, 64, 65, 128], [63, 64, 127, 256],
                                  [10, 10, 10, 10]])
def test_paged_plain_ragged_and_boundary(lens):
    inputs = _paged_inputs(4, 8, 2, 64, 32, 64, 4, seed=3, lens=lens)
    port, ref = _paged_pair(*inputs)
    _close(port, ref, BF16_TOL)


def test_paged_plain_poisoned_null_page_and_window():
    q, kp, vp, _, _ = _paged_inputs(2, 4, 4, 64, 16, 64, 4)
    kp[0] = 1e4
    vp[0] = -1e4
    table = np.asarray([[3, 0, 0, 0], [5, 7, 0, 0]], np.int32)
    lens = np.asarray([40, 100], np.int32)
    for window in (0, 48):
        port, ref = _paged_pair(q, kp, vp, table, lens, window=window)
        _close(port, ref, BF16_TOL)
        assert np.isfinite(tensor_to_numpy(port)).all()


def test_paged_pallas_interpret_grouped_case():
    """The Pallas kernel itself (interpret mode) on one grouped case."""
    q, kp, vp, table, lens = _paged_inputs(4, 8, 2, 64, 32, 64, 4, seed=11)
    out = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
                    interpret=True)
    port = paged_attention_ref(*(tensor_from_numpy(a, "cpu")
                                 for a in (q, kp, vp, table, lens)))
    _close(port, out, BF16_TOL)


# ---------------------------------------------------------------- flash ----
FLASH_CASES = [  # the reference's cases: B, Sq, Sk, H, KV, D, offset, window
    (2, 128, 256, 4, 2, 64, 128, 0),
    (1, 256, 256, 8, 8, 128, 0, 0),
    (2, 128, 512, 4, 1, 32, 384, 128),
    (1, 128, 128, 16, 4, 128, 0, 0),
    (1, 64, 192, 2, 2, 64, 128, 0),
]


def _flash_inputs(B, Sq, Sk, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (_arr(rng, (B, Sq, H, D), dtype), _arr(rng, (B, Sk, KV, D), dtype),
            _arr(rng, (B, Sk, KV, D), dtype))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_flash_plain_matches_reference_oracle(case, dtype):
    B, Sq, Sk, H, KV, D, off, win = case
    q, k, v = _flash_inputs(B, Sq, Sk, H, KV, D, dtype)
    ref = jax_flash_ref(*map(jnp.asarray, (q, k, v)), q_offset=off,
                        window=win)
    port = flash_prefill_ref(*(tensor_from_numpy(a, "cpu") for a in (q, k, v)),
                             q_offset=off, window=win)
    _close(port, ref, BF16_TOL if dtype == "bf16" else F32_TOL)


@pytest.mark.parametrize("q_offset,Sq,Sk,qh2kv,KV", [
    (0, 96, 96, SMOLLM_MAP_REDUCED, 2),        # a cold first chunk
    (128, 64, 320, SMOLLM_MAP_REDUCED, 2),     # a middle chunk, zero tail
    (256, 37, 293, SMOLLM_MAP_FULL, 5),        # the ragged last chunk
])
def test_flash_matches_causal_attention_at_runtime_offsets(q_offset, Sq, Sk,
                                                           qh2kv, KV):
    """What the serving path computes: the reference's ``causal_attention``
    over the head-expanded extend cache (keys past the chunk are zero)
    vs the port's prefill op over the KV-headed cache plus the map."""
    q, k, v = _flash_inputs(1, Sq, Sk, 16, KV, 32, "bf16", seed=q_offset)
    k[:, q_offset + Sq:] = 0
    v[:, q_offset + Sq:] = 0
    idx = np.asarray(qh2kv)
    ref = jax_causal(jnp.asarray(q), jnp.asarray(k[:, :, idx]),
                     jnp.asarray(v[:, :, idx]), jnp.asarray(q_offset))
    port = flash_prefill_attention(
        *(tensor_from_numpy(a, "cpu") for a in (q, k, v)),
        q_offset=q_offset, qh2kv=torch.tensor(qh2kv, dtype=torch.int32))
    _close(port, ref, BF16_TOL)


def test_flash_pallas_interpret_grouped_case():
    q, k, v = _flash_inputs(1, 128, 256, 8, 2, 64, "bf16", seed=5)
    out = jax_flash(*map(jnp.asarray, (q, k, v)), q_offset=128, bq=64, bk=64,
                    interpret=True)
    port = flash_prefill_ref(*(tensor_from_numpy(a, "cpu") for a in (q, k, v)),
                             q_offset=128)
    _close(port, out, BF16_TOL)


# ------------------------------------------------------------- dispatch ----

def test_cpu_tensors_take_the_plain_versions():
    q, kp, vp, table, lens = (tensor_from_numpy(a, "cpu") for a in
                              _paged_inputs(2, 8, 2, 32, 8, 16, 2))
    assert torch.equal(paged_decode_attention(q, kp, vp, table, lens),
                       paged_attention_ref(q, kp, vp, table, lens))
    qf, kf, vf = (tensor_from_numpy(a, "cpu")
                  for a in _flash_inputs(1, 16, 40, 4, 2, 32, "bf16"))
    assert torch.equal(flash_prefill_attention(qf, kf, vf, q_offset=24),
                       flash_prefill_ref(qf, kf, vf, q_offset=24))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on CUDA tensors or raises — it never
    computes anything itself."""
    q, kp, vp, table, lens = (tensor_from_numpy(a, "cpu") for a in
                              _paged_inputs(2, 8, 2, 32, 8, 16, 2))
    m = grouped_map(8, 2, "cpu")
    before = paged_attention.launches, flash_prefill.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention(q, kp, vp, table, lens, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_prefill(q[None], kp[:1], vp[:1], m)
    assert (paged_attention.launches, flash_prefill.launches) == before


def test_build_names_libraries_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    name = _build._lib_path("paged_attention").name
    assert name.startswith("paged_attention-") and name.endswith(".so")
    assert _build._lib_path("paged_attention") \
        != _build._lib_path("flash_prefill")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check(1, "paged_attention")
