"""The hand-written CUDA kernels against their plain PyTorch versions, on
the GPU. Every test here is marked ``cuda`` and skips without a GPU (a
CUDA kernel has no CPU mode); the file imports neither jax nor the
reference, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 2e-2 in bf16 (the reference's kernel tests)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill.ops import flash_prefill_attention
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = 2e-2
SMOLLM_MAP_FULL = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 0]
SMOLLM_MAP_REDUCED = [0, 0, 1, 1] + [0] * 12
FLASH_CASES = [  # B, Sq, Sk, H, KV, D, offset, window
    (2, 128, 256, 4, 2, 64, 128, 0),
    (1, 256, 256, 8, 8, 128, 0, 0),
    (2, 128, 512, 4, 1, 32, 384, 128),
    (1, 128, 128, 16, 4, 128, 0, 0),
    (1, 64, 192, 2, 2, 64, 128, 0),
    (1, 131, 1411, 16, 5, 64, 1280, 0),    # the ragged last serving chunk
]


@pytest.fixture(scope="session")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels build "
                    "and run only there)")
    # initialise CUDA here, at session scope: its pipes and sockets
    # then predate every test's fd-leak snapshot
    torch.zeros(1, device="cuda")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).bfloat16()


def _close(out, ref):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("qh2kv,KV,D", [(SMOLLM_MAP_FULL, 5, 64),
                                       (SMOLLM_MAP_REDUCED, 2, 32),
                                       (None, 2, 128)])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_kernel_matches_plain(cuda, qh2kv, KV, D, window):
    rng = np.random.default_rng(2)
    B, H, P, page, mp = 5, 16, 40, 64, 6
    q = _randn(rng, (B, H, D), cuda)
    kp, vp = _randn(rng, (P, page, KV, D), cuda), _randn(rng, (P, page, KV, D),
                                                        cuda)
    kp[0], vp[0] = 1e4, -1e4                   # poisoned null page
    lens = [1, 64, 129, 300, 384]              # ragged, boundaries, full
    table = torch.zeros(B, mp, dtype=torch.int32)
    for b, n in enumerate(lens):
        live = -(-n // page)
        table[b, :live] = torch.from_numpy(rng.choice(np.arange(1, P), live,
                                                      replace=False))
    table = table.to(cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    m = None if qh2kv is None else torch.tensor(qh2kv, dtype=torch.int32,
                                                device=cuda)
    before = paged_attention.launches
    out = paged_decode_attention(q, kp, vp, table, lens, qh2kv=m,
                                 window=window)
    assert paged_attention.launches == before + 1
    _close(out, paged_attention_ref(q, kp, vp, table, lens, qh2kv=m,
                                    window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_prefill_kernel_matches_plain(cuda, case):
    B, Sq, Sk, H, KV, D, off, win = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, D), cuda)
    k, v = _randn(rng, (B, Sk, KV, D), cuda), _randn(rng, (B, Sk, KV, D), cuda)
    k[:, off + Sq:], v[:, off + Sq:] = 1e4, -1e4   # never read
    m = None
    if H == 16 and KV == 5:
        m = torch.tensor(SMOLLM_MAP_FULL, dtype=torch.int32, device=cuda)
    out = flash_prefill_attention(q, k, v, q_offset=off, window=win, qh2kv=m)
    _close(out, flash_prefill_ref(q, k, v, q_offset=off, window=win, qh2kv=m))


@pytest.mark.cuda
def test_model_kernel_path_matches_plain_path(cuda):
    """A reduced model's prefill and paged decode through the kernels vs
    the same forward with the plain versions, on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.transformer import (decode_step_paged, init_caches,
                                                init_params, decode_step)
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 200),
                         generator=torch.Generator().manual_seed(1)).to(cuda)

    def run():
        c = init_caches(cfg, 1, 200, device=cuda)
        for lo in range(0, 200, 64):
            lg, c = decode_step(params, toks[:, lo:lo + 64], c, cfg)
        kp = torch.zeros((cfg.n_layers, 5, 64, cfg.n_kv_heads, cfg.head_dim),
                         dtype=torch.bfloat16, device=cuda)
        vp = torch.zeros_like(kp)
        for p in range(4):
            n = min(64, 200 - 64 * p)
            kp[:, p + 1, :n] = c.kv.k[:, 0, 64 * p:64 * p + n]
            vp[:, p + 1, :n] = c.kv.v[:, 0, 64 * p:64 * p + n]
        tbl = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device=cuda)
        lens = torch.tensor([200], dtype=torch.int32, device=cuda)
        lg2, _, _ = decode_step_paged(params, toks[:, :1], kp, vp, tbl, lens,
                                      cfg)
        return torch.cat([lg[:, -1], lg2[:, -1]])

    kern = run()
    with plain_attention():
        plain = run()
    torch.cuda.synchronize()
    assert (kern - plain).abs().max().item() <= TOL * max(
        1.0, plain.abs().max().item())
