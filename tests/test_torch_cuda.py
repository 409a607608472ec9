"""The hand-written CUDA kernels against their plain PyTorch versions, on
the GPU. Every test here is marked ``cuda`` and skips without a GPU (a
CUDA kernel has no CPU mode); the file imports neither jax nor the
reference, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-2 in bf16 for attention (the reference's kernel tests);
for the SSD scan, whose kernel and plain version both compute in fp32
and differ only in summation order, 5e-3 (the reference's fp32 scan
tolerance, ``tests/test_kernels.py:155``) of the output's scale."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill.kernel import flash_prefill
from repro_torch.kernels.flash_prefill.ops import flash_prefill_attention
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_ref,
                                                   flash_prefill_split_ref)
from repro_torch.kernels.paged_attention.kernel import (paged_attention,
                                                        paged_attention_layers)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_layers)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_layers_ref, paged_attention_ref,
    paged_attention_splits_ref)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import (chunk_cb, chunk_scan,
                                              chunk_state, ssd_chunked,
                                              state_pass)

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
    (1, 256, 1536, 32, 32, 96, 1280, 0),   # phi3-mini's chunk (D = 96)
    (1, 131, 1411, 32, 32, 96, 1280, 0),   # its ragged tail
    (2, 128, 512, 8, 2, 96, 384, 128),     # D = 96, grouped, a window
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


def _paged_table(rng, lens, P, page, mp, dev):
    table = torch.zeros(len(lens), mp, dtype=torch.int32)
    for b, n in enumerate(lens):
        live = -(-n // page)
        table[b, :live] = torch.from_numpy(rng.choice(np.arange(1, P), live,
                                                      replace=False))
    return (table.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


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
    # ragged, boundaries, full
    table, lens = _paged_table(rng, [1, 64, 129, 300, 384], P, page, mp, cuda)
    m = None if qh2kv is None else torch.tensor(qh2kv, dtype=torch.int32,
                                                device=cuda)
    before = paged_attention.launches
    out = paged_decode_attention(q, kp, vp, table, lens, qh2kv=m,
                                 window=window)
    assert paged_attention.launches == before + 1
    _close(out, paged_attention_ref(q, kp, vp, table, lens, qh2kv=m,
                                    window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("qh2kv,KV,D,window", [(SMOLLM_MAP_FULL, 5, 64, 0),
                                              (None, 2, 128, 100)])
def test_paged_layers_kernel_matches_per_layer_and_plain(cuda, qh2kv, KV, D,
                                                         window):
    """One layers launch equals L per-layer launches exactly (the same
    kernel code runs each layer) and the plain version within 2e-2."""
    rng = np.random.default_rng(4)
    L, B, H, P, page, mp = 3, 5, 16, 40, 64, 6
    qs = _randn(rng, (L, B, H, D), cuda)
    kp = _randn(rng, (L, P, page, KV, D), cuda)
    vp = _randn(rng, (L, P, page, KV, D), cuda)
    kp[:, 0], vp[:, 0] = 1e4, -1e4
    table, lens = _paged_table(rng, [1, 64, 129, 300, 384], P, page, mp, cuda)
    m = None if qh2kv is None else torch.tensor(qh2kv, dtype=torch.int32,
                                                device=cuda)
    before = paged_attention_layers.launches
    out = paged_decode_attention_layers(qs, kp, vp, table, lens, qh2kv=m,
                                        window=window)
    assert paged_attention_layers.launches == before + 1
    per_layer = torch.stack([
        paged_decode_attention(qs[l], kp[l], vp[l], table, lens, qh2kv=m,
                               window=window) for l in range(L)])
    torch.cuda.synchronize()
    assert torch.equal(out, per_layer)
    _close(out, paged_attention_layers_ref(qs, kp, vp, table, lens, qh2kv=m,
                                           window=window))


def _paged_grouped_case(seed, B, H, KV, D, page, mp, lens, qh2kv, dev):
    """q, pages with a poisoned null page, a table of distinct live pages
    and the head map (the grouped map where ``qh2kv`` is None)."""
    rng = np.random.default_rng(seed)
    P = sum(-(-n // page) for n in lens) + 2
    q = _randn(rng, (B, H, D), dev)
    kp, vp = _randn(rng, (P, page, KV, D), dev), _randn(rng, (P, page, KV, D),
                                                        dev)
    kp[0], vp[0] = 1e4, -1e4
    table, lens_t = _paged_table(rng, lens, P, page, mp, dev)
    m = torch.tensor(qh2kv if qh2kv is not None else
                     [h // (H // KV) for h in range(H)], dtype=torch.int32,
                     device=dev)
    return q, kp, vp, table, lens_t, m


def _paged_checked(case, window=0, n_splits=None):
    """One kernel call, counted, against the plain version and the plain
    split decomposition with the kernel's split count."""
    q, kp, vp, table, lens, m = case
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, table, lens, m, window=window,
                          n_splits=n_splits)
    assert paged_attention.launches == before + 1
    ns = paged_attention.last_splits
    assert n_splits is None or ns == n_splits
    _close(out, paged_attention_ref(q, kp, vp, table, lens, qh2kv=m,
                                    window=window))
    _close(out, paged_attention_splits_ref(q, kp, vp, table, lens, qh2kv=m,
                                           window=window, n_splits=ns))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", [1, 2, 4, 8])
def test_paged_kernel_forced_splits(cuda, n_splits):
    """A 1-token slot beside a full-table slot: with 8 splits most blocks
    of the first slot's clusters hold no token and still merge."""
    case = _paged_grouped_case(n_splits, 5, 16, 5, 64, 64, 32,
                               [1, 2048, 64, 65, 700], SMOLLM_MAP_FULL, cuda)
    _paged_checked(case, n_splits=n_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D,page,qh2kv", [
    (16, 1, 128, 64, None),                     # one KV head, 16 query heads
    (32, 1, 64, 32, None),                      # two 16-row query tiles
    (8, 3, 64, 16, [0, 0, 0, 0, 2, 2, 2, 2]),   # KV head 1 unused
    (16, 2, 32, 16, SMOLLM_MAP_REDUCED),
])
def test_paged_kernel_head_groups_and_page_sizes(cuda, H, KV, D, page, qh2kv):
    case = _paged_grouped_case(H + KV, 4, H, KV, D, page, 1024 // page,
                               [1, 1024, 333, 64], qh2kv, cuda)
    _paged_checked(case)


@pytest.mark.cuda
@pytest.mark.parametrize("window,n_splits", [(100, 4), (300, 8), (1000, 2)])
def test_paged_kernel_window_inside_a_split(cuda, window, n_splits):
    case = _paged_grouped_case(window, 4, 16, 5, 64, 64, 32,
                               [2048, 1500, 90, 1], SMOLLM_MAP_FULL, cuda)
    _paged_checked(case, window=window, n_splits=n_splits)


@pytest.mark.cuda
def test_paged_kernel_is_deterministic(cuda):
    """The splits merge in a fixed order without atomics: two calls on the
    same inputs are bit-equal, and so is a layers call with the same
    forced split count on each layer."""
    q, kp, vp, table, lens, m = _paged_grouped_case(
        9, 8, 16, 5, 64, 64, 32, [1, 2048, 1536, 64, 65, 700, 1537, 333],
        SMOLLM_MAP_FULL, cuda)
    a = paged_attention(q, kp, vp, table, lens, m)
    b = paged_attention(q, kp, vp, table, lens, m)
    lay = paged_attention_layers(torch.stack([q, q]), torch.stack([kp, kp]),
                                 torch.stack([vp, vp]), table, lens, m,
                                 n_splits=paged_attention.last_splits)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(lay[0], a) and torch.equal(lay[1], a)


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits,qh2kv,H,KV", [(1, SMOLLM_MAP_FULL, 16, 5),
                                                (4, SMOLLM_MAP_FULL, 16, 5),
                                                (8, SMOLLM_MAP_FULL, 16, 5),
                                                (3, None, 32, 1)])
def test_paged_layers_equal_per_layer_with_forced_splits(cuda, n_splits,
                                                         qh2kv, H, KV):
    """A layers call with a forced split count gives every layer bit for
    bit what a per-layer call with that count gives, also at 32 query
    heads over one KV head (two 16-row query tiles, two merges a
    cluster)."""
    rng = np.random.default_rng(n_splits)
    L, B, P, page, mp = 5, 4, 60, 32, 16
    qs = _randn(rng, (L, B, H, 64), cuda)
    kp = _randn(rng, (L, P, page, KV, 64), cuda)
    vp = _randn(rng, (L, P, page, KV, 64), cuda)
    kp[:, 0], vp[:, 0] = 1e4, -1e4
    table, lens = _paged_table(rng, [1, 512, 200, 33], P, page, mp, cuda)
    m = torch.tensor(qh2kv if qh2kv is not None else [0] * H,
                     dtype=torch.int32, device=cuda)
    out = paged_attention_layers(qs, kp, vp, table, lens, m, window=300,
                                 n_splits=n_splits)
    assert paged_attention_layers.last_splits == n_splits
    per_layer = torch.stack([
        paged_attention(qs[l], kp[l], vp[l], table, lens, m, window=300,
                        n_splits=n_splits) for l in range(L)])
    torch.cuda.synchronize()
    assert torch.equal(out, per_layer)
    _close(out, paged_attention_layers_ref(qs, kp, vp, table, lens, qh2kv=m,
                                           window=300))


def _ssd_inputs(rng, b, s, h, p, n, with_h0, dev):
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    x, B, C = f(b, s, h, p).bfloat16(), f(b, s, n).bfloat16(), \
        f(b, s, n).bfloat16()
    dt = torch.nn.functional.softplus(f(b, s, h))
    A = -torch.exp(0.5 * f(h))
    h0 = f(b, h, p, n) if with_h0 else None
    return x, dt, A, B, C, h0


def _ssd_close(out, ref):
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        tol = 5e-3 * max(1.0, r.abs().max().item())
        err = (o - r).abs().max().item()
        assert torch.isfinite(o).all() and err <= tol, (err, tol)


SSD_CUDA_CASES = [  # b, s, h, p, n, chunk, with_h0
    (1, 512, 4, 64, 128, 256, True),     # the serving call's per-head shape
    (2, 96, 3, 16, 16, 96, True),        # a ragged chunk (not a power of 2)
    (1, 130, 2, 64, 128, 65, False),     # ragged tiles, two chunks
    (2, 64, 5, 16, 128, 32, False),
    (1, 256, 32, 16, 16, 32, True),      # mamba2-2.7b.reduced()'s mixer
    (1, 40, 2, 24, 64, 40, True),        # p not a multiple of 16
    (1, 512, 8, 64, 64, 256, True),      # jamba-1.5's mixer per head (n 64)
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CUDA_CASES)
def test_ssd_kernel_matches_plain(cuda, case):
    b, s, h, p, n, chunk, with_h0 = case
    x, dt, A, B, C, h0 = _ssd_inputs(np.random.default_rng(s + n), b, s, h, p,
                                     n, with_h0, cuda)
    before = ssd_scan.launches
    out = ssd_scan_op(x, dt, A, B, C, h0, chunk=chunk)
    assert ssd_scan.launches == before + 1
    _ssd_close(out, ssd_chunked(x, dt, A, B, C, chunk, h0=h0))


@pytest.mark.cuda
def test_ssd_kernel_zero_dt_padding_keeps_the_state(cuda):
    """Positions padded with dt = 0 (as ``mamba_block`` pads a ragged
    sequence) leave the state exactly where the real positions left it."""
    x, dt, A, B, C, h0 = _ssd_inputs(np.random.default_rng(9), 1, 64, 4, 64,
                                     128, True, cuda)
    dt[:, 40:] = 0
    _, h_pad = ssd_scan(x, dt, A, B, C, h0, chunk=64)
    _, h_cut = ssd_scan(x[:, :40].contiguous(), dt[:, :40].contiguous(), A,
                        B[:, :40].contiguous(), C[:, :40].contiguous(), h0,
                        chunk=40)
    _ssd_close((h_pad,), (h_cut,))


@pytest.mark.cuda
def test_ssd_kernel_refuses_a_ragged_sequence(cuda):
    x, dt, A, B, C, _ = _ssd_inputs(np.random.default_rng(0), 1, 100, 2, 16,
                                    16, False, cuda)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(x, dt, A, B, C, chunk=64)


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
    _kernel_path_vs_plain_path(get_config("smollm-360m").reduced(), cuda)


@pytest.mark.cuda
def test_phi3_head_dim_96_kernel_path_matches_plain_path(cuda):
    """phi3-mini-3.8b.reduced() at its own head_dim 96: prefill chunks and
    a paged decode step through both kernels vs the plain versions."""
    import dataclasses

    from repro_torch.configs.base import get_config
    full = get_config("phi3-mini-3.8b")
    assert full.head_dim == 96
    cfg = dataclasses.replace(full.reduced(), head_dim=full.head_dim)
    before = paged_attention.launches, flash_prefill.launches
    _kernel_path_vs_plain_path(cfg, cuda)
    # 4 chunks of 64 and one paged step, per layer
    assert (paged_attention.launches - before[0],
            flash_prefill.launches - before[1]) == (cfg.n_layers,
                                                    4 * cfg.n_layers)


def _kernel_path_vs_plain_path(cfg, cuda):
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.transformer import (decode_step_paged, init_caches,
                                                init_params, decode_step)
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


@pytest.mark.cuda
def test_mamba_kernel_path_matches_plain_path(cuda):
    """mamba2-2.7b.reduced(): prefill, a ragged extend and decode steps
    through the SSD kernel vs the same forward forced plain, on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan as kernel
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)
    cfg = get_config("mamba2-2.7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 200),
                         generator=torch.Generator().manual_seed(1)).to(cuda)

    def run():
        lg0, c = prefill(params, toks[:, :128], cfg)
        lg1, c = decode_step(params, toks[:, 128:197], c, cfg)
        rows = [lg0, lg1[:, -1]]
        for i in range(197, 200):
            lg, c = decode_step(params, toks[:, i:i + 1], c, cfg)
            rows.append(lg[:, -1])
        return torch.cat(rows)

    before = kernel.launches
    kern = run()
    assert kernel.launches == before + 2 * cfg.n_layers
    with plain_attention():
        plain = run()
    assert kernel.launches == before + 2 * cfg.n_layers
    torch.cuda.synchronize()
    assert (kern - plain).abs().max().item() <= TOL * max(
        1.0, plain.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [2.0, 1.25])
def test_moe_block_on_the_card_matches_the_cpu(cuda, capacity_factor):
    """qwen3-moe-235b-a22b.reduced()'s moe_block on the card against the
    same call on the CPU (reduced: capacity factor 2.0, drop-free; 1.25:
    an expert overflows). Every row dispatched to the same experts on
    both, except rows whose CPU router logits leave no more than one
    bf16 ulp between the k-th and the (k+1)-th expert (and rows an
    upstream flip pushed past the capacity); y within 2e-2 on the rows
    dispatched alike."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import (dispatched_experts, moe_block,
                                           record_routing, rms_norm)
    from repro_torch.models.transformer import init_params
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    p = {k: t[0] for k, t in init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")["moe"].items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 128, cfg.d_model)).astype(
        np.float32))
    r0 = p["router"][:, 0].float()
    x = (x + 0.5 * r0 / r0.norm() * cfg.d_model ** 0.5).bfloat16()  # → e0
    with record_routing() as r_cpu:
        y_cpu, aux_cpu = moe_block(x, p, cfg)
    with record_routing() as r_gpu:
        y_gpu, aux_gpu = moe_block(x.to(cuda), {k: t.to(cuda)
                                                for k, t in p.items()}, cfg)
    torch.cuda.synchronize()
    d_cpu = dispatched_experts(cfg, r_cpu[0])
    d_gpu = dispatched_experts(cfg, r_gpu[0].cpu())
    k = cfg.moe.top_k
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(-1, cfg.d_model)
    lg = torch.sort((h @ p["router"]).float(), dim=-1).values
    kth, nxt = lg[:, -k], lg[:, -k - 1]
    ulp = 2.0 ** (torch.floor(torch.log2(kth.abs().clamp(min=1e-30))) - 7)
    near = (kth - nxt) <= ulp
    same = (d_cpu == d_gpu).all(-1)
    assert bool((d_cpu == -1).any()) == (capacity_factor < 2.0)
    if bool(near.any()):
        # a flip may move later rows past the capacity
        first = int(near.nonzero()[0])
        assert bool(same[:first].all())
    else:
        assert bool(same.all())
        assert abs(float(aux_gpu) - float(aux_cpu)) <= 2e-5 * max(
            1.0, abs(float(aux_cpu)))
    keep = same.reshape(x.shape[:2])
    assert keep.float().mean() > 0.9
    np.testing.assert_allclose(y_gpu.float().cpu()[keep].numpy(),
                               y_cpu.float()[keep].numpy(), atol=TOL,
                               rtol=TOL)


# B, Sq, Sk, H, KV, D, offset, window, forced key splits
FLASH_SPLIT_CASES = [
    (1, 256, 256, 4, 2, 64, 0, 0, 5),      # q_offset 0: splits empty for
    (2, 256, 256, 4, 2, 64, 0, 0, 2),      # the early query tiles
    (1, 1, 300, 4, 2, 64, 299, 0, 3),      # Sq = 1
    (1, 131, 1411, 16, 5, 64, 1280, 0, 6),  # the ragged last serving chunk
    (1, 64, 320, 4, 1, 32, 256, 0, 4),     # D = 32 (64-byte swizzle)
    (1, 128, 384, 8, 2, 128, 256, 0, 3),   # D = 128 (two TMA boxes a row)
    (1, 256, 1024, 4, 2, 64, 768, 200, 4),  # a window starting in a split
    (1, 256, 1536, 32, 32, 96, 0, 0, 5),   # D = 96 (three 32-column panels)
    (1, 131, 1411, 32, 32, 96, 1280, 0, 6),
    (1, 256, 1024, 8, 2, 96, 768, 200, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_SPLIT_CASES)
def test_prefill_kernel_split_over_keys(cuda, case):
    """The split pass and its log-sum-exp combine against the plain
    version and the plain split decomposition, with rows that see no key
    of some split; keys past the chunk are poisoned and never read."""
    B, Sq, Sk, H, KV, D, off, win, ns = case
    rng = np.random.default_rng(Sq + Sk)
    q = _randn(rng, (B, Sq, H, D), cuda)
    k, v = _randn(rng, (B, Sk, KV, D), cuda), _randn(rng, (B, Sk, KV, D), cuda)
    k[:, off + Sq:], v[:, off + Sq:] = 1e4, -1e4
    m = torch.tensor(SMOLLM_MAP_FULL if (H, KV) == (16, 5) else
                     [h // (H // KV) for h in range(H)], dtype=torch.int32,
                     device=cuda)
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, m, q_offset=off, window=win, n_splits=ns)
    assert flash_prefill.launches == before + 1
    assert flash_prefill.last_splits == ns
    _close(out, flash_prefill_ref(q, k, v, q_offset=off, window=win, qh2kv=m))
    _close(out, flash_prefill_split_ref(q, k, v, q_offset=off, window=win,
                                        qh2kv=m, n_splits=ns))


@pytest.mark.cuda
def test_prefill_kernel_chooses_splits_from_the_card(cuda):
    """At the serving chunk (64 blocks) the wrapper splits the keys so that
    at least two blocks per SM are live, and still matches."""
    from repro_torch.kernels.flash_prefill.kernel import choose_splits
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 256, 16, 64), cuda)
    k, v = _randn(rng, (1, 1536, 5, 64), cuda), _randn(rng, (1, 1536, 5, 64),
                                                      cuda)
    m = torch.tensor(SMOLLM_MAP_FULL, dtype=torch.int32, device=cuda)
    out = flash_prefill(q, k, v, m, q_offset=1280)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert flash_prefill.last_splits == choose_splits(64, 24, sms) > 1
    _close(out, flash_prefill_ref(q, k, v, q_offset=1280, qh2kv=m))


def _conv_views(rng, b, s, h, p, n, dev):
    """x, B and C as ``mamba_block`` hands them over: views into one
    (b, s, h·p + 2n) buffer, not contiguous."""
    buf = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n)).astype(np.float32)).to(dev).bfloat16()
    x = buf[..., :h * p].reshape(b, s, h, p)
    return x, buf[..., h * p:h * p + n], buf[..., h * p + n:]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 17, 65, 200, 256])
def test_ssd_kernel_chunk_lengths_strided_views(cuda, chunk):
    """Chunk lengths that are not multiples of a tile, b = 2, no h0, and
    x, B, C read in place through their strides (no copies)."""
    rng = np.random.default_rng(chunk)
    b, h, p, n = 2, 3, 64, 128
    s = chunk * (2 if chunk > 1 else 5)
    x, B, C = _conv_views(rng, b, s, h, p, n, cuda)
    assert not x.is_contiguous() and not B.is_contiguous()
    _, dt, A, _, _, _ = _ssd_inputs(rng, b, s, h, p, n, False, cuda)
    out = ssd_scan_op(x, dt, A, B, C, chunk=chunk)
    _ssd_close(out, ssd_chunked(x, dt, A, B, C, chunk))
    direct = ssd_scan(x, dt, A, B, C, chunk=chunk)   # the views as they are
    _ssd_close(direct, out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 512, 4, 64, 128, 256, True),
                                  (2, 130, 3, 24, 16, 65, True),
                                  (1, 512, 8, 64, 64, 256, True)])
def test_ssd_kernel_passes_match_the_plain_passes(cuda, case):
    """Each of the four passes' outputs against its plain pass on the same
    inputs: C·Bᵀ (lower triangle), cum and S_c, h_in, then y and hT."""
    b, s, h, p, n, chunk, with_h0 = case
    x, dt, A, B, C, h0 = _ssd_inputs(np.random.default_rng(s), b, s, h, p, n,
                                     with_h0, cuda)
    y, hT, got = ssd_scan(x, dt, A, B, C, h0, chunk=chunk, passes=True)
    cb = chunk_cb(B, C, chunk)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=cuda))
    cum, states = chunk_state(x, dt, A, B, chunk)
    h_in, h_T = state_pass(states, cum, h0)
    torch.cuda.synchronize()
    # only cb's lower triangle is written: select it (the unwritten
    # upper triangle may hold a NaN, and NaN x 0 is NaN)
    _ssd_close((torch.where(tri, got["cb"], 0.0),),
               (torch.where(tri, cb, 0.0),))
    _ssd_close((got["cum"], got["states"]), (cum, states))
    _ssd_close((got["h_in"],), (h_in,))
    _ssd_close((y, hT), (chunk_scan(x, dt, C, cb, cum, h_in), h_T))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_tiered_prefill_sets_the_store_bytes_into_the_arena(cuda, tmp_path,
                                                           mode):
    """The tiered PrefillWorker on the card: a DRAM tier of one block over
    a file-backed SSD tier. The revisit's prefix comes off disk (and off
    DRAM), the bytes it sets into the cache arena equal the bytes the
    pool held for each block, bit for bit, and the whole prefill equals a
    flat-pool run's; every prefill chunk ran the prefill kernel."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import (HostKVPool, PrefillWorker,
                                            prefix_hash_ids)
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(42)
    doc = rng.integers(0, cfg.vocab_size, 1024)
    q1 = np.concatenate([doc, rng.integers(0, cfg.vocab_size, 48)])
    q2 = np.concatenate([doc, rng.integers(0, cfg.vocab_size, 48)])
    flat_pool = HostKVPool()
    flat = PrefillWorker(params, cfg, flat_pool, prefill_chunk=128)
    flat(q1)
    want = flat(q2)
    flat_pool.close()

    pool = HostKVPool(capacity_blocks=1, ssd_capacity_blocks=32,
                      ssd_dir=str(tmp_path), writeback_batch=1)
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=128, ssd_mode=mode)
    pw(q1)
    pool.store.flush()
    ids = prefix_hash_ids(q2)
    assert ids[0] in pool.store.keys()     # the head block sits on disk
    held = {h: pool.data[h] if h in pool.data else pool.store.read_block(h)
            for h in ids}
    chunks0, launches0 = pw.counters["chunks"], flash_prefill.launches
    pres = pw(q2)
    torch.cuda.synchronize()
    assert pres.reused_blocks == 2 and pres.overlapped == (mode == "overlap")
    if mode == "overlap":
        assert pres.ssd_blocks >= 1
    for i, h in enumerate(ids):
        sl = slice(i * 512, (i + 1) * 512)
        assert torch.equal(pres.kv_k[:, sl].view(torch.int16),
                           held[h][0].view(torch.int16))
        assert torch.equal(pres.kv_v[:, sl].view(torch.int16),
                           held[h][1].view(torch.int16))
    assert torch.equal(pres.kv_k.view(torch.int16),
                       want.kv_k.view(torch.int16))
    assert pres.first_token == want.first_token
    assert flash_prefill.launches - launches0 == \
        cfg.n_layers * (pw.counters["chunks"] - chunks0)
    assert pool.store.read_failures == 0
    pool.close()


# ---------------------------------------------------------------------------
# head_dim 96 (phi3-mini-3.8b): three 32-column panels in the prefill
# kernel, 12-chunk rows in the paged kernel
# ---------------------------------------------------------------------------

PHI3_LENS = [1536, 1, 1536, 436, 1536, 65, 428, 1536]  # + a 1- and 65-token slot


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,window,n_splits", [
    (32, 32, 0, None),        # phi3-mini's decode: MHA, 32 over 32
    (32, 32, 0, 1),
    (32, 32, 0, 2),
    (32, 32, 0, 4),
    (32, 32, 0, 8),
    (16, 4, 0, None),         # grouped, 4 query heads a KV head
    (16, 4, 300, 4),          # a window inside a split
    (32, 32, 1000, 2),
])
def test_paged_kernel_head_dim_96(cuda, H, KV, window, n_splits):
    case = _paged_grouped_case(H + KV + window, 8, H, KV, 96, 64, 24,
                               PHI3_LENS, None, cuda)
    _paged_checked(case, window=window, n_splits=n_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits,window", [(None, 0), (4, 300)])
def test_paged_layers_head_dim_96_equal_per_layer(cuda, n_splits, window):
    """The layers entry at head_dim 96: every layer bit for bit the
    per-layer call with the same split count, and the plain version
    within 2e-2."""
    rng = np.random.default_rng(96 + window)
    L, B, H, KV, D, P, page, mp = 4, 4, 32, 32, 96, 40, 64, 8
    qs = _randn(rng, (L, B, H, D), cuda)
    kp = _randn(rng, (L, P, page, KV, D), cuda)
    vp = _randn(rng, (L, P, page, KV, D), cuda)
    kp[:, 0], vp[:, 0] = 1e4, -1e4
    table, lens = _paged_table(rng, [1, 512, 436, 65], P, page, mp, cuda)
    m = torch.arange(H, dtype=torch.int32, device=cuda)
    out = paged_attention_layers(qs, kp, vp, table, lens, m, window=window,
                                 n_splits=n_splits)
    ns = paged_attention_layers.last_splits
    per_layer = torch.stack([
        paged_attention(qs[l], kp[l], vp[l], table, lens, m, window=window,
                        n_splits=ns) for l in range(L)])
    torch.cuda.synchronize()
    assert torch.equal(out, per_layer)
    _close(out, paged_attention_layers_ref(qs, kp, vp, table, lens, qh2kv=m,
                                           window=window))


@pytest.mark.cuda
def test_other_head_dims_are_refused_on_the_card(cuda):
    """A head_dim outside (32, 64, 96, 128) raises on CUDA tensors in both
    kernels' entry points (no fallback to the plain versions) and
    launches nothing."""
    rng = np.random.default_rng(0)
    q = _randn(rng, (1, 64, 4, 80), cuda)
    k = _randn(rng, (1, 64, 4, 80), cuda)
    before = paged_attention.launches, flash_prefill.launches
    with pytest.raises(ValueError, match="head_dim 80"):
        flash_prefill_attention(q, k, k)
    pages = _randn(rng, (3, 64, 4, 80), cuda)
    tbl, lens = _paged_table(rng, [10], 3, 64, 1, cuda)
    with pytest.raises(ValueError, match="head_dim 80"):
        paged_decode_attention(q[:, 0], pages, pages, tbl, lens)
    assert (paged_attention.launches, flash_prefill.launches) == before


# ---------------------------------------------------------------------------
# the multi-device serving paths, every mesh position on the one card
# ---------------------------------------------------------------------------

def _card_mesh(cuda, shape, axes):
    from repro_torch.launch.mesh import Mesh
    n = int(np.prod(shape))
    return Mesh(np.asarray([cuda] * n, dtype=object).reshape(shape), axes)


@pytest.mark.cuda
@pytest.mark.parametrize("dm", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_op_on_the_card_is_the_unsharded_kernel(cuda, dm):
    """Every shard runs the kernel on its rows and head stripe: with the
    unsharded call's split count pinned the result is bitwise the
    unsharded kernel's, and within 2e-2 of the plain version."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention_sharded)
    rng = np.random.default_rng(4)
    B, H, KV, D, page, maxp = 8, 64, 8, 128, 64, 16
    P = B * maxp + 1
    q = _randn(rng, (B, H, D), cuda)
    kp = _randn(rng, (P, page, KV, D), cuda)
    vp = _randn(rng, (P, page, KV, D), cuda)
    tbl = torch.from_numpy(1 + rng.permutation(P - 1)[:B * maxp].reshape(
        B, maxp).astype(np.int32)).to(cuda)
    lens = torch.tensor([1, 1024, 700, 65, 333, 1000, 64, 513],
                        dtype=torch.int32, device=cuda)
    whole = paged_decode_attention(q, kp, vp, tbl, lens)
    splits = paged_attention.last_splits
    before = paged_attention.launches
    got = paged_decode_attention_sharded(q, kp, vp, tbl, lens,
                                         mesh=_card_mesh(cuda, dm,
                                                         ("data", "model")),
                                         n_splits=splits)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + dm[0] * dm[1]
    assert torch.equal(got, whole)
    _close(got, paged_attention_ref(q, kp, vp, tbl, lens))


@pytest.mark.cuda
def test_mesh_engine_on_the_card(cuda):
    """Prefill, the banked pool and the sharded decode step over meshes
    (1,1), (2,1), (1,2), (2,2) on the card: every stream the unmeshed
    run's, the pool leak-free, the kernel launched once per position per
    layer per step."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                            PrefillWorker)
    from repro_torch.serving.paged_cache import DevicePagePool
    from repro_torch.serving.request import ServingRequest
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_heads=16, n_kv_heads=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(7)
    common = rng.integers(0, cfg.vocab_size, 512)
    prompts = [np.concatenate([common, rng.integers(0, cfg.vocab_size,
                                                    88 + 37 * r)])
               for r in range(3)]

    def run(dm):
        mesh = None if dm is None else _card_mesh(cuda, dm,
                                                  ("data", "model"))
        pp = DevicePagePool(cfg, n_pages=64, mesh=mesh, device=cuda)
        pool = HostKVPool()
        pw = PrefillWorker(params, cfg, pool, prefill_chunk=256,
                           page_pool=pp)
        dw = DecodeWorker(params, cfg, max_batch=4, max_len=1024,
                          page_pool=pp)
        press = [pw(t) for t in prompts]
        outs = {}
        for rid, i in [(2, 2), (3, 2), (0, 0), (1, 1)]:
            dw.join(ServingRequest(req_id=rid, tokens=None, max_new=6),
                    press[i])
            outs[rid] = [press[i].first_token]
        before = paged_attention.launches
        while dw.n_active:
            for rid, tok, _ in dw.step():
                outs[rid].append(tok)
        n = 1 if dm is None else dm[0] * dm[1]
        assert paged_attention.launches - before \
            == n * cfg.n_layers * dw.counters["steps"]
        assert pp.stats()["cow_copies"] >= 1
        pp.check_leaks()
        pool.close()
        return outs

    base = run(None)
    for dm in [(1, 1), (2, 1), (1, 2), (2, 2)]:
        assert run(dm) == base, dm


@pytest.mark.cuda
def test_cpp_on_the_card(cuda):
    """CPP over 4 stages on the card: one chunked-prefill launch per
    (layer, chunk), logits within 4 bf16 ulps of the full prefill's and
    KV within 2e-2 of its scale."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.cpp import cpp_prefill, cpp_reference
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 256),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    before = flash_prefill.launches
    lc, (kc, vc) = cpp_prefill(params, toks, cfg,
                               _card_mesh(cuda, (4,), ("stage",)),
                               prefill_chunk=64)
    assert flash_prefill.launches - before == cfg.n_layers * 4
    lr, (kr, vr) = cpp_reference(params, toks, cfg)
    torch.cuda.synchronize()
    scale = lr.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (lc - lr).abs().max().item() <= 4 * ulp
    for got, ref in ((torch.cat(kc), kr), (torch.cat(vc), vr)):
        assert (got.float() - ref.float()).abs().max().item() \
            <= TOL * ref.abs().max().item()


def _launch_counts():
    return (paged_attention.launches, paged_attention_layers.launches,
            flash_prefill.launches, ssd_scan.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-360m", "jamba-1.5-large-398b"])
def test_train_step_launches_no_kernel(cuda, name):
    """A train step on the card (forward, backward, update) runs the
    differentiable plain attention and SSD scan: no kernel's launch count
    moves, while a prefill of the same weights does launch (the counts
    are live), and the step's loss is finite and its params move."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.training import make_optimizer
    from repro_torch.training.loop import batch_to
    from repro_torch.training.optim import tree_leaves
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 2, 128)).batch(0), cuda)
    init, _ = make_optimizer(cfg.optimizer)
    before = _launch_counts()
    loss, new, _ = make_train_step(cfg)(params, init(params), batch)
    torch.cuda.synchronize()
    assert _launch_counts() == before
    assert torch.isfinite(loss)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                     tree_leaves(new)))
    prefill(params, batch["tokens"], cfg)
    torch.cuda.synchronize()
    assert _launch_counts() != before


@pytest.mark.cuda
def test_kernel_ops_refuse_autograd_on_the_card(cuda):
    """An input that requires grad, with grad mode on, raises before the
    kernel launches; under ``torch.no_grad()`` the kernel runs."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 64, generator=g).bfloat16().to(cuda)
    k = torch.randn(1, 64, 2, 64, generator=g).bfloat16().to(cuda)
    v = torch.randn(1, 64, 2, 64, generator=g).bfloat16().to(cuda)
    q.requires_grad_(True)
    before = flash_prefill.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_prefill_attention(q, k, v)
    assert flash_prefill.launches == before
    with torch.no_grad():
        flash_prefill_attention(q, k, v)
    assert flash_prefill.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,grouped", [("smollm-360m", False),
                                          ("llama2-70b", True),
                                          ("qwen3-moe-235b-a22b", False)])
def test_sharded_prefill_on_the_card(cuda, name, grouped):
    """``make_prefill_step`` on a (2, 2) mesh of the card: one
    chunked-prefill launch per (position, layer), each on its position's
    stripe of the query heads under a local map, and the logits within
    4 bf16 ulps of the largest of the plain path's on the same mesh,
    under the plain run's MoE routing (KV within 2e-2 of its scale)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.shardings import gather, shard_params
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import (Dist, plain_attention,
                                           record_routing, replay_routing)
    from repro_torch.models.transformer import init_params
    cfg = get_config(name).reduced()
    if grouped:         # 16 query heads over 4 KV: each stripe grouped
        cfg = dataclasses.replace(cfg, n_heads=16, n_kv_heads=4)
    mesh = _card_mesh(cuda, (2, 2), ("data", "model"))
    params = shard_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), cuda), mesh)
    toks = torch.randint(0, cfg.vocab_size, (2, 256),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    step = make_prefill_step(cfg, Dist(mesh=mesh, batch_axes=("data",)))
    with plain_attention(), record_routing() as routes:
        lp, cp = step(params, toks, {})
    before = flash_prefill.launches
    with replay_routing(routes):        # the MoE layers routed alike
        lk, ck = step(params, toks, {})
    torch.cuda.synchronize()
    assert flash_prefill.launches - before == 4 * cfg.n_layers
    scale = lp.abs().max().item()
    assert torch.isfinite(lk).all()
    assert (lk - lp).abs().max().item() \
        <= 4 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    for got, ref in ((ck.kv.k, cp.kv.k), (ck.kv.v, cp.kv.v)):
        got, ref = gather(got, cuda), gather(ref, cuda)   # the stripes
        assert (got.float() - ref.float()).abs().max().item() \
            <= TOL * ref.float().abs().max().item()


@pytest.mark.cuda
def test_sharded_train_step_launches_no_kernel(cuda):
    """A sharded train step on a (2, 2) mesh of the card: no kernel
    launched, the loss finite and within 2e-2 of the unsharded step's."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, batch_spec_for
    from repro_torch.launch.shardings import shard_params
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.layers import Dist
    from repro_torch.models.transformer import init_params
    from repro_torch.training import make_optimizer
    from repro_torch.training.loop import batch_to
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    mesh = _card_mesh(cuda, (2, 2), ("data", "model"))
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    sharded = shard_params(cfg, params, mesh)
    batch = batch_to(SyntheticLM(batch_spec_for(cfg, 2, 128)).batch(0), cuda)
    init, _ = make_optimizer(cfg.optimizer)
    before = _launch_counts()
    loss, _, _ = make_train_step(cfg, Dist(mesh=mesh, batch_axes=("data",)))(
        sharded, init(sharded), batch)
    loss0, _, _ = make_train_step(cfg)(params, init(params), batch)
    torch.cuda.synchronize()
    assert _launch_counts() == before
    assert torch.isfinite(loss)
    assert abs(float(loss) - float(loss0)) <= 2e-2 * abs(float(loss0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_tensor_parallel_mixer_on_the_card(cuda, name):
    """``mamba_block`` on a (2, 2) mesh of the card at reduced width: one
    SSD-scan kernel launch per (row, position), each on its position's
    nh / 2 heads as they come out of the column gather, y within 4 bf16
    ulps of the plain path's on the same mesh and the new SSM state
    within 5e-3 of its scale."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.shardings import gather, shard_params
    from repro_torch.models.layers import Dist, plain_attention
    from repro_torch.models.mamba import mamba_block
    from repro_torch.models.transformer import init_params
    cfg = get_config(name).reduced()
    mesh = _card_mesh(cuda, (2, 2), ("data", "model"))
    params = shard_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), cuda), mesh)
    lead = 2 if cfg.attn_every else 1
    p = {k: v[0][0] if lead == 2 else v[0]
         for k, v in params["mamba"].items()}
    x = torch.randn((4, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(
        cuda, torch.bfloat16)
    dist = Dist(mesh=mesh, batch_axes=("data",))
    with plain_attention():
        yp, sp = mamba_block(x, p, cfg, dist, return_state=True)
    before = ssd_scan.launches
    yk, sk = mamba_block(x, p, cfg, dist, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches - before == 4
    scale = yp.float().abs().max().item()
    assert torch.isfinite(yk.float()).all()
    assert (yk.float() - yp.float()).abs().max().item() \
        <= 4 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    a, b = gather(sk.ssm, cuda), gather(sp.ssm, cuda)
    assert (a - b).abs().max().item() <= 5e-3 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True])
def test_context_parallel_decode_on_the_card(cuda, ring):
    """``make_serve_step`` on a (1, 2) mesh of the card (the KV sequence
    in two stripes, attended by plain PyTorch per stripe) against the
    unsharded ``decode_step``'s plain path from the same caches, 8 steps
    fed the unsharded stream and routing: logits within 4 bf16 ulps of
    the largest at every step. ``ring``: a windowed config's ring
    (mixtral.reduced()'s 64 slots, wrapped)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shardings import shard_caches, shard_params
    from repro_torch.launch.steps import (INPUT_SHAPES, cache_specs,
                                          make_dist, make_serve_step)
    from repro_torch.models.layers import (NO_DIST, plain_attention,
                                           record_routing, replay_routing)
    from repro_torch.models.transformer import init_caches, init_params
    name = "mixtral-8x7b" if ring else "llama2-70b"
    cfg = get_config(name).reduced()
    mesh = Mesh(np.asarray([[cuda, cuda]], dtype=object), ("data", "model"))
    shape = dataclasses.replace(INPUT_SHAPES["long_500k" if ring else
                                             "decode_32k"],
                                batch=1 if ring else 4, seq=4096)
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    caches = init_caches(cfg, shape.batch, shape.seq,
                         window=cfg.sliding_window, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    for t in caches.kv:
        t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    caches = caches._replace(length=1000 if ring else 4000)
    dist = make_dist(mesh, shape)
    sc = shard_caches(cfg, caches, cache_specs(cfg, shape, dist), mesh)
    sp = shard_params(cfg, params, mesh)
    step, whole = (make_serve_step(cfg, d, shape) for d in (dist, NO_DIST))
    tok = torch.zeros((shape.batch, 1), dtype=torch.int32, device=cuda)
    for _ in range(8):
        with record_routing() as routes, plain_attention():
            lw, caches = whole(params, tok, caches)
        with replay_routing(routes):
            lm, sc = step(sp, tok, sc)
        scale = lw.abs().max().item()
        assert torch.isfinite(lm).all()
        assert (lm - lw).abs().max().item() \
            <= 4 * 2.0 ** (np.floor(np.log2(scale)) - 7)
        tok = lw.argmax(-1).to(torch.int32)


@pytest.mark.cuda
def test_dry_run_predicts_the_arguments_on_the_card(cuda):
    """The dry run's argument bytes of smollm-360m.reduced()'s prefill on
    a 1x1 mesh (stand-in positions, host only) equal the bytes of the
    tensors the step receives on the card, and the step's peak is at
    least those; the dry run imports no jax (this machine has none)."""
    import sys

    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.launch.mesh import Mesh, make_standin_mesh
    from repro_torch.launch.shardings import shard_params
    from repro_torch.launch.steps import (ShapeSpec, make_dist,
                                          make_prefill_step)
    from repro_torch.models.transformer import init_params
    assert "jax" not in sys.modules
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeSpec("prefill", "prefill", 256, 2)
    rec = dry_run(cfg, shape, make_standin_mesh((1, 1), ("data", "model")))
    mesh = Mesh(np.asarray([[cuda]], dtype=object), ("data", "model"))
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    sp = shard_params(cfg, params, mesh)
    del params
    tok = torch.zeros((2, 256), dtype=torch.int32, device=cuda)
    got = tok.nbytes + sum(t.nbytes for leaf in sp.values()
                           for t in (leaf.shards.values()
                                     if hasattr(leaf, "shards") else
                                     (x for v in leaf.values()
                                      for x in v.shards.values())))
    assert got == rec["memory"]["argument_bytes_total"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, _ = make_prefill_step(cfg, make_dist(mesh, shape))(sp, tok, {})
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert torch.cuda.max_memory_allocated() >= got
    assert "jax" not in sys.modules


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-14b"])
def test_decode_graphs_serve_the_eager_tokens(cuda, arch, record_property):
    """The paged decode step replayed as CUDA graphs against the eager
    step, at the benchmark cells' published widths cut to 3 layers:
    ``test_torch_decode_graphs.scenario`` (over 80 steps: joins mid-run,
    slots that finish, a shared tail page copied on write, an idle slot,
    the table width from 2 to 4 to 8 pages) serves the same tokens, with
    one capture per width met and a replay for every other step. The
    logits are bit for bit the eager step's; were cuBLAS to choose
    another algorithm under capture, they would be held within 1e-2, and
    ``logit_gap`` says which held."""
    import dataclasses

    from test_torch_decode_graphs import check_scenario, scenario

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config(arch), n_layers=3)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    eager = scenario(cfg, params, cuda)
    launches = paged_attention.launches
    graphed = scenario(cfg, params, cuda, graphs=lambda dw: dw)
    assert paged_attention.launches - launches \
        == cfg.n_layers * graphed["counters"]["steps"]
    gap = check_scenario(eager, graphed, logit_tol=1e-2)
    record_property("logit_gap", gap)
    print(f"{arch}: graphed logits "
          + ("bit for bit the eager step's" if gap == 0.0
             else f"within {gap:.3g} of the eager step's"))
