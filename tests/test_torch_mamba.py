"""The port's Mamba2 (SSM) slice against the reference: the plain SSD scan
(what a CPU tensor takes) against the reference's ``ssd_chunked``, its
per-token oracle and the Pallas kernel in interpret mode; the causal conv;
``mamba_block`` in its prefill, extend and decode branches; prefill plus
teacher-forced decode of ``mamba2-2.7b.reduced()``; and
``StateCheckpointWorker`` (first tokens, counters, checkpoints, a
reference checkpoint restored in the port, eviction). Inputs come from
numpy seeds and go to both packages; weights cross through
``bridge.params_from_jax``.

Tolerances are the reference's own: 5e-3 with fp32 inputs
(``tests/test_kernels.py:155``), 0.1 with bf16 inputs
(``tests/test_kernels.py:134``), and logits within 2e-2 of the logit
scale plus the greedy rule of ``tests/test_torch_model.py`` (tokens equal
wherever the reference's top-1/top-2 gap exceeds 4e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as JM
import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_kernel
from repro.kernels.ssd_scan.ref import ssd_naive_ref as jax_naive
from repro.models.layers import NO_DIST
from repro.serving.engine import StateCheckpointWorker as JWorker
import repro_torch.models.transformer as TT
from repro_torch.bridge import (params_from_jax, state_from_numpy,
                                state_to_numpy, tensor_from_numpy,
                                tensor_to_numpy)
from repro_torch.configs.base import get_config
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_naive_ref
from repro_torch.models.mamba import MambaState, _causal_conv, mamba_block
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillWorker, StateCheckpointWorker)

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

F32_TOL = 5e-3
BF16_TOL = 0.1
LOGIT_TOL = 2e-2
GAP = 4e-2
ARCH = "mamba2-2.7b"


def _close(port, ref, tol):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _ssd_inputs(b, s, h, p, n, with_h0, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, B, C = f(b, s, h, p), f(b, s, n), f(b, s, n)
    if dtype == "bf16":
        x, B, C = (a.astype(jnp.bfloat16) for a in (x, B, C))
    dt = np.log1p(np.exp(f(b, s, h))).astype(np.float32)      # softplus
    A = -np.exp(0.5 * f(h)).astype(np.float32)
    h0 = f(b, h, p, n) if with_h0 else None
    return x, dt, A, B, C, h0


def _both(arrays):
    """numpy inputs → (jax arrays, CPU tensors); None passes through."""
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    t = [None if a is None else tensor_from_numpy(a, "cpu") for a in arrays]
    return j, t


# ------------------------------------------------------------------ ssd ----
SSD_CASES = [  # the reference's cases: b, s, h, p, n, chunk, with_h0
    (2, 128, 4, 32, 64, 32, False),
    (1, 256, 2, 64, 128, 64, True),
    (2, 64, 8, 16, 32, 64, False),
    (1, 64, 1, 8, 16, 16, True),
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_matches_reference_and_pallas(case):
    b, s, h, p, n, chunk, with_h0 = case
    (jx, jdt, jA, jB, jC, jh0), (x, dt, A, B, C, h0) = _both(
        _ssd_inputs(b, s, h, p, n, with_h0, "bf16"))
    y, hT = ssd_chunked(x, dt, A, B, C, chunk, h0=h0)
    y_r, hT_r = JM.ssd_chunked(jx, jdt, jA, jB, jC, chunk, h0=jh0)
    y_n, _ = jax_naive(jx, jdt, jA, jB, jC, h0=jh0)
    y_k, hT_k = jax_ssd_kernel(jx, jdt, jA, jB, jC, jh0, chunk=chunk,
                               interpret=True)
    for ref in (y_r, y_n, y_k):
        _close(y, ref, BF16_TOL)
    for ref in (hT_r, hT_k):
        _close(hT, ref, BF16_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 3, 8, 16, 32),
                                             (1, 96, 2, 16, 32, 96),
                                             (1, 120, 2, 8, 16, 40)])
def test_plain_ssd_f32_and_ragged_chunks_match_the_recurrence(b, s, h, p, n,
                                                              chunk):
    """fp32 inputs, chunks that are not powers of two: the port's chunked
    scan and its per-token oracle against the reference's per-token
    oracle."""
    (jx, jdt, jA, jB, jC, jh0), (x, dt, A, B, C, h0) = _both(
        _ssd_inputs(b, s, h, p, n, True, "f32", seed=s))
    y_n, hT_n = jax_naive(jx, jdt, jA, jB, jC, h0=jh0)
    for y, hT in (ssd_chunked(x, dt, A, B, C, chunk, h0=h0),
                  ssd_naive_ref(x, dt, A, B, C, h0=h0)):
        _close(y, y_n, F32_TOL)
        _close(hT, hT_n, F32_TOL)


def test_plain_ssd_state_carries_across_a_split():
    (_, _, _, _, _, _), (x, dt, A, B, C, _) = _both(
        _ssd_inputs(1, 64, 2, 16, 32, False, "f32", seed=3))
    y_full, hT = ssd_chunked(x, dt, A, B, C, 16)
    y1, h1 = ssd_chunked(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], 16)
    y2, h2 = ssd_chunked(x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:], 16,
                         h0=h1)
    _close(torch.cat([y1, y2], 1), tensor_to_numpy(y_full), F32_TOL)
    _close(h2, tensor_to_numpy(hT), F32_TOL)


def test_plain_ssd_zero_dt_padding_keeps_the_state():
    """Positions padded with dt = 0 (as ``mamba_block`` pads) leave the
    state where the real positions left it."""
    _, (x, dt, A, B, C, h0) = _both(
        _ssd_inputs(1, 64, 2, 16, 32, True, "f32", seed=4))
    dt[:, 40:] = 0
    _, h_pad = ssd_chunked(x, dt, A, B, C, 64, h0=h0)
    _, h_cut = ssd_chunked(x[:, :40], dt[:, :40], A, B[:, :40], C[:, :40],
                           40, h0=h0)
    _close(h_pad, tensor_to_numpy(h_cut), F32_TOL)


def test_ssd_op_on_cpu_is_the_plain_version_and_refuses_ragged():
    _, (x, dt, A, B, C, h0) = _both(
        _ssd_inputs(1, 64, 2, 16, 32, True, "bf16", seed=5))
    for a, b_ in zip(ssd_scan_op(x, dt, A, B, C, h0, chunk=32),
                     ssd_chunked(x, dt, A, B, C, 32, h0=h0)):
        assert torch.equal(a, b_)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_scan_op(x[:, :60], dt[:, :60], A, B[:, :60], C[:, :60], chunk=32)


# ----------------------------------------------------------------- conv ----
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_reference(history):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 24)).astype(jnp.bfloat16)
    w = rng.standard_normal((4, 24)).astype(jnp.bfloat16)
    prev = rng.standard_normal((2, 3, 24)).astype(jnp.bfloat16) \
        if history else None
    (jx, jw, jprev), (tx, tw, tprev) = _both((x, w, prev))
    y_r, new_r = JM._causal_conv(jx, jw, jprev)
    y, new = _causal_conv(tx, tw, tprev)
    assert y.dtype == torch.bfloat16 and new.shape == (2, 3, 24)
    _close(y, y_r, BF16_TOL)
    assert np.array_equal(tensor_to_numpy(new), np.asarray(new_r, np.float32))


# ---------------------------------------------------------------- model ----
@pytest.fixture(scope="module")
def model():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


def test_init_params_and_bridge_match_reference_layout(model):
    jcfg, cfg, jp, tp = model
    mine = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for port in (tp, mine):
        for k, leaf in jp["mamba"].items():
            t = port["mamba"][k]
            assert tuple(t.shape) == leaf.shape, k
            assert str(t.dtype).endswith(str(leaf.dtype)), (k, t.dtype)
    for k in ("dt_bias", "A_log", "D"):          # fp32 leaves, bit-exact
        assert np.array_equal(tp["mamba"][k].numpy(),
                              np.asarray(jp["mamba"][k]))
    assert set(mine) == set(jp)


@pytest.mark.parametrize("branch", ["prefill", "extend", "decode"])
def test_mamba_block_branches_match_reference(model, branch):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(10)
    S = {"prefill": 45, "extend": 40, "decode": 1}[branch]
    x = (0.5 * rng.standard_normal((1, S, cfg.d_model))).astype(jnp.bfloat16)
    jpl, tpl = _layer0(jp["mamba"]), _layer0(tp["mamba"])
    state = None
    if branch != "prefill":
        _, st = JM.mamba_block(
            jnp.asarray((0.5 * rng.standard_normal((1, 70, cfg.d_model)))
                        .astype(jnp.bfloat16)), jpl, jcfg, NO_DIST,
            return_state=True)
        state = st
    jy, jst = JM.mamba_block(jnp.asarray(x), jpl, jcfg, NO_DIST, state=state,
                             return_state=True)
    tstate = None if state is None else state_from_numpy(
        np.asarray(state.ssm), np.asarray(state.conv), "cpu")
    ty, tst = mamba_block(tensor_from_numpy(x, "cpu"), tpl, cfg,
                          state=tstate, return_state=True)
    assert ty.shape == (1, S, cfg.d_model) and ty.dtype == torch.bfloat16
    _close(ty, jy, BF16_TOL)
    _close(tst.ssm, jst.ssm, F32_TOL)
    _close(tst.conv, np.asarray(jst.conv, np.float32), BF16_TOL)


def _close_logits(port, ref, what):
    err = np.abs(tensor_to_numpy(port) - ref).max()
    assert err <= LOGIT_TOL * max(1.0, np.abs(ref).max()), (what, err)


def _greedy_rule(ref: np.ndarray, port: np.ndarray) -> int:
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > GAP
    assert (ref.argmax(-1)[decisive] == port.argmax(-1)[decisive]).all()
    return int((~decisive).sum())


def test_prefill_and_teacher_forced_decode_match_reference(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (1, 75)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    jl, jc = JT.prefill(jp, jnp.asarray(prompt), jcfg)
    tl, tc = TT.prefill(tp, torch.from_numpy(prompt).long(), cfg)
    assert tc.kv is None and tc.length == 75
    assert tuple(tc.ssm.ssm.shape) == jc.ssm.ssm.shape
    rows_j, rows_t = [np.asarray(jl[0])], [tl[0]]
    _close_logits(tl, np.asarray(jl), "first token")
    # a multi-token extend (the scan from a state), then one-token steps
    jl, jc = JT.decode_step(jp, jnp.asarray(forced[:, :3]), jc, jcfg)
    tl, tc = TT.decode_step(tp, torch.from_numpy(forced[:, :3]).long(), tc,
                            cfg)
    _close_logits(tl, np.asarray(jl), "extend")
    rows_j.append(np.asarray(jl[0, -1]))
    rows_t.append(tl[0, -1])
    for s in range(3, 8):
        jl, jc = JT.decode_step(jp, jnp.asarray(forced[:, s:s + 1]), jc, jcfg)
        tl, tc = TT.decode_step(tp, torch.from_numpy(forced[:, s:s + 1]).long(),
                                tc, cfg)
        _close_logits(tl, np.asarray(jl), f"decode step {s}")
        rows_j.append(np.asarray(jl[0, -1]))
        rows_t.append(tl[0, -1])
    assert tc.length == 83
    _close(tc.ssm.ssm, jc.ssm.ssm, F32_TOL)
    _greedy_rule(np.stack(rows_j), tensor_to_numpy(torch.stack(rows_t)))


# --------------------------------------------------------------- worker ----
def _engine_tokens(vocab):
    """The requests of the reference's ``test_state_checkpoint_worker_ssm_
    reuse`` (tests/test_engine.py:149-157)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 1024)
    t1 = np.concatenate([shared, rng.integers(0, vocab, 96)])
    t2 = np.concatenate([shared, rng.integers(0, vocab, 64)])
    return t1, t2


@pytest.fixture(scope="module")
def workers(model):
    jcfg, cfg, jp, tp = model
    jw, tw = JWorker(jp, jcfg), StateCheckpointWorker(tp, cfg)
    firsts = []
    for t in _engine_tokens(cfg.vocab_size):
        firsts.append((jw(t)[0], tw(t)[0]))
    return jw, tw, firsts


def test_state_checkpoint_worker_matches_reference(workers, model):
    jcfg, cfg, jp, tp = model
    jw, tw, firsts = workers
    assert all(a == b for a, b in firsts), firsts
    assert tw.stats() == jw.stats()
    assert tw.stats()["restored_tokens"] >= 1024
    # t1: prefill 512 + extends 512, 96; t2: restore at 1024, extend 64
    assert tw.scan_calls == 4
    assert set(tw.data) == set(jw.data)
    for h, (ssm, conv) in jw.data.items():
        _close(tw.data[h].ssm, ssm, F32_TOL)
        _close(tw.data[h].conv, np.asarray(conv, np.float32), BF16_TOL)
    # the restored request's first token is the cold prefill's
    _, t2 = _engine_tokens(cfg.vocab_size)
    cold, _ = TT.prefill(tp, torch.from_numpy(t2[None]).long(), cfg)
    assert firsts[1][1] == int(torch.argmax(cold[0]))


def test_reference_checkpoint_restores_in_the_port(workers, model):
    """Checkpoints taken by the reference's worker, moved through the
    bridge, restore in the port's worker: its suffix-only prefill gives
    the reference's first token; and the reverse direction is exact."""
    jcfg, cfg, jp, tp = model
    jw, _, firsts = workers
    tw = StateCheckpointWorker(tp, cfg)
    for h, (ssm, conv) in jw.data.items():
        tw.meta.insert([h])
        tw.data[h] = state_from_numpy(ssm, conv, "cpu")
    _, t2 = _engine_tokens(cfg.vocab_size)
    first, caches = tw(t2)
    assert tw.stats()["restored_tokens"] == 1024
    assert tw.stats()["computed_tokens"] == len(t2) - 1024
    assert first == firsts[1][0]
    ssm, conv = state_to_numpy(tw.data[next(iter(jw.data))])
    j_ssm, j_conv = jw.data[next(iter(jw.data))]
    assert np.array_equal(ssm, np.asarray(j_ssm))
    assert np.array_equal(np.asarray(jnp.asarray(conv, jnp.bfloat16)),
                          np.asarray(j_conv))
    assert isinstance(caches.ssm, MambaState) and caches.length == len(t2)


def test_state_checkpoint_eviction_bounds_memory(model):
    _, cfg, _, tp = model
    w = StateCheckpointWorker(tp, cfg, capacity_checkpoints=3)
    rng = np.random.default_rng(8)
    for _ in range(4):
        w(rng.integers(0, cfg.vocab_size, 1040))        # 2 fresh ckpts each
    assert len(w.data) <= 3
    assert len(w.meta) == len(w.data)
    assert w.meta.evictions == 5


def test_kv_workers_refuse_an_ssm_model(model):
    """The reference's dense DecodeWorker.join copies KV only and would
    decode an SSM model from a zero state; the port refuses both KV
    workers for SSM models instead."""
    _, cfg, _, tp = model
    with pytest.raises(ValueError, match="uniform attention stacks"):
        PrefillWorker(tp, cfg, HostKVPool())
    for substrate in ("paged", "dense"):
        with pytest.raises(ValueError, match="SSM model"):
            DecodeWorker(tp, cfg, max_batch=2, max_len=64,
                         substrate=substrate)
    with pytest.raises(ValueError, match="SSM path"):
        StateCheckpointWorker(TT.init_params(
            get_config("smollm-360m").reduced(),
            torch.Generator().manual_seed(0), "cpu"),
            get_config("smollm-360m").reduced())
