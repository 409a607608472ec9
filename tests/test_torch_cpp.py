"""Chunked Pipeline Parallelism (CPP) prefill of the port on CPU stage
meshes, against the port's full prefill (``cpp_reference``) and the
reference's ``cpp_reference`` on the same weights (taken through
``bridge.params_from_jax``), within the reference's own tolerances
(``tests/test_distribution.py``: logits 2e-2, KV 1e-2): the GPipe
wavefront of C + X − 1 microsteps, each chunk run once by each stage,
the bubbles committing nothing, and the reference's assertions."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.serving.cpp import cpp_reference as jax_cpp_reference
from repro_torch.bridge import params_from_jax, tensor_to_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import Mesh, make_stage_mesh
from repro_torch.models.transformer import init_params
from repro_torch.serving.cpp import cpp_prefill, cpp_reference

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

S, CHUNK = 256, 64


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_config("smollm-360m").reduced(),
                               n_layers=4)
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=4)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, S), 0,
                                           cfg.vocab_size))
    return jcfg, cfg, jp, tp, tokens


def _np(t) -> np.ndarray:
    return tensor_to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("stages", [4, 2, 1])
def test_cpp_matches_full_prefill_and_reference(weights, stages):
    """Against the port's full prefill, the reference test's element-wise
    tolerances (logits 2e-2, KV 1e-2). Against the reference's full
    prefill, logits and KV within 2e-2 of their scales (max |x|), the
    rule of ``tests/test_torch_model.py`` (ROADMAP §3, the logit
    comparison): the two packages' full prefills already differ by 1–2
    bf16 ulps — up to 0.033 in layers 1–3's KV, also at values near 0
    where K is a cancelling sum (1.2% of the KV scale), 0.031 in the
    logits — which no element-wise 1e-2 holds."""
    jcfg, cfg, jp, tp, tokens = weights
    t = torch.from_numpy(tokens.copy()).long()
    lc, (kc, vc) = cpp_prefill(tp, t, cfg,
                               make_stage_mesh(stages, device="cpu"),
                               prefill_chunk=CHUNK)
    # the KV comes back sharded by layer: one (L/X, B, S, KV, Dh) a stage
    assert len(kc) == stages and kc[0].shape == (
        cfg.n_layers // stages, 1, S, cfg.n_kv_heads, cfg.head_dim)
    lc, kc, vc = _np(lc), _np(torch.cat(kc)), _np(torch.cat(vc))
    lp, (kp, vp) = cpp_reference(tp, t, cfg)
    np.testing.assert_allclose(lc, _np(lp), atol=2e-2, rtol=2e-2)
    lr, (kr, vr) = jax.jit(lambda p, x: jax_cpp_reference(p, x, jcfg))(
        jp, tokens)
    scale = max(float(np.abs(_np(lr)).max()), 1.0)
    assert float(np.abs(lc - _np(lr)).max()) <= 2e-2 * scale
    for got, k, j in ((kc, kp, kr), (vc, vp, vr)):
        np.testing.assert_allclose(got, _np(k), atol=1e-2, rtol=1e-2)
        j = _np(j)
        assert float(np.abs(got - j).max()) <= 2e-2 * float(np.abs(j).max())


def test_wavefront_schedule(weights, monkeypatch):
    """C + X − 1 microsteps; at microstep t stage s runs chunk t − s when
    it exists, so each chunk runs once on each stage, in order, and every
    other (microstep, stage) is a bubble that runs — and commits —
    nothing: the stage body runs exactly C·X times."""
    import repro_torch.serving.cpp as cpp
    _, cfg, _, tp, tokens = weights
    X, C = 4, S // CHUNK
    calls = []
    body = cpp._stage_body

    def counted(x, p_attn, p_mlp, cfg, k_buf, v_buf, offset):
        calls.append((k_buf.data_ptr(), offset))
        return body(x, p_attn, p_mlp, cfg, k_buf, v_buf, offset)

    monkeypatch.setattr(cpp, "_stage_body", counted)
    cpp_prefill(tp, torch.from_numpy(tokens.copy()).long(), cfg,
                make_stage_mesh(X, device="cpu"), prefill_chunk=CHUNK)
    sched = cpp_prefill.last_schedule
    assert len(sched) == C + X - 1
    for t, ran in enumerate(sched):
        assert ran == tuple(t - s if 0 <= t - s < C else None
                            for s in range(X))
    assert sum(c is None for ran in sched for c in ran) == X * (X - 1)
    assert len(calls) == C * X
    by_stage: dict = {}
    for buf, off in calls:
        by_stage.setdefault(buf, []).append(off)
    assert list(by_stage.values()) == [[c * CHUNK for c in range(C)]] * X


def test_explicit_mesh_is_bitwise_the_full_prefill(weights):
    """On the CPU's plain path the chunked extends give the full
    prefill's logits and KV bit for bit; a stage mesh built from an
    explicit device list (two stages on one device) runs the same."""
    _, cfg, _, tp, tokens = weights
    mesh = Mesh(["cpu"] * 2, ("stage",))
    t = torch.from_numpy(tokens.copy()).long()
    lc, (kc, vc) = cpp_prefill(tp, t, cfg, mesh, prefill_chunk=CHUNK)
    lr, (kr, vr) = cpp_reference(tp, t, cfg)
    assert torch.equal(lc, lr)
    assert torch.equal(torch.cat(kc), kr) and torch.equal(torch.cat(vc), vr)


def test_reference_assertions(weights):
    _, cfg, _, tp, tokens = weights
    t = torch.from_numpy(tokens.copy()).long()
    with pytest.raises(AssertionError):          # S % prefill_chunk
        cpp_prefill(tp, t[:, :200], cfg, make_stage_mesh(4, device="cpu"),
                    prefill_chunk=CHUNK)
    with pytest.raises(AssertionError):          # n_layers % X
        cpp_prefill(tp, t, cfg, make_stage_mesh(3, device="cpu"),
                    prefill_chunk=CHUNK)
    moe = get_config("qwen3-moe-235b-a22b").reduced()
    with pytest.raises(ValueError, match="uniform dense stack"):
        cpp_prefill(init_params(moe, torch.Generator().manual_seed(0), "cpu"),
                    t, moe, make_stage_mesh(2, device="cpu"),
                    prefill_chunk=CHUNK)
