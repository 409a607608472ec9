"""jamba-1.5-large-398b's hybrid period stack in the port against the
reference, at ``.reduced()`` size (one full period of 8 layers: an
attention layer, 7 Mamba2 mixers, an FFN after each — MoE at the odd
in-period positions, 4 experts top-2 at capacity factor 2.0, drop-free),
and the reference's own property of the hybrid proven inside the port:
``prefill(S)`` ≡ ``prefill(S - k)`` + k decode steps.

The reference's MoE routing is recorded op by op (``jax.disable_jit``:
compiled, XLA keeps the bf16 router product in fp32 and can route a
near-tie differently, ROADMAP §3) and replayed in the port
(``replay_routing``), so a block's numerics are compared under one
routing. Tolerances: bf16 block outputs and KV within 2e-2 of their
scale, fp32 states within 5e-3 of theirs (the reference's fp32 scan
tolerance, ``tests/test_kernels.py``), the stack's output within
``HYBRID_TOL`` of its scale: eight layers carry the two packages' bf16
rounding differences further than two do, as they carry the reference's
own compiled-vs-op-by-op differences (the last test below measures
them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro_torch.bridge import (params_from_jax, state_from_numpy,
                                tensor_from_numpy, tensor_to_numpy)
from repro_torch.configs.base import get_config
from repro_torch.models.mamba import MambaState

torch.set_num_threads(1)

JAMBA = "jamba-1.5-large-398b"
BF16_TOL = 2e-2
F32_TOL = 5e-3
HYBRID_TOL = 4e-2


@pytest.fixture(scope="module")
def jamba():
    jcfg = jax_config(JAMBA).reduced()
    cfg = get_config(JAMBA).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _scaled(port, ref, tol):
    """Within ``tol`` of the reference's largest magnitude (at least 1)."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(tensor_to_numpy(port) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _bf16(rng, shape, scale=1.0):
    a = jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32),
                    jnp.bfloat16)
    return a, tensor_from_numpy(np.asarray(a), "cpu")


def _reference_routed(monkeypatch, fn):
    """Run ``fn`` op by op and collect every MoE call's (T, k) expert ids
    in call order, as the port's ``record_routing`` does."""
    routes = []
    route = JL._route

    def recording(xf, w, k):
        g, idx, aux = route(xf, w, k)
        routes.append(torch.from_numpy(np.asarray(idx).astype(np.int64)))
        return g, idx, aux

    monkeypatch.setattr(JL, "_route", recording)
    with jax.disable_jit():
        out = fn()
    monkeypatch.setattr(JL, "_route", route)
    return out, routes


def test_reduced_is_one_full_period(jamba):
    jcfg, cfg, _, _ = jamba
    assert cfg.n_layers == cfg.attn_every == jcfg.n_layers == 8
    assert cfg.attention_layers == 1 and cfg.moe.every == 2
    assert get_config(JAMBA).attention_layers == 9


def test_hybrid_stack_prefill_matches_reference(jamba, monkeypatch):
    """Prefill mode of ``_hybrid_stack`` on a 40-token input (not a
    multiple of the 32-token SSD chunk): the stack's output, the period's
    KV and every Mamba2 layer's final state."""
    jcfg, cfg, jp, tp = jamba
    jx, tx = _bf16(np.random.default_rng(0), (2, 40, cfg.d_model))
    (jh, _, jkv, jst), routes = _reference_routed(
        monkeypatch, lambda: JT._hybrid_stack(
            jp, jx, jcfg, JL.NO_DIST, mode="prefill", caches=None,
            q_offset=0, ring=False, window_override=None))
    assert len(routes) == 4                      # the period's MoE FFNs
    with TL.replay_routing(routes):
        th, _, tkv, tst = TT._hybrid_stack(
            tp, tx, cfg, mode="prefill", caches=None, q_offset=0,
            ring=False, window_override=None)
    assert th.shape == tx.shape and len(tkv) == 1
    _scaled(th, jh, HYBRID_TOL)
    _scaled(tkv[0][0], jkv[0][0], BF16_TOL)
    _scaled(tkv[0][1], jkv[1][0], BF16_TOL)
    assert tuple(tst.ssm.shape) == jst.ssm.shape == (1, 7, 2, 32, 16, 16)
    assert tuple(tst.conv.shape) == jst.conv.shape
    _scaled(tst.ssm, jst.ssm, F32_TOL)
    _scaled(tst.conv, jst.conv, BF16_TOL)


@pytest.mark.parametrize("lengths", ["uniform", "per-slot"])
def test_hybrid_stack_decode_matches_reference(jamba, monkeypatch, lengths):
    """Decode mode of ``_hybrid_stack`` from the same caches on both
    sides (the reference's prefill of a 30-token prompt, carried across
    with the bridge): one token, at a uniform int length or at per-slot
    (B,) lengths (the dense continuous-batching form); the stack's
    output, the KV row it writes and the new states."""
    jcfg, cfg, jp, tp = jamba
    rng = np.random.default_rng(1)
    B, S, cap = 2, 30, 40
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    _, jc = JT.prefill(jp, jnp.asarray(prompt), jcfg)
    full = JT.init_caches(jcfg, B, cap)
    k = full.kv.k.at[:, :, :S].set(jc.kv.k)
    v = full.kv.v.at[:, :, :S].set(jc.kv.v)
    if lengths == "uniform":
        jlen, tlen = jnp.asarray(S, jnp.int32), S
    else:                              # slot 1 three tokens shallower
        jlen = jnp.asarray([S, S - 3], jnp.int32)
        tlen = torch.tensor([S, S - 3], dtype=torch.int32)
    jcaches = full._replace(kv=full.kv._replace(k=k, v=v), ssm=jc.ssm,
                            length=jlen)
    tcaches = TT.Caches(
        kv=TT.KVCache(k=tensor_from_numpy(np.asarray(k), "cpu"),
                      v=tensor_from_numpy(np.asarray(v), "cpu")),
        length=tlen, ssm=state_from_numpy(np.asarray(jc.ssm.ssm),
                                          np.asarray(jc.ssm.conv), "cpu"))
    jx, tx = _bf16(rng, (B, 1, cfg.d_model))
    (jh, _, jkv, jst), routes = _reference_routed(
        monkeypatch, lambda: JT._hybrid_stack(
            jp, jx, jcfg, JL.NO_DIST, mode="decode", caches=jcaches,
            q_offset=None, ring=False, window_override=None))
    with TL.replay_routing(routes):
        th, _, tkv, tst = TT._hybrid_stack(
            tp, tx, cfg, mode="decode", caches=tcaches, q_offset=0,
            ring=False, window_override=None)
    _scaled(th, jh, HYBRID_TOL)
    # the KV written in place: the whole cache, the new rows included
    _scaled(tkv[0][0], jkv[0][0], BF16_TOL)
    _scaled(tkv[0][1], jkv[1][0], BF16_TOL)
    assert tkv[0][0].data_ptr() == tcaches.kv.k[0].data_ptr()
    _scaled(tst.ssm, jst.ssm, F32_TOL)
    _scaled(tst.conv, jst.conv, BF16_TOL)


@pytest.mark.parametrize("name", ["smollm-360m", "mamba2-2.7b", JAMBA])
def test_incremental_decode_matches_prefill(name):
    """The reference's ``test_incremental_decode_matches_prefill`` inside
    the port: prefill(S) ≡ prefill(S - k) + k decode steps, the carried
    KV and Mamba2 states together, logits within the reference's own
    0.15 and the greedy token identical."""
    cfg = get_config(name).reduced()
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S, k = 1, 48, 4
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S))).long()
    full_logits, _ = TT.prefill(tp, tokens, cfg)
    _, c = TT.prefill(tp, tokens[:, :S - k], cfg)
    caches = TT.init_caches(cfg, B, S, device="cpu")
    if caches.kv is not None:
        caches.kv.k[:, :, :S - k] = c.kv.k
        caches.kv.v[:, :, :S - k] = c.kv.v
    caches = caches._replace(ssm=c.ssm, length=c.length)
    for i in range(S - k, S):
        lg, caches = TT.decode_step(tp, tokens[:, i:i + 1], caches, cfg)
    assert caches.length == S
    np.testing.assert_allclose(lg[:, -1].numpy(), full_logits.numpy(),
                               rtol=0.15, atol=0.15)
    assert int(lg[0, -1].argmax()) == int(full_logits[0].argmax())


def test_hybrid_chunked_extend_equals_prefill(jamba):
    """A 48-token prompt extended in 16-token chunks from empty caches
    (the attention layer over its linear cache, every Mamba2 layer from
    its carried state and conv tail) gives prefill's last logits, KV and
    states."""
    _, cfg, _, tp = jamba
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 48))).long()
    ref, rc = TT.prefill(tp, tokens, cfg)
    caches = TT.init_caches(cfg, 1, 48, device="cpu")
    for lo in range(0, 48, 16):
        lg, caches = TT.decode_step(tp, tokens[:, lo:lo + 16], caches, cfg)
    assert caches.length == 48
    _scaled(lg[:, -1], ref.numpy(), HYBRID_TOL)
    assert int(lg[0, -1].argmax()) == int(ref[0].argmax())
    _scaled(caches.kv.k, rc.kv.k.float().numpy(), BF16_TOL)
    _scaled(caches.ssm.ssm, rc.ssm.ssm.numpy(), F32_TOL)
    assert isinstance(caches.ssm, MambaState)


def test_hybrid_logits_within_the_references_own_spread(jamba,
                                                       record_property):
    """The smoke input of ``tests/test_torch_families.py`` (seed 4, two
    64-token prompts): the reference's compiled and op-by-op prefills
    differ from each other (printed and recorded as ``spread``), and the
    port's prefill is no further from either of them than that, or than
    ``HYBRID_TOL`` of the logit scale."""
    jcfg, cfg, jp, tp = jamba
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                            (2, 64)).astype(np.int32)
    compiled, _ = jax.jit(lambda p, t: JT.prefill(p, t, jcfg))(
        jp, jnp.asarray(tok))
    with jax.disable_jit():
        eager, _ = JT.prefill(jp, jnp.asarray(tok), jcfg)
    port, _ = TT.prefill(tp, torch.from_numpy(tok), cfg)
    compiled, eager = (np.asarray(a, np.float32) for a in (compiled, eager))
    scale = max(1.0, float(np.abs(eager).max()))
    spread = float(np.abs(compiled - eager).max())
    to_eager = float(np.abs(tensor_to_numpy(port) - eager).max())
    to_compiled = float(np.abs(tensor_to_numpy(port) - compiled).max())
    for k, v in (("spread", spread), ("to_eager", to_eager),
                 ("to_compiled", to_compiled), ("scale", scale)):
        record_property(k, v)
    print(f"jamba reduced, logit scale {scale:.3f}: the reference compiled "
          f"vs op by op {spread:.4f} ({spread / scale:.2%}); the port vs "
          f"op by op {to_eager:.4f}, vs compiled {to_compiled:.4f}")
    assert max(to_eager, to_compiled) <= max(spread, HYBRID_TOL * scale)
