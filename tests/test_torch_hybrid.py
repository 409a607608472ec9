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
rounding differences further than two do. The last test holds the
port's prefill against each of the reference's two runs, op by op and
compiled, under that run's own routing: the two runs route a few
near-tied tokens differently from each other and from the port, and a
flipped choice moves the later layers' inputs by more than rounding, so
without the replay only the greedy tokens are held, where the top-2
logit gap is wide."""
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


def _compiled_routed(monkeypatch, fn, *args):
    """Run ``jax.jit(fn)(*args)`` and collect every MoE call's (T, k)
    expert ids in call order, as the compiled run chose them: a
    ``jax.debug.callback`` (ordered) in a wrapped ``_route``."""
    routes = []
    route = JL._route

    def recording(xf, w, k):
        g, idx, aux = route(xf, w, k)
        jax.debug.callback(lambda i: routes.append(torch.from_numpy(
            np.asarray(i).astype(np.int64))), idx, ordered=True)
        return g, idx, aux

    monkeypatch.setattr(JL, "_route", recording)
    out = jax.jit(fn)(*args)
    jax.effects_barrier()
    monkeypatch.setattr(JL, "_route", route)
    return out, routes


def _flips(a: list, b: list) -> list:
    """The tokens routed to a different expert set, per MoE layer."""
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b)]


@pytest.fixture(scope="module")
def smoke_runs(jamba):
    """The smoke input of ``tests/test_torch_families.py`` (seed 4, two
    64-token prompts) through the reference op by op and compiled, each
    run's routing recorded, the compiled run also unpatched, and the
    port with its own routing."""
    jcfg, cfg, jp, tp = jamba
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                            (2, 64)).astype(np.int32)
    # a fresh function for each compiled run: jit's cache is keyed by
    # the function, and the recording run traces its own callbacks
    plain = jax.jit(lambda p, t: JT.prefill(p, t, jcfg)[0])(
        jp, jnp.asarray(tok))
    with pytest.MonkeyPatch.context() as mp:
        eager, eager_routes = _reference_routed(
            mp, lambda: JT.prefill(jp, jnp.asarray(tok), jcfg)[0])
        compiled, compiled_routes = _compiled_routed(
            mp, lambda p, t: JT.prefill(p, t, jcfg)[0], jp, jnp.asarray(tok))
    with TL.record_routing() as own:
        port, _ = TT.prefill(tp, torch.from_numpy(tok), cfg)
    return {"tokens": tok, "port": tensor_to_numpy(port),
            "own_routes": list(own),
            "op_by_op": (np.asarray(eager, np.float32), eager_routes),
            "compiled": (np.asarray(compiled, np.float32), compiled_routes),
            "compiled_unpatched": np.asarray(plain, np.float32)}


@pytest.mark.parametrize("run", ["op_by_op", "compiled"])
def test_hybrid_logits_within_the_references_own_spread(
        jamba, smoke_runs, run, record_property):
    """The port's prefill of the smoke input against each of the
    reference's two runs, under that run's routing (replayed): logits
    within ``HYBRID_TOL`` of the logit scale. The compiled run's routing
    is recorded in a run whose logits are bit for bit the unpatched
    compiled run's. Without the replay, the port's greedy token at each
    row's last position is the run's wherever the run's top-2 gap
    exceeds twice that bound (``test_serve_step_matches_the_reference_
    sharded``'s rule): a near-tie in a router picks experts differently
    in any two runs (the reference's own two runs do so), and each flip
    moves the later layers' inputs by more than rounding."""
    _, cfg, _, tp = jamba
    sr = smoke_runs
    ref, routes = sr[run]
    other = sr["compiled" if run == "op_by_op" else "op_by_op"][0]
    if run == "compiled":
        np.testing.assert_array_equal(ref, sr["compiled_unpatched"])
    assert len(routes) == len(sr["own_routes"]) == 4
    with TL.replay_routing(routes):
        port, _ = TT.prefill(tp, torch.from_numpy(sr["tokens"]), cfg)
    port = tensor_to_numpy(port)
    scale = max(1.0, float(np.abs(ref).max()))
    bound = HYBRID_TOL * scale
    replayed = float(np.abs(port - ref).max())
    own = sr["port"]
    unreplayed = float(np.abs(own - ref).max())
    spread = float(np.abs(ref - other).max())
    flips = _flips(sr["own_routes"], routes)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * bound
    for k, v in (("scale", scale), ("bound", bound), ("replayed", replayed),
                 ("unreplayed", unreplayed), ("spread", spread),
                 ("routing_flips", flips),
                 ("decisive_rows", int(decisive.sum()))):
        record_property(k, v)
    print(f"jamba reduced vs the reference {run}, logit scale {scale:.3f}: "
          f"replayed {replayed:.4f} (bound {bound:.4f}), unreplayed "
          f"{unreplayed:.4f}, the reference's two runs {spread:.4f}; "
          f"tokens routed differently per MoE layer {flips}")
    assert replayed <= bound, (replayed, bound)
    assert (own.argmax(-1)[decisive] == ref.argmax(-1)[decisive]).all()
