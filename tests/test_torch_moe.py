"""The port's MoE layer and sliding-window paths against the reference's,
on the CPU at the reduced configs, with weights from the reference's
``init_params`` passed across by ``bridge.params_from_jax``:

* ``_route``: expert ids equal on every token, gates within 2e-2 (bf16),
  the tokens whose reference k-th and (k+1)-th router logits lie within
  one bf16 ulp counted and reported; exact ties (duplicated router
  columns) broken as ``jax.lax.top_k`` breaks them, lower index first;
* ``_dispatch_indices`` equal as integers, drops included;
* ``moe_block`` at the production capacity factor 1.25 on a slab that
  overflows an expert: the same choices dropped, y within 2e-2, the aux
  loss within 2e-5 (fp32);
* the reference's ``test_sliding_window_ring_decode`` inside the port,
  and the port's ring decode against the reference's ring caches;
* the workers' refusal of a prompt or a dense arena longer than the
  sliding window, where the reference raises or silently clamps;
* ``param_count``/``active_param_count`` equal for every config of both
  registries.

Tolerances are the reference's: 2e-2 for bf16 and 2e-5 for fp32
(``tests/test_kernels.py:44``), as ``np.testing.assert_allclose``'s atol
and rtol."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.configs.base import list_configs as jax_list_configs
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro_torch.bridge import (params_from_jax, tensor_from_numpy,
                                tensor_to_numpy)
from repro_torch.configs.base import get_config, list_configs
from repro_torch.serving.engine import DecodeWorker, HostKVPool, PrefillWorker

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

TOL_BF16 = 2e-2
TOL_F32 = 2e-5
MOE_ARCHS = ["qwen3-moe-235b-a22b", "mixtral-8x7b"]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe(request):
    jcfg = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _slab(rng, T, D):
    """T rows of bf16 activations, the same on both sides."""
    xj = jnp.asarray(rng.standard_normal((T, D)).astype(np.float32),
                     jnp.bfloat16)
    return xj, tensor_from_numpy(np.asarray(xj), "cpu")


def _close(port, ref, tol):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_route_matches_reference(moe, record_property):
    jcfg, cfg, jp, tp = moe
    k = cfg.moe.top_k
    xj, xt = _slab(np.random.default_rng(0), 4096, cfg.d_model)
    wj, wt = jp["moe"]["router"][0], tp["moe"]["router"][0]
    gj, ij, aj = JL._route(xj, wj, k)
    gt, it, at = TL._route(xt, wt, k)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    _close(gt, gj, TOL_BF16)
    _close(at, aj, TOL_F32)
    # near-ties of the reference's router logits at the top-k boundary:
    # counted, not skipped — the ids above are equal on them too
    logits = np.sort(np.asarray((xj @ wj).astype(jnp.float32)), axis=-1)
    kth, nxt = logits[:, -k], logits[:, -k - 1]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(kth), 1e-30))) - 7)
    near = int(((kth - nxt) <= ulp).sum())
    record_property("near_ties", near)
    print(f"{cfg.name}: {near} of 4096 tokens have their k-th and "
          f"(k+1)-th router logits within one bf16 ulp; ids equal on all")


def test_route_breaks_exact_ties_like_reference(moe):
    """Duplicated router columns make exact ties among the logits: the
    port must pick and order the tied experts as jax.lax.top_k does."""
    jcfg, cfg, jp, _ = moe
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    w = np.asarray(jp["moe"]["router"][0], np.float32)
    w[:, 1::2] = w[:, 0::2]             # expert 2i+1 ties with expert 2i
    wj = jnp.asarray(w, jnp.bfloat16)
    wt = tensor_from_numpy(np.asarray(wj), "cpu")
    xj, xt = _slab(np.random.default_rng(1), 512, cfg.d_model)
    _, ij, _ = JL._route(xj, wj, k)
    _, it, _ = TL._route(xt, wt, k)
    ij = np.asarray(ij)
    assert np.array_equal(it.numpy(), ij)
    # every token's top pair is a tied pair, lower index first
    assert (ij[:, 1] == ij[:, 0] + 1).all() and (ij[:, 0] % 2 == 0).all()
    assert E >= 4


@pytest.mark.parametrize("capacity", [1, 3, 16, 64])
def test_dispatch_indices_match_reference(capacity):
    rng = np.random.default_rng(capacity)
    E, k, T = 8, 2, 40
    # distinct experts per token, as top-k gives them
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    ref = np.asarray(JL._dispatch_indices(jnp.asarray(idx, jnp.int32), E,
                                          capacity))
    port = TL._dispatch_indices(torch.from_numpy(idx), E, capacity)
    assert np.array_equal(port.numpy(), ref)
    dropped = int((ref == E * capacity).sum())
    counts = np.bincount(idx.reshape(-1), minlength=E)
    assert dropped == int(np.maximum(counts - capacity, 0).sum())


def test_moe_block_drops_like_reference(moe):
    """Capacity factor 1.25 on a slab pushed towards one expert: that
    expert overflows, and the port drops the same (token, choice) pairs
    as the reference."""
    jcfg, cfg, jp, tp = moe
    j125 = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=1.25))
    t125 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    rng = np.random.default_rng(2)
    router = np.asarray(jp["moe"]["router"][0], np.float32)
    x = rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    x += 0.5 * router[:, 0] / np.linalg.norm(router[:, 0]) \
        * np.sqrt(cfg.d_model)            # favour expert 0
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = tensor_from_numpy(np.asarray(xj), "cpu")
    pj = jax.tree.map(lambda a: a[0], jp["moe"])
    pt = {n: t[0] for n, t in tp["moe"].items()}

    T = x.shape[0] * x.shape[1]
    cap = TL.moe_capacity(t125, T)
    h = JL.rms_norm(xj, pj["ln"], jcfg.norm_eps).reshape(T, -1)
    _, ij, _ = JL._route(h, pj["router"], k)
    slot_j = np.asarray(JL._dispatch_indices(ij, E, cap))
    ht = TL.rms_norm(xt, pt["ln"], cfg.norm_eps).reshape(T, -1)
    _, it, _ = TL._route(ht, pt["router"], k)
    slot_t = TL._dispatch_indices(it, E, cap).numpy()
    dropped = slot_j == E * cap
    assert dropped.sum() > 0, "the slab must overflow an expert"
    assert np.array_equal(slot_t == E * cap, dropped)
    assert np.array_equal(slot_t, slot_j)

    yj, aj = JL.moe_block(xj, pj, j125, JL.NO_DIST)
    yt, at = TL.moe_block(xt, pt, t125)
    _close(yt, yj, TOL_BF16)
    _close(at, aj, TOL_F32)
    print(f"{cfg.name}: capacity {cap} of {T} rows, {int(dropped.sum())} "
          f"of {T * k} choices dropped")


def test_moe_capacity_is_the_references_cap_of():
    full = get_config("qwen3-moe-235b-a22b")
    assert TL.moe_capacity(full, 8) == 8          # a decode step of 8 slots
    assert TL.moe_capacity(full, 256) == 20       # a 256-token chunk
    red = get_config("qwen3-moe-235b-a22b").reduced()
    assert all(TL.moe_capacity(red, T) == max(T, 2) for T in range(1, 300))


# ---------------------------------------------------------------------------
# the sliding window: ring decode, and the guards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral():
    jcfg = jax_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _jax_ring(jcfg, jp, tokens, pre):
    ring = JT.init_caches(jcfg, 1, tokens.shape[1],
                          window=jcfg.sliding_window)
    _, c = JT.prefill(jp, tokens[:, :pre], jcfg)
    ring = ring._replace(kv=ring.kv._replace(
        k=ring.kv.k.at[:, :, :pre].set(c.kv.k[:, :, -pre:]),
        v=ring.kv.v.at[:, :, :pre].set(c.kv.v[:, :, -pre:])),
        length=c.length)
    step = jax.jit(lambda t, c: JT.decode_step(jp, t, c, jcfg, ring=True))
    out = []
    for i in range(pre, tokens.shape[1]):
        lg, ring = step(tokens[:, i:i + 1], ring)
        out.append(np.asarray(lg[0, -1]))
    return np.stack(out), ring


def _port_ring(cfg, tp, tokens, pre):
    ring = TT.init_caches(cfg, 1, tokens.shape[1],
                          window=cfg.sliding_window, device="cpu")
    assert ring.kv.k.shape[2] == cfg.sliding_window
    _, c = TT.prefill(tp, tokens[:, :pre], cfg)
    ring.kv.k[:, :, :pre] = c.kv.k[:, :, -pre:]
    ring.kv.v[:, :, :pre] = c.kv.v[:, :, -pre:]
    ring = ring._replace(length=c.length)
    out = []
    for i in range(pre, tokens.shape[1]):
        lg, ring = TT.decode_step(tp, tokens[:, i:i + 1], ring, cfg,
                                  ring=True)
        out.append(lg[0, -1])
    return torch.stack(out), ring


def test_sliding_window_ring_decode(mixtral):
    """The reference's test inside the port (ring decode past the window
    picks the windowed prefill's token), and the port's ring steps and
    ring caches against the reference's."""
    jcfg, cfg, jp, tp = mixtral
    assert cfg.sliding_window == 64
    S, pre = 96, cfg.sliding_window        # context longer than the window
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (1, S), 0,
                                         cfg.vocab_size), np.int64)
    tt = torch.from_numpy(toks)
    lin, _ = TT.prefill(tp, tt, cfg)
    port, ring = _port_ring(cfg, tp, tt, pre)
    assert int(torch.argmax(port[-1])) == int(torch.argmax(lin[0]))

    # model outputs are held as the model tests hold them: within 2e-2 of
    # their scale (tests/test_torch_model.py)
    ref, jring = _jax_ring(jcfg, jp, jnp.asarray(toks, jnp.int32), pre)
    assert int(ring.length) == int(jring.length) == S
    for what, p, r in (("logits", port, ref), ("ring k", ring.kv.k,
                                                jring.kv.k),
                       ("ring v", ring.kv.v, jring.kv.v)):
        r = np.asarray(r, np.float32)
        err = np.abs(tensor_to_numpy(p) - r).max()
        assert err <= TOL_BF16 * max(1.0, np.abs(r).max()), (what, err)


def test_prefill_longer_than_the_window_is_refused(mixtral):
    jcfg, cfg, jp, tp = mixtral
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 70)
    # the reference writes 256-token chunks into its 64-slot cache: error
    jpw = JPrefillWorker(jp, jcfg, JHostKVPool(), prefill_chunk=256)
    with pytest.raises(TypeError, match="update shape"):
        jpw(prompt.astype(np.int32))
    for chunk in (256, 32):     # narrower chunks: the reference clamps
        pw = PrefillWorker(tp, cfg, HostKVPool(), prefill_chunk=chunk)
        with pytest.raises(ValueError, match="sliding window"):
            pw(prompt)
    # a prompt inside the window is served
    res = PrefillWorker(tp, cfg, HostKVPool(), prefill_chunk=32)(prompt[:64])
    assert res.prompt_len == 64


def test_dense_arena_past_the_window_is_refused(mixtral):
    jcfg, cfg, _, tp = mixtral
    # the reference's dense arena is window-sized whatever max_len asks
    assert JT.init_caches(jcfg, 2, 128).kv.k.shape[2] == cfg.sliding_window
    with pytest.raises(ValueError, match="sliding window"):
        DecodeWorker(tp, cfg, max_batch=2, max_len=128, substrate="dense")
    DecodeWorker(tp, cfg, max_batch=2, max_len=64, substrate="dense")
    DecodeWorker(tp, cfg, max_batch=2, max_len=128)        # paged: served


@pytest.mark.parametrize("name", jax_list_configs())
def test_param_counts_match_reference(name):
    if name not in list_configs():
        # a family the port has not taken up yet must not be registered
        with pytest.raises(KeyError):
            get_config(name)
        return
    for j, t in ((jax_config(name), get_config(name)),
                 (jax_config(name).reduced(), get_config(name).reduced())):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_record_and_replay_routing(moe):
    """``record_routing`` collects each call's expert ids;
    ``replay_routing`` routes a run by them (a run replaying its own
    routes computes the same values); ``dispatched_experts`` marks the
    choices dropped at capacity."""
    _, cfg, _, tp = moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    p = {n: t[0] for n, t in tp["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)).bfloat16()
    with TL.record_routing() as routes:
        y, aux = TL.moe_block(x, p, cfg)
    (idx,) = routes
    assert idx.shape == (128, cfg.moe.top_k)
    with TL.replay_routing(routes):
        y2, aux2 = TL.moe_block(x, p, cfg)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    flipped = [idx.flip(-1)]          # the same experts, the other order
    with TL.replay_routing(flipped), TL.record_routing() as again:
        TL.moe_block(x, p, cfg)
    assert torch.equal(again[0], flipped[0])
    with pytest.raises(RuntimeError, match="not replayed"):
        with TL.replay_routing(routes + routes):
            TL.moe_block(x, p, cfg)
    d = TL.dispatched_experts(cfg, idx)
    slot = TL._dispatch_indices(idx, cfg.moe.n_experts,
                                TL.moe_capacity(cfg, 128))
    n_drop = int((slot == cfg.moe.n_experts * TL.moe_capacity(cfg, 128))
                 .sum())
    assert int((d == -1).sum()) == n_drop
    assert torch.equal(d.sort(-1).values, d)
