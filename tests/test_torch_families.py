"""The remaining model families in the port against the reference: the
configs of all eleven models, whisper-large-v3's encoder, cross-attention
K/V and the two bidirectional attention branches, internvl2-26b's patch
frontend, every config's prefill and one decode step, the KV workers'
guards beside what the reference's workers do, and the launcher's
``--arch`` values. Weights come from the reference's ``init_params``
through ``bridge.params_from_jax``; everything runs at ``.reduced()``
size. jamba-1.5-large-398b's period stack has its own file,
``tests/test_torch_hybrid.py``.

Tolerances: a bf16 block output within 2e-2 (absolute and relative,
the reference's own bf16 tolerance, ``tests/test_kernels.py``); logits
within 2e-2 of the logit scale and greedy tokens equal where the
reference's top-2 gap exceeds 4e-2 (``tests/test_torch_model.py``); the
hybrid's logits within ``HYBRID_TOL`` of the scale (below)."""
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
from repro.serving.engine import DecodeWorker as JDecodeWorker
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
from repro.serving.engine import paged_supported as jax_paged_supported
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro_torch.bridge import params_from_jax, tensor_from_numpy, \
    tensor_to_numpy
from repro_torch.configs.base import MODEL_AXIS, get_config, list_configs
from repro_torch.launch import serve as serve_mod
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillWorker, paged_supported)

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

BF16_TOL = 2e-2
LOGIT_TOL = 2e-2
GAP = 4e-2
# jamba's reduced stack (7 Mamba2 mixers, 4 MoE FFNs in 8 layers) carries
# bf16 rounding differences further than the uniform stacks: on the smoke
# input below, the port under each reference run's routing is 3.0-3.3% of
# the logit scale from that run (tests/test_torch_hybrid.py,
# test_hybrid_logits_within_the_references_own_spread, which prints it)
HYBRID_TOL = 4e-2
WHISPER = "whisper-large-v3"
VLM = "internvl2-26b"
JAMBA = "jamba-1.5-large-398b"

_WEIGHTS: dict = {}


def weights(name):
    """(jax cfg, port cfg, reference params, the port's bridged params)
    at reduced size, built once per test process."""
    if name not in _WEIGHTS:
        jcfg = jax_config(name).reduced()
        cfg = get_config(name).reduced()
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _WEIGHTS[name] = (jcfg, cfg, jp, tp)
    return _WEIGHTS[name]


def _close(port, ref, tol=BF16_TOL):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _close_logits(port, ref, tol=LOGIT_TOL):
    """Within ``tol`` of the reference's scale (its largest magnitude, at
    least 1)."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(tensor_to_numpy(port) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _greedy_rule(ref, port) -> int:
    """Top-1 equal where the reference is decisive; the near-ties
    skipped are returned."""
    ref = np.asarray(ref, np.float32)
    port = tensor_to_numpy(port)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > GAP
    assert (ref.argmax(-1)[decisive] == port.argmax(-1)[decisive]).all()
    return int((~decisive).sum())


def _bf16(rng, shape, scale=1.0):
    """The same bf16 array on both sides: (jax array, CPU tensor)."""
    a = jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32),
                    jnp.bfloat16)
    return a, tensor_from_numpy(np.asarray(a), "cpu")


def _layer(tree, l):
    return jax.tree.map(lambda t: t[l], tree)


# ---------------------------------------------------------------- configs --

def test_list_configs_equals_reference():
    assert list_configs() == jax_list_configs()
    assert len(list_configs()) == 11


# the reference's own config properties (tests/test_configs.py), proven
# on the port's configs
PARAM_TARGETS = {
    "qwen3-moe-235b-a22b": (150, 300), "smollm-360m": (0.25, 0.55),
    "qwen2.5-3b": (2.0, 4.5), "mixtral-8x7b": (35, 60),
    "phi3-mini-3.8b": (2.5, 5.0), "internvl2-26b": (15, 30),
    "mamba2-2.7b": (1.8, 3.5), "whisper-large-v3": (1.0, 2.5),
    "jamba-1.5-large-398b": (250, 450), "qwen3-14b": (10, 18),
    "llama2-70b": (55, 85),
}


@pytest.mark.parametrize("name", jax_list_configs())
def test_config_properties_hold_in_the_port(name):
    cfg = get_config(name)
    lo, hi = PARAM_TARGETS[name]
    assert lo <= cfg.param_count() / 1e9 <= hi
    if cfg.kind != "ssm":
        assert cfg.padded_heads % MODEL_AXIS == 0
    assert cfg.padded_vocab % 256 == 0
    red = cfg.reduced()
    assert red.d_model <= 512 and red.n_layers <= 8
    assert red.moe is None or red.moe.n_experts <= 4
    assert red.param_count() < 50e6
    j, jr = jax_config(name), jax_config(name).reduced()
    for t, ref in ((cfg, j), (red, jr)):
        assert _fields(t) == _fields(ref, like=t)
        assert t.attention_layers == ref.attention_layers


def _fields(cfg, like=None) -> dict:
    """A config's fields as a dict, nested MoE/SSM configs included;
    with ``like``, only the fields the port's own config has (the
    reference's ``n_groups`` is not ported)."""
    like = cfg if like is None else like
    out = {}
    for f in dataclasses.fields(like):
        v, mine = getattr(cfg, f.name), getattr(like, f.name)
        out[f.name] = _fields(v, like=mine) \
            if dataclasses.is_dataclass(mine) else v
    return out


def test_dense_active_params_equal_total():
    dense = get_config("qwen3-14b")
    assert dense.active_param_count() == dense.param_count()
    jamba = get_config(JAMBA)
    assert jamba.active_param_count() == jax_config(JAMBA).active_param_count()
    assert jamba.active_param_count() < 0.5 * jamba.param_count()


# ------------------------------------------------------ params and caches --

def _layout(tree):
    return {k: _layout(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).rsplit(".", 1)[-1])
            for k, v in tree.items()}


@pytest.mark.parametrize("name", [JAMBA, WHISPER, VLM])
def test_init_params_and_bridge_match_reference(name):
    """The port's own ``init_params`` and the bridged reference weights
    have the reference's keys, shapes and dtypes (the two-level period
    stacks and the fp32 SSM leaves included); the bridge carries every
    leaf bit for bit."""
    jcfg, cfg, jp, tp = weights(name)
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp,
                       is_leaf=lambda a: hasattr(a, "shape"))
    mine = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _layout(mine) == ref
    assert _layout(tp) == ref
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        a = np.asarray(leaf)
        bits = np.int16 if a.dtype.name == "bfloat16" else a.dtype
        got = node.view(torch.int16) if node.dtype == torch.bfloat16 \
            else node
        assert np.array_equal(got.numpy(), a.view(bits)), path
    if name == WHISPER:                       # cross blocks carry no bias
        assert set(mine["cross_attn"]) == set(jp["cross_attn"])


@pytest.mark.parametrize("name,enc_len", [(JAMBA, 0), (WHISPER, 16),
                                          (WHISPER, 0), (VLM, 0),
                                          ("mamba2-2.7b", 0)])
def test_init_caches_shapes_match_reference(name, enc_len):
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    jc = JT.init_caches(jcfg, 3, 40, enc_len=enc_len)
    tc = TT.init_caches(cfg, 3, 40, enc_len=enc_len, device="cpu")
    for field in ("kv", "ssm", "enc_kv"):
        j, t = getattr(jc, field), getattr(tc, field)
        assert (j is None) == (t is None), field
        if j is None:
            continue
        for a, b in zip(j, t):
            assert tuple(b.shape) == a.shape, field
            assert str(b.dtype).endswith(str(a.dtype)), field
            assert not b.any()
    assert tc.length == 0


# ---------------------------------------------------------- the encoder ----

def test_encode_matches_reference():
    jcfg, cfg, jp, tp = weights(WHISPER)
    rng = np.random.default_rng(0)
    jf, tf = _bf16(rng, (2, cfg.frontend_tokens, cfg.d_model))
    je = JT.encode(jp, jf, jcfg, JL.NO_DIST)
    te = TT.encode(tp, tf, cfg)
    assert te.shape == (2, cfg.frontend_tokens, cfg.d_model)
    assert te.dtype == torch.bfloat16
    _close(te, je)


def test_build_enc_kv_matches_reference():
    jcfg, cfg, jp, tp = weights(WHISPER)
    rng = np.random.default_rng(1)
    je, te = _bf16(rng, (2, cfg.frontend_tokens, cfg.d_model))
    jkv = JT.build_enc_kv(jp, je, jcfg)
    tkv = TT.build_enc_kv(tp, te, cfg)
    shape = (cfg.n_layers, 2, cfg.frontend_tokens, cfg.n_kv_heads,
             cfg.head_dim)
    for a, b in zip(jkv, tkv):
        assert tuple(b.shape) == a.shape == shape
        _close(b, a)


def _grouped(cfg):
    """The config with 16 query heads over 4 KV heads: unpadded and
    divisible, the grouped attention path of both packages."""
    return dataclasses.replace(cfg, n_heads=16, n_kv_heads=4)


@pytest.mark.parametrize("branch", ["cross", "cross-grouped", "noncausal",
                                    "noncausal-grouped"])
def test_bidirectional_attention_branches_match_reference(branch):
    """The cross-attention branch (``enc_kv=``: no RoPE on the query,
    the encoder's rope-free K/V, every position attended, no biases) and
    the encoder's ``causal=False`` branch (RoPE at 0..S, an all-true
    mask), through the padded ``qh2kv`` map (whisper's 4 heads padded to
    16) and through the grouped path."""
    jcfg, cfg, jp, tp = weights(WHISPER)
    cross = branch.startswith("cross")
    if branch.endswith("grouped"):
        jcfg, cfg = _grouped(jcfg), _grouped(cfg)
        jp = {"cross_attn" if cross else "enc_attn": JT._init_attn(
            jax.random.PRNGKey(3), jcfg, 1, cross=cross)}
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    key = "cross_attn" if cross else "enc_attn"
    pj = _layer(jp[key], 0)
    pt = {k: v[0] for k, v in tp[key].items()}
    rng = np.random.default_rng(2)
    jx, tx = _bf16(rng, (2, 12, cfg.d_model))
    if cross:
        shape = (2, 16, cfg.n_kv_heads, cfg.head_dim)
        jk, tk = _bf16(rng, shape)
        jv, tv = _bf16(rng, shape)
        jy, jkv = JL.attention_block(jx, pj, jcfg, JL.NO_DIST,
                                     enc_kv=(jk, jv))
        ty, tkv = TL.attention_block(tx, pt, cfg, enc_kv=(tk, tv))
        assert jkv is None and tkv is None
    else:
        jy, _ = JL.attention_block(jx, pj, jcfg, JL.NO_DIST, causal=False)
        ty, _ = TL.attention_block(tx, pt, cfg, causal=False)
        # bidirectional: every position but the last sees more than the
        # causal branch would show it
        causal, _ = TL.attention_block(tx, pt, cfg)
        assert (causal[:, :-1] - ty[:, :-1]).abs().max() > 0
    assert ty.shape == tx.shape
    _close(ty, jy)


def test_prefill_needs_frames_and_decode_needs_enc_kv():
    _, cfg, _, tp = weights(WHISPER)
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs frames"):
        TT.prefill(tp, tok, cfg)
    with pytest.raises(ValueError, match="enc_kv"):
        TT.decode_step(tp, tok[:, :1], TT.init_caches(cfg, 1, 8,
                                                      device="cpu"), cfg)


# ------------------------------------------------------- patch frontend ----

def test_prefill_with_patches_matches_reference():
    """internvl2: the stub patches are prepended to the embedded tokens,
    the cache length counts them, and the logits of the last position
    and a decode step over the padded cache match the reference."""
    jcfg, cfg, jp, tp = weights(VLM)
    rng = np.random.default_rng(3)
    P, S = cfg.frontend_tokens, 40
    jpatch, tpatch = _bf16(rng, (2, P, cfg.d_model))
    tok = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = JT.prefill(jp, jnp.asarray(tok), jcfg, patches=jpatch)
    tl, tc = TT.prefill(tp, torch.from_numpy(tok), cfg, patches=tpatch)
    assert int(jc.length) == tc.length == P + S
    assert tuple(tc.kv.k.shape) == jc.kv.k.shape
    _close_logits(tc.kv.k, jc.kv.k)          # within 2e-2 of K's scale
    _close_logits(tl, jl)
    _greedy_rule(jl, tl)
    # without patches the stack is a text-only dense stack
    jt, _ = JT.prefill(jp, jnp.asarray(tok), jcfg)
    tt, tc2 = TT.prefill(tp, torch.from_numpy(tok), cfg)
    assert tc2.length == S
    _close_logits(tt, jt)


# ------------------------------------------- every config, prefill + step --

def _frontend(cfg, rng, B):
    """The stub inputs the reference's smoke test passes: frames or
    patches (B, frontend_tokens, d_model)."""
    if cfg.frontend not in ("patch", "audio"):
        return {}, {}
    j, t = _bf16(rng, (B, cfg.frontend_tokens, cfg.d_model))
    key = "patches" if cfg.frontend == "patch" else "frames"
    return {key: j}, {key: t}


@pytest.mark.parametrize("name", jax_list_configs())
def test_smoke_prefill_and_decode_matches_reference(name):
    """The counterpart of the reference's ``test_smoke_prefill_and_decode``
    for every config, both packages on the same weights and inputs:
    prefill, copy into padded caches (the encoder's K/V and the SSM
    states carried), one decode step; logits and lengths compared. A
    windowed config (mixtral: a 64-token window, as long as the prompt)
    decodes through its ring cache, the reference's only dense path past
    the window (a linear step would write past its window-sized cache)."""
    jcfg, cfg, jp, tp = weights(name)
    rng = np.random.default_rng(4)
    B, S = 2, 64
    jkw, tkw = _frontend(cfg, rng, B)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, **jkw))(
        jp, jnp.asarray(tok))
    tl, tc = TT.prefill(tp, torch.from_numpy(tok), cfg, **tkw)
    tol = HYBRID_TOL if cfg.attn_every else LOGIT_TOL
    assert tl.shape == (B, cfg.padded_vocab)
    assert bool(torch.isfinite(tl).all())
    _close_logits(tl, jl, tol)
    _greedy_rule(jl, tl)
    S_eff = S + (cfg.frontend_tokens if cfg.frontend == "patch" else 0)
    assert int(jc.length) == tc.length == S_eff

    enc_len = cfg.frontend_tokens if cfg.encoder_layers else 0
    ring = bool(cfg.sliding_window)
    jfull = JT.init_caches(jcfg, B, S_eff + 8, enc_len=enc_len)
    tfull = TT.init_caches(cfg, B, S_eff + 8, enc_len=enc_len, device="cpu")
    jkv = jfull.kv
    if jkv is not None:
        sl = (slice(None), slice(None), slice(0, S_eff))
        jkv = jkv._replace(k=jkv.k.at[sl].set(jc.kv.k),
                           v=jkv.v.at[sl].set(jc.kv.v))
        tfull.kv.k[:, :, :S_eff] = tc.kv.k
        tfull.kv.v[:, :, :S_eff] = tc.kv.v
    jfull = jfull._replace(kv=jkv, ssm=jc.ssm if jc.ssm is not None
                           else jfull.ssm, enc_kv=jc.enc_kv,
                           length=jc.length)
    tfull = tfull._replace(ssm=tc.ssm if tc.ssm is not None else tfull.ssm,
                           enc_kv=tc.enc_kv, length=tc.length)
    if enc_len:
        assert tuple(tfull.enc_kv.k.shape) == jfull.enc_kv.k.shape
    tok1 = np.array(jnp.argmax(jl, -1)[:, None].astype(jnp.int32))
    jl2, jc2 = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, jcfg,
                                                      ring=ring))(
        jp, jnp.asarray(tok1), jfull)
    tl2, tc2 = TT.decode_step(tp, torch.from_numpy(tok1), tfull, cfg,
                              ring=ring)
    assert tl2.shape == (B, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(tl2).all())
    _close_logits(tl2, jl2, tol)
    _greedy_rule(jl2, tl2)
    assert int(jc2.length) == tc2.length == S_eff + 1


def test_linear_extend_past_the_cache_is_refused():
    """A linear cache takes no write past its end: the slice assignment
    would keep none of the new tokens (the reference's
    ``dynamic_update_slice`` clamps them onto the last slots), so the
    extend raises."""
    _, cfg, _, tp = weights(VLM)
    caches = TT.init_caches(cfg, 1, 8, device="cpu")._replace(length=6)
    with pytest.raises(ValueError, match="past the 8-slot cache"):
        TT.decode_step(tp, torch.zeros((1, 4), dtype=torch.int64), caches,
                       cfg)
    lg, caches = TT.decode_step(tp, torch.zeros((1, 2), dtype=torch.int64),
                                caches, cfg)
    assert caches.length == 8 and lg.shape == (1, 2, cfg.padded_vocab)


# ---------------------------------------------------------- KV workers ----

def test_paged_substrate_refuses_encoder_stacks():
    for name in jax_list_configs():
        cfg = get_config(name).reduced()
        assert paged_supported(cfg) == jax_paged_supported(
            jax_config(name).reduced()), name
    assert not paged_supported(get_config(WHISPER))
    with pytest.raises(ValueError, match="uniform attention stacks"):
        TT.decode_step_paged(*([None] * 6), get_config(WHISPER))


def test_whisper_kv_workers_refused_where_the_reference_loses_the_encoder():
    """The port's ``PrefillWorker`` and ``DecodeWorker`` refuse whisper;
    the reference's worker prefills it with no encoder output at all: its
    caches carry no ``enc_kv``, so every cross-attention block runs as a
    causal self-attention over the decoder's own tokens with the cross
    weights."""
    jcfg, cfg, jp, tp = weights(WHISPER)
    assert cfg.attention_layers == cfg.n_layers      # the old guard's pass
    with pytest.raises(ValueError, match="encoder-decoder.*prefill"):
        PrefillWorker(tp, cfg, HostKVPool())
    with pytest.raises(ValueError, match="encoder-decoder"):
        DecodeWorker(tp, cfg, max_batch=2, max_len=64, substrate="dense")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 40)
    res = JPrefillWorker(jp, jcfg, JHostKVPool(), prefill_chunk=64)(prompt)
    assert res.prompt_len == 40                        # it ran
    caches = JT.init_caches(jcfg, 1, 40)               # what it extends
    assert caches.enc_kv is None
    tok = jnp.asarray(prompt[None], jnp.int32)
    ext, _ = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, jcfg))(
        jp, tok, caches)
    assert res.first_token == int(jnp.argmax(ext[0, -1]))
    # those logits are the cross blocks' run as causal self-attention
    # over the prompt, not of any encoder frames
    x = JT._embed(jp, tok, jcfg)
    for l in range(jcfg.n_layers):
        y, _ = JL.attention_block(x, _layer(jp["attn"], l), jcfg, JL.NO_DIST)
        x = x + y
        y, _ = JL.attention_block(x, _layer(jp["cross_attn"], l), jcfg,
                                  JL.NO_DIST)
        x = x + y
        x = x + JL.mlp_block(x, _layer(jp["mlp"], l), jcfg)
    h = JL.rms_norm(x, jp["final_ln"], jcfg.norm_eps)
    causal = JT._logits_at(jp, h[:, -1:], jcfg)[0, 0]
    err = float(jnp.abs(causal - ext[0, -1]).max())
    assert err <= LOGIT_TOL * max(1.0, float(jnp.abs(ext).max()))


def test_ssm_and_hybrid_kv_workers_refused():
    for name, what in (("mamba2-2.7b", "SSM model"), (JAMBA, "hybrid")):
        _, cfg, _, tp = weights(name)
        with pytest.raises(ValueError, match="uniform attention stacks"):
            PrefillWorker(tp, cfg, HostKVPool())
        for sub in ("paged", "dense"):
            with pytest.raises(ValueError, match=what):
                DecodeWorker(tp, cfg, max_batch=2, max_len=64, substrate=sub)


def test_jamba_dense_join_in_the_reference_drops_the_state():
    """The reference's dense ``DecodeWorker`` takes jamba and its join
    copies KV only: the joined slot's Mamba2 states stay all zero while
    the prefill ended on a non-zero state. The port refuses the worker
    (above)."""
    from repro.serving.engine import PrefillResult as JPrefillResult
    jcfg, _, jp, _ = weights(JAMBA)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, 24)
    logits, c = JT.prefill(jp, jnp.asarray(prompt[None], jnp.int32), jcfg)
    assert float(jnp.abs(c.ssm.ssm).max()) > 0
    dw = JDecodeWorker(jp, jcfg, max_batch=2, max_len=64, substrate="dense")
    pres = JPrefillResult(
        first_token=int(jnp.argmax(logits[0])),
        kv_k=np.asarray(c.kv.k[:, 0]), kv_v=np.asarray(c.kv.v[:, 0]),
        prompt_len=24, reused_blocks=0, new_blocks=0)
    from repro.serving.request import ServingRequest as JServingRequest
    slot = dw.join(JServingRequest(req_id=0, tokens=prompt, max_new=4), pres)
    assert float(jnp.abs(dw.caches.ssm.ssm[:, :, slot]).max()) == 0
    assert float(jnp.abs(dw.caches.ssm.conv[:, :, slot]).max()) == 0
    assert int(dw.caches.length[slot]) == 24


# ------------------------------------------------------------ launcher ----

@pytest.mark.parametrize("name", [WHISPER, JAMBA, "mamba2-2.7b"])
def test_launcher_refuses_what_the_kv_workers_refuse(name, capsys):
    cfg = get_config(name).reduced()
    with pytest.raises(ValueError, match="KV serving workers"):
        serve_mod.serve(cfg, "cpu", requests=1, log=lambda m: None)
    with pytest.raises(SystemExit):
        serve_mod.main(["--arch", name])
    assert "--arch" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["qwen3-14b", VLM])
def test_launcher_body_serves_new_archs_on_cpu(name):
    """qwen3-14b and internvl2-26b (a text-only dense stack, as the
    reference's launcher serves it) through the launcher's body."""
    cfg = get_config(name).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = serve_mod.serve(cfg, "cpu", params=params, requests=3, max_batch=2,
                        max_new=4, log=lambda m: None)
    assert s["completed"] == s["submitted"] > 0
    assert s["paged_calls"] == s["decode_steps"] > 0
    for rid, _, mn, _ in s["payloads"]:
        assert len(s["outputs"][rid]) == mn
