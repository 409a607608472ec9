"""Each function of ``repro_torch.models.layers`` against its jnp original
in ``repro.models.layers``, on identical inputs (numpy seeds, weights
bridged bit for bit). bf16 tolerance 2e-2, f32 2e-5; the head map and
rope frequencies are compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as J
from repro.configs.base import get_config as jax_config
from repro.models.transformer import init_params as jax_init
import repro_torch.models.layers as T
from repro_torch.bridge import params_from_jax, tensor_from_numpy, tensor_to_numpy
from repro_torch.configs.base import get_config

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

BF16_TOL = 2e-2
ARCHS = ["smollm-360m", "qwen2.5-3b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, port cfg, layer-0 attn and mlp params for each side)."""
    jcfg = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = jax_init(jcfg, jax.random.PRNGKey(1))
    if jcfg.attn_bias:   # non-zero biases, so the bias path is exercised
        rng = np.random.default_rng(9)
        for name in ("bq", "bk", "bv"):
            jp["attn"][name] = jnp.asarray(
                0.1 * rng.standard_normal(jp["attn"][name].shape),
                jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    layer = lambda tree: {k: v[0] for k, v in tree.items()}
    return (jcfg, cfg, layer(jp["attn"]), layer(jp["mlp"]),
            layer(tp["attn"]), layer(tp["mlp"]))


def _x(shape, seed=0, scale=1.0):
    a = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32).astype(jnp.bfloat16)
    return jnp.asarray(a), tensor_from_numpy(a, "cpu")


def _close(port, ref, tol=BF16_TOL):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_rms_norm():
    jx, tx = _x((2, 5, 64))
    jw, tw = _x((64,), seed=1)
    _close(T.rms_norm(tx, tw), J.rms_norm(jx, jw))


def test_rope_freqs_and_apply_rope():
    np.testing.assert_allclose(T.rope_freqs(64, 1e4).numpy(),
                               np.asarray(J.rope_freqs(64, 1e4)), rtol=1e-6)
    jx, tx = _x((2, 7, 4, 32))
    pos = np.asarray([[3, 4, 5, 6, 7, 8, 9], [100, 101, 102, 103, 104, 105,
                                              106]], np.int32)
    _close(T.apply_rope(tx, torch.from_numpy(pos), 1e6),
           J.apply_rope(jx, jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("n_q,n_kv,padded", [(15, 5, 16), (4, 2, 16),
                                             (16, 2, 16), (40, 8, 48)])
def test_qh2kv_map_exact(n_q, n_kv, padded):
    assert T.qh2kv_map(n_q, n_kv, padded).tolist() == \
        np.asarray(J.qh2kv_map(n_q, n_kv, padded)).tolist()


@pytest.mark.parametrize("kv_heads", [8, 2])   # expanded, grouped
def test_attend(kv_heads):
    jq, tq = _x((2, 6, 8, 32))
    jk, tk = _x((2, 20, kv_heads, 32), seed=1)
    jv, tv = _x((2, 20, kv_heads, 32), seed=2)
    mask = np.random.default_rng(3).random((2, 1, 6, 20)) < 0.7
    mask[..., 0] = True
    _close(T._attend(tq, tk, tv, torch.from_numpy(mask), 32 ** -0.5),
           J._attend(jq, jk, jv, jnp.asarray(mask), 32 ** -0.5))


@pytest.mark.parametrize("q_offset,window", [(0, 0), (40, 0), (40, 16)])
def test_causal_attention(q_offset, window):
    jq, tq = _x((1, 24, 8, 32))
    jk, tk = _x((1, 80, 8, 32), seed=1)
    jv, tv = _x((1, 80, 8, 32), seed=2)
    _close(T.causal_attention(tq, tk, tv, q_offset, window, chunk_q=16),
           J.causal_attention(jq, jk, jv, q_offset, window, chunk_q=16))


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_per_slot_lengths(window):
    jq, tq = _x((3, 1, 8, 32))
    jk, tk = _x((3, 40, 8, 32), seed=1)
    jv, tv = _x((3, 40, 8, 32), seed=2)
    lens = np.asarray([1, 17, 40], np.int32)
    _close(T.decode_attention(tq, tk, tv, torch.from_numpy(lens), window),
           J.decode_attention(jq, jk, jv, jnp.asarray(lens), window))


def test_attention_block_prefill_branch(model):
    jcfg, cfg, ja, _, ta, _ = model
    jx, tx = _x((1, 40, cfg.d_model), seed=4)
    jy, (jk, jv) = J.attention_block(jx, ja, jcfg, J.NO_DIST, q_offset=0,
                                     kv_out=True)
    ty, (tk, tv) = T.attention_block(tx, ta, cfg, q_offset=0, kv_out=True)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


def _cache(cfg, B, S, seed):
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    return _x(shape, seed=seed), _x(shape, seed=seed + 1)


def test_attention_block_extend_branch(model):
    """Chunked-prefill extend: a uniform int length, the new chunk written
    into a prompt-sized cache whose tail is still zero."""
    jcfg, cfg, ja, _, ta, _ = model
    (jk, tk), (jv, tv) = _cache(cfg, 1, 96, seed=5)
    jk, jv = jk.at[:, 64:].set(0), jv.at[:, 64:].set(0)
    tk[:, 64:], tv[:, 64:] = 0, 0
    jx, tx = _x((1, 20, cfg.d_model), seed=6)
    jy, (jk2, jv2) = J.attention_block(
        jx, ja, jcfg, J.NO_DIST, cache=(jk, jv), cache_len=jnp.asarray(40))
    ty, (tk2, tv2) = T.attention_block(tx, ta, cfg, cache=(tk, tv),
                                       cache_len=40)
    _close(ty, jy)
    _close(tk2, jk2)
    _close(tv2, jv2)


def test_attention_block_decode_branch(model):
    """Continuous batching: one token per slot at per-slot depths."""
    jcfg, cfg, ja, _, ta, _ = model
    (jk, tk), (jv, tv) = _cache(cfg, 3, 64, seed=7)
    lens = np.asarray([0, 10, 63], np.int32)
    jx, tx = _x((3, 1, cfg.d_model), seed=8)
    jy, (jk2, _) = J.attention_block(jx, ja, jcfg, J.NO_DIST, cache=(jk, jv),
                                     cache_len=jnp.asarray(lens))
    ty, (tk2, _) = T.attention_block(tx, ta, cfg, cache=(tk, tv),
                                     cache_len=torch.from_numpy(lens))
    _close(ty, jy)                  # slot 0 (length 0) attends one token
    _close(tk2, jk2)


def test_paged_attention_block(model):
    """Rope at each slot's depth, the tail-page scatter (inactive slots hit
    the null page), and attention through the block table."""
    jcfg, cfg, ja, _, ta, _ = model
    P, page = 12, 16
    (jkp, tkp), (jvp, tvp) = _cache(cfg, P, page, seed=9)
    table = np.asarray([[3, 4, 0, 0], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([20, 47, 0], np.int32)
    jx, tx = _x((3, 1, cfg.d_model), seed=10)
    jy, (jkp2, jvp2) = J.paged_attention_block(
        jx, ja, jcfg, J.NO_DIST, k_pages=jkp, v_pages=jvp,
        block_table=jnp.asarray(table), seq_lens=jnp.asarray(lens))
    ty = T.paged_attention_block(
        tx, ta, cfg, k_pages=tkp, v_pages=tvp,
        block_table=torch.from_numpy(table), seq_lens=torch.from_numpy(lens))
    _close(ty[:2], jy[:2])          # active slots
    _close(tkp[1:], jkp2[1:])       # every real page, written in place
    _close(tvp[1:], jvp2[1:])


def test_mlp_block(model):
    jcfg, cfg, _, jm, _, tm = model
    jx, tx = _x((2, 9, cfg.d_model), seed=11)
    _close(T.mlp_block(tx, tm, cfg), J.mlp_block(jx, jm, jcfg))


def test_plain_attention_switch_is_scoped():
    assert not T._FORCE_PLAIN
    with T.plain_attention():
        assert T._FORCE_PLAIN
    assert not T._FORCE_PLAIN
