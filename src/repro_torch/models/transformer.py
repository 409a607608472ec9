"""Dense transformer assembly in PyTorch — the counterpart of the
reference's ``repro/models/transformer.py`` for uniform dense stacks
(the MoE, SSM, hybrid and encoder families are not ported yet).

Parameters are a plain dict of tensors stacked on a leading layer axis,
with the reference's keys and shapes, so ``bridge.params_from_jax`` maps
one onto the other leaf by leaf. The reference's ``lax.scan`` over
layers is a Python loop here. Forward modes:
  * ``prefill``           — full sequence, last-position logits + KV;
  * ``decode_step``       — a few tokens against preallocated linear
                            caches (chunked-prefill extend at an int
                            length, or per-slot decode at a (B,) length);
  * ``decode_step_paged`` — one continuous-batching token per slot over
                            the shared paged KV store.
Caches and page slabs are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (DTYPE, attention_block, mlp_block,
                                       paged_attention_block, rms_norm)


class KVCache(NamedTuple):
    """Stacked attention KV: k, v are (L, B, S, KV, Dh)."""
    k: torch.Tensor
    v: torch.Tensor


class Caches(NamedTuple):
    kv: KVCache
    #: tokens written so far: an int (uniform batch) or a (B,) int32
    #: tensor (continuous batching, every slot at its own depth)
    length: Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# parameter initialisation (stacked)
# ---------------------------------------------------------------------------

def _norm(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen.device)).to(DTYPE)


def _init_attn(gen, cfg: ModelConfig, L: int) -> dict:
    D, Hp, KV, Dh = cfg.d_model, cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    s_in = (2.0 / (D + Hp * Dh)) ** 0.5
    wq = _norm(gen, (L, D, Hp * Dh), s_in)
    # zero the padded query heads' projections (q = 0 there; the heads
    # still attend — uniformly, over KV head 0 — and pass through wo)
    if Hp != cfg.n_heads:
        m = torch.repeat_interleave(torch.arange(Hp) < cfg.n_heads, Dh)
        wq = wq * m.to(DTYPE).to(wq.device)[None, None, :]
    p = dict(
        ln=torch.ones((L, D), dtype=DTYPE, device=gen.device),
        wq=wq,
        wk=_norm(gen, (L, D, KV * Dh), s_in),
        wv=_norm(gen, (L, D, KV * Dh), s_in),
        wo=_norm(gen, (L, Hp * Dh, D), s_in),
    )
    if cfg.attn_bias:
        p["bq"] = torch.zeros((L, Hp * Dh), dtype=DTYPE, device=gen.device)
        p["bk"] = torch.zeros((L, KV * Dh), dtype=DTYPE, device=gen.device)
        p["bv"] = torch.zeros((L, KV * Dh), dtype=DTYPE, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, Dh), dtype=DTYPE, device=gen.device)
        p["k_norm"] = torch.ones((L, Dh), dtype=DTYPE, device=gen.device)
    return p


def _init_mlp(gen, cfg: ModelConfig, L: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    s = (2.0 / (D + F)) ** 0.5
    return dict(
        ln=torch.ones((L, D), dtype=DTYPE, device=gen.device),
        w1=_norm(gen, (L, D, F), s),
        w2=_norm(gen, (L, F, D), s),
        w3=_norm(gen, (L, D, F), s),
    )


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Stacked parameter dict for a dense model: the reference's shapes
    and scales (``_init_attn``/``_init_mlp``), drawn from ``generator``
    (on its own device) and moved to ``device``."""
    device = resolve_device(device)
    assert cfg.kind == "dense", f"{cfg.kind} models are not ported yet"
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    params: dict = {
        "embed": _norm(generator, (V, D), D ** -0.5),
        "final_ln": torch.ones((D,), dtype=DTYPE, device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _norm(generator, (D, V), D ** -0.5)
    params["attn"] = _init_attn(generator, cfg, L)
    params["mlp"] = _init_mlp(generator, cfg, L)
    return _to(params, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _layer(stack: dict, l: int) -> dict:
    return {k: t[l] for k, t in stack.items()}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda") -> Caches:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.head_dim)
    return Caches(kv=KVCache(k=torch.zeros(shape, dtype=DTYPE, device=device),
                             v=torch.zeros(shape, dtype=DTYPE, device=device)),
                  length=0)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _logits_at(params, h_last, cfg: ModelConfig) -> torch.Tensor:
    """h_last (B, k, D) → (B, k, V) fp32 logits."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h_last @ w).float()


def _uniform_stack(params, x, cfg: ModelConfig, *, mode: str,
                   caches, q_offset: int, window_override):
    """One attention + MLP block per layer; returns (x, per-layer kv)."""
    kvs = []
    for l in range(cfg.n_layers):
        p_a = _layer(params["attn"], l)
        if mode == "prefill":
            y, kv = attention_block(x, p_a, cfg, q_offset=q_offset,
                                    kv_out=True,
                                    window_override=window_override)
        else:
            y, kv = attention_block(
                x, p_a, cfg, cache=(caches.kv.k[l], caches.kv.v[l]),
                cache_len=caches.length, window_override=window_override)
        x = x + y
        x = x + mlp_block(x, _layer(params["mlp"], l), cfg)
        kvs.append(kv)
    return x, kvs


def prefill(params, tokens, cfg: ModelConfig, *, q_offset: int = 0,
            window_override=None):
    """Full-sequence prefill of tokens (B, S). Returns (last-position
    logits (B, V) fp32, Caches with exact-length KV)."""
    x = _embed(params, tokens, cfg)
    h, kvs = _uniform_stack(params, x, cfg, mode="prefill", caches=None,
                            q_offset=q_offset,
                            window_override=window_override)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = _logits_at(params, h[:, -1:, :], cfg)[:, 0]
    kv = KVCache(k=torch.stack([k for k, _ in kvs]),
                 v=torch.stack([v for _, v in kvs]))
    return logits, Caches(kv=kv, length=q_offset + tokens.shape[1])


def decode_step(params, tokens, caches: Caches, cfg: ModelConfig, *,
                window_override=None):
    """tokens (B, S) against preallocated caches (written in place).
    Returns (logits (B, S, V) fp32, caches with the length advanced)."""
    x = _embed(params, tokens, cfg)
    h, _ = _uniform_stack(params, x, cfg, mode="decode", caches=caches,
                          q_offset=0, window_override=window_override)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = _logits_at(params, h, cfg)
    return logits, Caches(kv=caches.kv, length=caches.length + tokens.shape[1])


def decode_step_paged(params, tokens, k_pages, v_pages, block_table,
                      seq_lens, cfg: ModelConfig, *, window_override=None):
    """One continuous-batching decode iteration over the PAGED store.

    tokens (B, 1); k/v_pages (L, P, page, KV, Dh), written in place;
    block_table (B, max_pages) int32 (0-padded with the null page);
    seq_lens (B,) int32 tokens already written per slot. Returns
    (logits (B, 1, V) fp32, k_pages, v_pages)."""
    x = _embed(params, tokens, cfg)
    for l in range(cfg.n_layers):
        x = x + paged_attention_block(
            x, _layer(params["attn"], l), cfg, k_pages=k_pages[l],
            v_pages=v_pages[l], block_table=block_table, seq_lens=seq_lens,
            window_override=window_override)
        x = x + mlp_block(x, _layer(params["mlp"], l), cfg)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _logits_at(params, h, cfg), k_pages, v_pages

