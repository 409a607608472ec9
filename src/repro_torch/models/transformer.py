"""Model assembly in PyTorch — the counterpart of the reference's
``repro/models/transformer.py`` for every family: uniform dense and MoE
stacks, pure SSM (Mamba2) stacks, the hybrid period stack (jamba: one
attention layer and ``attn_every - 1`` Mamba2 layers a period, an FFN
after every mixer, MoE at odd in-period positions), the encoder-decoder
(whisper: a bidirectional encoder over stub frames and a cross-attention
after each decoder layer's self-attention, over K/V built once at
prefill) and the patch frontend (internvl2: stub patch embeddings
prepended to the embedded tokens).

Parameters are a plain dict of tensors stacked on a leading layer axis,
with the reference's keys and shapes, so ``bridge.params_from_jax`` maps
one onto the other leaf by leaf. The reference's ``lax.scan`` over
layers is a Python loop here. Forward modes:
  * ``loss_fn``           — the training forward: no caches, the chunked
                            cross-entropy plus the MoE aux loss; every
                            attention and scan a differentiable plain op
                            (the kernels are forward-only, as the
                            reference's Pallas kernels have no VJP), each
                            layer rematerialised under ``cfg.remat``;
  * ``prefill``           — full sequence, last-position logits + KV;
  * ``decode_step``       — a few tokens against preallocated linear
                            caches (chunked-prefill extend at an int
                            length, or per-slot decode at a (B,) length),
                            or one token into a sliding-window ring cache
                            (``ring=True``); for an SSM stack a chunk
                            continuation or a one-token step from the
                            carried state;
  * ``decode_step_paged`` — one continuous-batching token per slot over
                            the shared paged KV store (uniform attention
                            stacks only);
  * ``decode_step_paged_sharded`` — the same over a (data, model) mesh
                            of a banked page store (dense-MLP stacks).
KV caches and page slabs are updated in place; an SSM state is replaced
by the new one a step returns, as in the reference.

``loss_fn``, ``prefill`` and ``decode_step`` take a ``Dist``: on a
(data, model) mesh the batch splits into data rows (lists of row tensors
through the stack), the attention, MLP, MoE and Mamba2 blocks are
tensor- or expert-parallel over ``model`` (``models/layers.py``,
``models/mamba.py``), the decode's attention also context-parallel over
the KV cache's sequence stripes, and the embedding, the unembedding and
the chunked cross-entropy are vocab-parallel: position m of a row owns
vocabulary stripe m. The encoder, cross-attention and the frontends take
their leaves gathered whole on each row's device. Parameters may be
``launch.shardings.Sharded`` leaves (``shard_params``) or whole tensors;
the decode's caches are ``Sharded`` (``shard_caches``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shardings import (Sharded, batch_entry, collective,
                                          gather, gather_tree, seq_axes,
                                          shard_rows, stack_sharded)
from repro_torch.models.layers import (DTYPE, NO_DIST, Dist, PagedShard,
                                       _model_part, _psum, _row_stripes,
                                       attention_block, join_rows, mlp_block,
                                       moe_block, paged_attention_block,
                                       rms_norm, split_rows)
from repro_torch.models.mamba import MambaState, mamba_block

# Sequence-chunk length of the chunked cross-entropy (bounds the fp32
# logits to (B, CE_CHUNK, V) instead of (B, S, V)).
CE_CHUNK = 512


class KVCache(NamedTuple):
    """Stacked attention KV: k, v are (L, B, S, KV, Dh)."""
    k: torch.Tensor
    v: torch.Tensor


class Caches(NamedTuple):
    kv: Optional[KVCache]          # None for a pure SSM stack
    #: tokens written so far: an int (uniform batch) or a (B,) int32
    #: tensor (continuous batching, every slot at its own depth)
    length: Union[int, torch.Tensor]
    #: stacked Mamba2 state: (L, ...) for an SSM stack, (periods,
    #: attn_every - 1, ...) for a hybrid, else None
    ssm: Optional[MambaState] = None
    #: the decoder's cross-attention K/V of an encoder-decoder model,
    #: (L, B, S_enc, KV, Dh) each, else None
    enc_kv: Optional[KVCache] = None


# ---------------------------------------------------------------------------
# parameter initialisation (stacked)
# ---------------------------------------------------------------------------

def _norm(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen.device)).to(DTYPE)


def _init_attn(gen, cfg: ModelConfig, L: int, cross: bool = False) -> dict:
    """Attention projections; a cross-attention block (``cross``) has no
    biases."""
    D, Hp, KV, Dh = cfg.d_model, cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    s_in = (2.0 / (D + Hp * Dh)) ** 0.5
    wq = _norm_per_layer(gen, (L, D, Hp * Dh), s_in)
    # zero the padded query heads' projections (q = 0 there; the heads
    # still attend — uniformly, over KV head 0 — and pass through wo)
    if Hp != cfg.n_heads:
        m = torch.repeat_interleave(torch.arange(Hp) < cfg.n_heads, Dh)
        wq = wq * m.to(DTYPE).to(wq.device)[None, None, :]
    p = dict(
        ln=torch.ones((L, D), dtype=DTYPE, device=gen.device),
        wq=wq,
        wk=_norm_per_layer(gen, (L, D, KV * Dh), s_in),
        wv=_norm_per_layer(gen, (L, D, KV * Dh), s_in),
        wo=_norm_per_layer(gen, (L, Hp * Dh, D), s_in),
    )
    if cfg.attn_bias and not cross:
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
        w1=_norm_per_layer(gen, (L, D, F), s),
        w2=_norm_per_layer(gen, (L, F, D), s),
        w3=_norm_per_layer(gen, (L, D, F), s),
    )


def _norm_per_layer(gen: torch.Generator, shape, scale: float):
    """``_norm`` drawn one layer at a time: the fp32 draw of a whole stack
    (qwen3-moe's expert w1 at 4 layers: 12.9 GB; internvl2's MLP w1 at 48
    layers: 19.3 GB) never exists."""
    out = torch.empty(shape, dtype=DTYPE, device=gen.device)
    for l in range(shape[0]):
        out[l] = _norm(gen, shape[1:], scale)
    return out


def _init_moe(gen, cfg: ModelConfig, L: int) -> dict:
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    s = (2.0 / (D + F)) ** 0.5
    return dict(
        ln=torch.ones((L, D), dtype=DTYPE, device=gen.device),
        router=_norm(gen, (L, D, E), D ** -0.5),
        w1=_norm_per_layer(gen, (L, E, D, F), s),
        w2=_norm_per_layer(gen, (L, E, F, D), s),
        w3=_norm_per_layer(gen, (L, E, D, F), s),
    )


def _init_mamba(gen, cfg: ModelConfig, L: int) -> dict:
    s_cfg = cfg.ssm
    D = cfg.d_model
    di = s_cfg.d_inner(D)
    nh = s_cfg.n_heads(D)
    conv_ch = s_cfg.conv_channels(D)
    proj_out = di + conv_ch + nh      # z, then x·B·C, then dt
    f32 = dict(dtype=torch.float32, device=gen.device)
    return dict(
        ln=torch.ones((L, D), dtype=DTYPE, device=gen.device),
        in_proj=_norm(gen, (L, D, proj_out), (2.0 / (D + proj_out)) ** 0.5),
        conv_w=_norm(gen, (L, s_cfg.d_conv, conv_ch), conv_ch ** -0.5),
        dt_bias=torch.zeros((L, nh), **f32),
        A_log=torch.zeros((L, nh), **f32),     # A = -exp(0) = -1
        D=torch.ones((L, nh), **f32),
        norm=torch.ones((L, di), dtype=DTYPE, device=gen.device),
        out_proj=_norm(gen, (L, di, D), (2.0 / (di + D)) ** 0.5),
    )


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Stacked parameter dict with the reference's keys, shapes and
    scales (``_init_attn``/``_init_mlp``/``_init_moe``/``_init_mamba``),
    drawn from ``generator`` (on its own device: a CUDA generator keeps a
    large model's draw off the host) and moved to ``device``. A hybrid's
    stacks are (periods, per-period index, ...); an encoder-decoder adds
    ``enc_attn``, ``enc_mlp``, ``enc_final_ln`` and ``cross_attn``."""
    device = resolve_device(device)
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    params: dict = {
        "embed": _norm(generator, (V, D), D ** -0.5),
        "final_ln": torch.ones((D,), dtype=DTYPE, device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _norm(generator, (D, V), D ** -0.5)
    if cfg.kind == "ssm":
        params["mamba"] = _init_mamba(generator, cfg, L)
    elif cfg.attn_every:
        n_per = L // cfg.attn_every
        inner = cfg.attn_every - 1          # Mamba2 layers a period
        n_moe = cfg.attn_every // cfg.moe.every
        n_dense = cfg.attn_every - n_moe
        params["attn"] = _init_attn(generator, cfg, n_per)
        params["mamba"] = _periods(
            _init_mamba(generator, cfg, n_per * inner), n_per)
        params["ffn_dense"] = _periods(
            _init_mlp(generator, cfg, n_per * n_dense), n_per)
        params["ffn_moe"] = _periods(
            _init_moe(generator, cfg, n_per * n_moe), n_per)
    else:
        params["attn"] = _init_attn(generator, cfg, L)
        if _use_moe(cfg):
            params["moe"] = _init_moe(generator, cfg, L)
        else:
            params["mlp"] = _init_mlp(generator, cfg, L)
    if cfg.encoder_layers:
        Le = cfg.encoder_layers
        params["enc_attn"] = _init_attn(generator, cfg, Le)
        params["enc_mlp"] = _init_mlp(generator, cfg, Le)
        params["enc_final_ln"] = torch.ones((D,), dtype=DTYPE,
                                            device=generator.device)
        params["cross_attn"] = _init_attn(generator, cfg, L, cross=True)
    return _to(params, device)


def param_count_exact(params) -> int:
    """The number of parameters: every leaf's elements."""
    if isinstance(params, dict):
        return sum(param_count_exact(v) for v in params.values())
    return params.numel()


def _periods(stack: dict, n_per: int) -> dict:
    """A stack of ``n_per * k`` layers → (n_per, k, ...) per leaf."""
    return {k: t.reshape((n_per, t.shape[0] // n_per) + t.shape[1:])
            for k, t in stack.items()}


def _use_moe(cfg: ModelConfig) -> bool:
    """Experts in every layer (the uniform MoE stack)."""
    return cfg.moe is not None and cfg.moe.every == 1


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
                enc_len: int = 0, window: int = 0, device="cuda") -> Caches:
    """Preallocated decode caches: stacked KV of the attention layers, a
    zero stacked Mamba2 state of an SSM stack or a hybrid ((periods,
    attn_every - 1, ...)), and with ``enc_len`` an encoder-decoder's
    zero cross-attention K/V. ``window`` > 0 — and, as in the reference,
    a windowed model's ``sliding_window`` when it is 0 — bounds the KV
    cache to that many slots (the ring buffer of sliding-window
    decode)."""
    device = resolve_device(device)
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    kv = None
    if cfg.attention_layers:
        eff_window = window or cfg.sliding_window
        S = min(max_len, eff_window) if eff_window else max_len
        shape = (cfg.attention_layers, batch, S, KV, Dh)
        kv = KVCache(k=torch.zeros(shape, dtype=DTYPE, device=device),
                     v=torch.zeros(shape, dtype=DTYPE, device=device))
    ssm = None
    if cfg.ssm is not None and cfg.kind in ("ssm", "hybrid"):
        s = cfg.ssm
        lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every - 1) \
            if cfg.attn_every else (cfg.n_layers,)
        ssm = MambaState(
            ssm=torch.zeros(lead + (batch, s.n_heads(cfg.d_model), s.head_dim,
                                    s.d_state), dtype=torch.float32,
                            device=device),
            conv=torch.zeros(lead + (batch, s.d_conv - 1,
                                     s.conv_channels(cfg.d_model)),
                             dtype=DTYPE, device=device))
    enc_kv = None
    if cfg.encoder_layers and enc_len:
        shape = (cfg.n_layers, batch, enc_len, KV, Dh)
        enc_kv = KVCache(k=torch.zeros(shape, dtype=DTYPE, device=device),
                         v=torch.zeros(shape, dtype=DTYPE, device=device))
    return Caches(kv=kv, length=0, ssm=ssm, enc_kv=enc_kv)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           dist: Dist = NO_DIST):
    """Token embeddings: (B, S, D), or on a mesh one per data row,
    vocab-parallel: position m of the row looks up the ids that fall in
    its stripe of ``embed``'s rows and zeroes the rest; the parts sum on
    the row's device (one part is nonzero, so the sum is exact)."""
    if not dist.active:
        return params["embed"][tokens.long()]
    grid = dist.grid()
    M = grid.shape[1]
    Vm = cfg.padded_vocab // M
    out = []
    for r, t in enumerate(split_rows(tokens, dist)):
        parts = []
        for m in range(M):
            dev = grid[r, m]
            local = t.to(dev).long() - m * Vm
            e = _model_part(params["embed"], dev, 0, m, M)[
                local.clamp(0, Vm - 1)]
            hit = ((local >= 0) & (local < Vm))[..., None]
            parts.append(torch.where(hit, e, torch.zeros((), dtype=e.dtype,
                                                         device=dev)))
        out.append(_psum(parts, t.device))
    return out


def _add(x, y):
    """The residual add, of tensors or of data rows."""
    if isinstance(x, list):
        return [a + b for a, b in zip(x, y)]
    return x + y


def _first_device(dist: Dist):
    return dist.grid()[0, 0]


def _stack_states(ssms: list, convs: list, dist: Dist):
    """Per-layer Mamba2 states → one stacked MambaState: tensors stacked,
    or on a mesh ``Sharded`` leaves (``cache_specs``' layout) stacked
    shard by shard."""
    if not dist.active:
        return MambaState(ssm=torch.stack(ssms), conv=torch.stack(convs))
    return MambaState(ssm=stack_sharded(ssms), conv=stack_sharded(convs))


def _kv_placer(dist: Dist):
    """How a prefill keeps one layer's new (k, v): on a mesh, each data
    row's pair sent to the row's stripes of ``cache_specs``' layout as
    the layer produces it (``Sharded`` (B, S, KV, Dh) leaves, the
    sequence over the row's model positions — over every position for a
    batch of one), so no position holds more than one row's layer whole;
    without a mesh the pair as it is."""
    if not dist.active:
        return lambda kv: kv
    spec = (batch_entry(dist), seq_axes(dist), None, None)
    return lambda kv: tuple(
        shard_rows([pair[i] for pair in kv], spec, dist.mesh)
        for i in range(2))


def _unembedding(params, cfg: ModelConfig, device, m: int = 0,
                 M: int = 1) -> torch.Tensor:
    """Vocabulary stripe m of M of the unembedding (D, V/M) on
    ``device``: ``embed``'s rows transposed when tied, else ``lm_head``'s
    columns (M = 1: the whole, gathered)."""
    if cfg.tie_embeddings:
        return _model_part(params["embed"], device, 0, m, M).T
    return _model_part(params["lm_head"], device, -1, m, M)


def _logits_at(params, h_last, cfg: ModelConfig,
               devices=None) -> torch.Tensor:
    """h_last (B, k, D) → (B, k, V) fp32 logits on h_last's device; with
    ``devices`` (a data row's model positions) vocab-parallel, each
    position's stripe of the logits concatenated."""
    if devices is None:
        return (h_last @ _unembedding(params, cfg, h_last.device)).float()
    M = len(devices)
    return torch.cat([(h_last.to(d) @ _unembedding(params, cfg, d, m, M))
                      .float().to(h_last.device)
                      for m, d in enumerate(devices)], dim=-1)


def _remat(fn, cfg: ModelConfig, train: bool):
    """``fn`` (one layer or one hybrid period), recomputed in the backward
    pass under ``torch.utils.checkpoint`` when a remat config trains —
    where the reference wraps its scan body in ``jax.checkpoint``."""
    if not (train and cfg.remat):
        return fn
    # no layer draws random numbers: nothing to stash for the recompute
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def _ssm_stack(params, x, cfg: ModelConfig, caches, mode: str,
               dist: Dist = NO_DIST):
    """One Mamba2 block per layer, from ``caches.ssm`` if given; returns
    (x, the new stacked MambaState; None in train mode). On a mesh the
    mixers are tensor-parallel and the state stays ``Sharded`` (a
    prefill's is gathered whole on the mesh's first device)."""
    train = mode == "train"
    has_state = caches is not None and caches.ssm is not None

    def block(x, l):
        st = MambaState(ssm=caches.ssm.ssm[l], conv=caches.ssm.conv[l]) \
            if has_state else None
        y, new = mamba_block(x, _layer(params["mamba"], l), cfg, dist,
                             state=st, return_state=not train, train=train)
        return _add(x, y), new

    block = _remat(block, cfg, train)
    ssms, convs = [], []
    for l in range(cfg.n_layers):
        x, new = block(x, l)
        if new is not None:
            ssms.append(new.ssm)
            convs.append(new.conv)
    if train:
        return x, None
    return x, _stack_states(ssms, convs, dist)


def _ffn(x, p, cfg: ModelConfig, use_moe: bool, dist: Dist = NO_DIST):
    """The layer's FFN sub-block → (y, aux loss)."""
    if use_moe:
        return moe_block(x, p, cfg, dist)
    return mlp_block(x, p, cfg, dist), 0.0


def encode(params, frames, cfg: ModelConfig, *,
           train: bool = False) -> torch.Tensor:
    """frames (B, F, D) stub embeddings → (B, F, D) encoder output: a
    bidirectional attention + MLP block per encoder layer, then the
    encoder's final norm. ``train``: each layer is rematerialised in a
    remat config's backward pass."""

    def block(x, l):
        y, _ = attention_block(x, _layer(params["enc_attn"], l), cfg,
                               causal=False)
        x = x + y
        return x + mlp_block(x, _layer(params["enc_mlp"], l), cfg)

    block = _remat(block, cfg, train)
    x = frames.to(DTYPE)
    for l in range(cfg.encoder_layers):
        x = block(x, l)
    return rms_norm(x, params["enc_final_ln"], cfg.norm_eps)


def build_enc_kv(params, enc_out, cfg: ModelConfig) -> KVCache:
    """Each decoder layer's cross-attention K/V of the encoder output
    (B, F, D), rope-free: (L, B, F, KV, Dh) each."""
    B, F, _ = enc_out.shape
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    p = params["cross_attn"]
    return KVCache(
        k=torch.stack([(enc_out @ w).reshape(B, F, KV, Dh) for w in p["wk"]]),
        v=torch.stack([(enc_out @ w).reshape(B, F, KV, Dh) for w in p["wv"]]))


def _self_attention(x, p_a, cfg: ModelConfig, l: int, *, mode: str, caches,
                    q_offset: int, ring: bool, window_override,
                    dist: Dist = NO_DIST, place_kv=None):
    """Attention layer ``l``'s self-attention: the training form (the
    differentiable plain attention, no KV out), the prefill form (new KV
    out, kept by ``place_kv``: ``_kv_placer``) or the extend/decode form
    over ``caches.kv[l]`` at ``caches.length``."""
    if mode == "train":
        return attention_block(x, p_a, cfg, dist, q_offset=q_offset,
                               window_override=window_override, train=True)
    if mode == "prefill":
        y, kv = attention_block(x, p_a, cfg, dist, q_offset=q_offset,
                                kv_out=True, window_override=window_override)
        return y, (kv if place_kv is None else place_kv(kv))
    return attention_block(x, p_a, cfg, dist, cache=(caches.kv.k[l],
                                                     caches.kv.v[l]),
                           cache_len=caches.length, ring=ring,
                           window_override=window_override)


def _enc_kv_at(e, l: int, dist: Dist):
    """Layer l's cross-attention K/V: a pair, or on a mesh one pair per
    data row (per-row caches, or a row's part of ``Sharded`` ones)."""
    if isinstance(e, list):
        return [(r.k[l], r.v[l]) for r in e]
    if dist.active and isinstance(e.k, Sharded):
        n = dist.grid().shape[0]
        return [(_row_stripes(e.k[l], dist, r, n)[0],
                 _row_stripes(e.v[l], dist, r, n)[0]) for r in range(n)]
    return e.k[l], e.v[l]


def _uniform_stack(params, x, cfg: ModelConfig, *, mode: str,
                   caches, q_offset: int, ring: bool, window_override,
                   dist: Dist = NO_DIST, place_kv=None):
    """One attention + FFN (MLP or MoE) block per layer, with a
    cross-attention over ``caches.enc_kv`` after each self-attention of
    an encoder-decoder; returns (x, the summed MoE aux loss, per-layer
    kv)."""
    use_moe = _use_moe(cfg)
    p_f = params["moe"] if use_moe else params["mlp"]
    cross = cfg.encoder_layers > 0
    if cross and (caches is None or caches.enc_kv is None):
        raise ValueError(f"{cfg.name} cross-attends its encoder: the caches "
                         f"need enc_kv (prefill(frames=...) builds it)")

    def block(x, aux, l):
        y, kv = _self_attention(x, _layer(params["attn"], l), cfg, l,
                                mode=mode, caches=caches, q_offset=q_offset,
                                ring=ring, window_override=window_override,
                                dist=dist, place_kv=place_kv)
        x = _add(x, y)
        if cross:
            y, _ = attention_block(
                x, _layer(params["cross_attn"], l), cfg, dist,
                enc_kv=_enc_kv_at(caches.enc_kv, l, dist))
            x = _add(x, y)
        y, a = _ffn(x, _layer(p_f, l), cfg, use_moe, dist)
        return _add(x, y), aux + a, kv

    block = _remat(block, cfg, mode == "train")
    kvs, aux = [], 0.0
    for l in range(cfg.n_layers):
        x, aux, kv = block(x, aux, l)
        kvs.append(kv)
    return x, aux, kvs


def _hybrid_stack(params, x, cfg: ModelConfig, *, mode: str, caches,
                  q_offset: int, ring: bool, window_override,
                  dist: Dist = NO_DIST, place_kv=None):
    """The jamba period stack: each period is [attention, Mamba2 ×
    (attn_every - 1)], an FFN after every mixer — MoE at the in-period
    positions ``pos % moe.every == moe.every - 1``, a dense MLP at the
    others. In decode the period's attention layer reads ``caches.kv[p]``
    and its Mamba2 layer j ``caches.ssm[p, j]``. Returns (x, the summed
    MoE aux loss, per-period kv, the new (periods, attn_every - 1, ...)
    MambaState; None in train mode)."""
    period, every = cfg.attn_every, cfg.moe.every
    train = mode == "train"
    has_state = caches is not None and caches.ssm is not None

    def period_block(x, aux, per):
        p_m = _layer(params["mamba"], per)
        p_fd = _layer(params["ffn_dense"], per)
        p_fm = _layer(params["ffn_moe"], per)
        i_d = i_m = 0
        kv, per_ssm, per_conv = None, [], []
        for pos in range(period):
            if pos == 0:
                y, kv = _self_attention(
                    x, _layer(params["attn"], per), cfg, per, mode=mode,
                    caches=caches, q_offset=q_offset, ring=ring,
                    window_override=window_override, dist=dist,
                    place_kv=place_kv)
            else:
                st = MambaState(ssm=caches.ssm.ssm[per][pos - 1],
                                conv=caches.ssm.conv[per][pos - 1]) \
                    if has_state else None
                y, new = mamba_block(x, _layer(p_m, pos - 1), cfg, dist,
                                     state=st, return_state=not train,
                                     train=train)
                if new is not None:
                    per_ssm.append(new.ssm)
                    per_conv.append(new.conv)
            x = _add(x, y)
            if pos % every == every - 1:
                y, a = moe_block(x, _layer(p_fm, i_m), cfg, dist)
                aux = aux + a
                i_m += 1
            else:
                y = mlp_block(x, _layer(p_fd, i_d), cfg, dist)
                i_d += 1
            x = _add(x, y)
        state = None if train else _stack_states(per_ssm, per_conv, dist)
        return x, aux, kv, state

    period_block = _remat(period_block, cfg, train)
    kvs, ssms, convs, aux = [], [], [], 0.0
    for per in range(cfg.n_layers // period):
        x, aux, kv, state = period_block(x, aux, per)
        kvs.append(kv)
        if state is not None:
            ssms.append(state.ssm)
            convs.append(state.conv)
    if train:
        return x, aux, kvs, None
    return x, aux, kvs, _stack_states(ssms, convs, dist)


def _run_stack(params, x, cfg: ModelConfig, *, mode: str, caches,
               q_offset: int = 0, ring: bool = False, window_override=None,
               dist: Dist = NO_DIST, place_kv=None):
    """The decoder stack of any family → (h, the summed MoE aux loss,
    per-layer kv or None, the new stacked MambaState or None). ``mode``
    "train" returns no caches (kv and state None). On a mesh (``dist``)
    x and h are lists of data rows, a layer's prefill kv one (k, v) per
    row unless ``place_kv`` keeps it otherwise (``_kv_placer``); in the
    decode mode the caches are ``Sharded`` and the KV is written in
    place."""
    if cfg.kind == "ssm":
        h, ssm = _ssm_stack(params, x, cfg, caches, mode, dist)
        return h, 0.0, None, ssm
    if cfg.attn_every:
        h, aux, kvs, ssm = _hybrid_stack(params, x, cfg, mode=mode,
                                         caches=caches, q_offset=q_offset,
                                         ring=ring,
                                         window_override=window_override,
                                         dist=dist, place_kv=place_kv)
    else:
        h, aux, kvs = _uniform_stack(params, x, cfg, mode=mode,
                                     caches=caches, q_offset=q_offset,
                                     ring=ring,
                                     window_override=window_override,
                                     dist=dist, place_kv=place_kv)
        ssm = None
    return h, aux, (None if mode == "train" else kvs), ssm


def _unembed_chunked(params, h, labels, cfg: ModelConfig) -> torch.Tensor:
    """Chunked cross-entropy: the mean over unmasked positions (label
    < 0 is masked) of -log softmax(h @ w)[label], over ``CE_CHUNK``-token
    slices, so the (B, S, V) fp32 logits never exist at once. As in the
    reference, S splits into ``max(S // CE_CHUNK, 1)`` equal slices and a
    remainder past them is left out."""
    tot, cnt = _ce_sums(params, h, labels, cfg)
    return tot / torch.clamp(cnt, min=1.0)


def _ce_sums(params, h, labels, cfg: ModelConfig, devices=None):
    """``_unembed_chunked``'s (summed loss, unmasked count), over the
    unembedding gathered whole on h's device; with ``devices`` (a data
    row's model positions) vocab-parallel: each position's stripe of a
    slice's logits gives its max, its Σexp and the gold logit where the
    label falls in the stripe, combined on h's device into logsumexp −
    gold in fp32."""
    B, S, _ = h.shape
    V = cfg.padded_vocab
    n = max(S // CE_CHUNK, 1)
    C = S // n
    if devices is None:
        w = _unembedding(params, cfg, h.device)
    else:
        M = len(devices)
        ws = [_unembedding(params, cfg, d, m, M)
              for m, d in enumerate(devices)]
    tot = cnt = 0.0
    for i in range(n):
        hc, lc = h[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
        label = lc.clamp(0, V - 1).long()
        if devices is None:
            logits = (hc @ w).float()                          # (B, C, V)
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, label[..., None])[..., 0]
        else:
            logz, gold = _ce_stripes(hc, label, ws, devices)
        mask = (lc >= 0).float()
        tot = tot + torch.sum((logz - gold) * mask)
        cnt = cnt + torch.sum(mask)
    return tot, cnt


def _ce_stripes(hc, label, ws, devices):
    """One slice's (logsumexp, gold logit) from the vocabulary stripes
    ``ws`` on ``devices``, on hc's device. The stripes' maxes are
    constants to autograd (logsumexp does not depend on the shift)."""
    Vm = ws[0].shape[-1]
    maxes, sums, golds = [], [], []
    for m, (d, w) in enumerate(zip(devices, ws)):
        logits = (hc.to(d) @ w).float()                       # (B, C, V/M)
        mx = logits.amax(-1).detach()
        s = torch.exp(logits - mx[..., None]).sum(-1)
        local = label.to(d) - m * Vm
        g = torch.gather(logits, -1, local.clamp(0, Vm - 1)[..., None])[..., 0]
        g = torch.where((local >= 0) & (local < Vm), g, 0.0)
        with collective("all-reduce"):
            sums.append(s.to(hc.device))
            maxes.append(mx.to(hc.device))
            golds.append(g.to(hc.device))
    mx = torch.stack(maxes).amax(0)
    z = sums[0] * torch.exp(maxes[0] - mx)
    gold = golds[0]
    for s, m_, g in zip(sums[1:], maxes[1:], golds[1:]):
        z = z + s * torch.exp(m_ - mx)
        gold = gold + g
    return mx + torch.log(z), gold


_ENCODER_KEYS = ("enc_attn", "enc_mlp", "enc_final_ln", "cross_attn")


def _encoder_kv(params, frames, cfg: ModelConfig, dist: Dist, train: bool):
    """The cross-attention K/V of the encoded ``frames``: one KVCache, or
    on a mesh one per data row (the encoder's leaves gathered whole on
    the row's device)."""
    if not dist.active:
        return build_enc_kv(params, encode(params, frames, cfg, train=train),
                            cfg)
    out = []
    for f in split_rows(frames, dist):
        sub = gather_tree({k: params[k] for k in _ENCODER_KEYS}, f.device)
        out.append(build_enc_kv(sub, encode(sub, f, cfg, train=train), cfg))
    return out


def _prepend(x, patches, dist: Dist):
    """The patch frontend: the patch embeddings ahead of the tokens'."""
    if not dist.active:
        return torch.cat([patches.to(DTYPE), x], dim=1)
    return [torch.cat([p.to(DTYPE), xr], dim=1)
            for p, xr in zip(split_rows(patches, dist), x)]


def loss_fn(params, batch: dict, cfg: ModelConfig,
            dist: Dist = NO_DIST) -> torch.Tensor:
    """Training loss: the chunked next-token cross-entropy plus 0.01 ×
    the summed MoE load-balance aux loss. ``batch``: tokens and labels
    (B, S) integer tensors, and an encoder-decoder's ``frames`` or the
    patch frontend's ``patches`` (B, F, d_model). The forward runs in
    train mode: every attention and scan is a differentiable plain op,
    no kernel is launched, and a remat config recomputes each layer in
    the backward pass. On a mesh the batch splits over the data rows and
    the cross-entropy is the rows' summed loss over their summed count,
    on the mesh's first device."""
    x = _embed(params, batch["tokens"], cfg, dist)
    labels = batch["labels"]
    caches = None
    if cfg.encoder_layers:       # whisper: encode stub frames, cross-attend
        caches = Caches(kv=None, length=0, enc_kv=_encoder_kv(
            params, batch["frames"], cfg, dist, train=True))
    elif cfg.frontend == "patch":    # vlm: prepend the patch embeddings
        patches = batch["patches"]
        x = _prepend(x, patches, dist)
        pad = torch.full(patches.shape[:2], -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    h, aux, _, _ = _run_stack(params, x, cfg, mode="train", caches=caches,
                              dist=dist)
    if not dist.active:
        h = rms_norm(h, params["final_ln"], cfg.norm_eps)
        return _unembed_chunked(params, h, labels, cfg) + 0.01 * aux
    dev = _first_device(dist)
    grid = dist.grid()
    sums = [_ce_sums(params, rms_norm(hr, gather(params["final_ln"],
                                                 hr.device), cfg.norm_eps),
                     lr, cfg, grid[r]) for r, (hr, lr) in
            enumerate(zip(h, split_rows(labels, dist)))]
    with collective("all-reduce"):
        tot = sum(t.to(dev) for t, _ in sums)
        cnt = sum(c.to(dev) for _, c in sums)
    return tot / torch.clamp(cnt, min=1.0) + 0.01 * aux


def prefill(params, tokens, cfg: ModelConfig, dist: Dist = NO_DIST, *,
            frames=None, patches=None, q_offset: int = 0,
            window_override=None):
    """Full-sequence prefill of tokens (B, S). An encoder-decoder encodes
    ``frames`` (B, F, D) first and builds the cross-attention K/V; the
    patch frontend prepends ``patches`` (B, P, D) to the embedded tokens
    (the length counts them). Returns (last-position logits (B, V) fp32,
    Caches holding the exact-length KV, the final SSM state and the
    encoder's K/V).

    On a mesh (``dist``) the logits are joined on the mesh's first
    device (the reference's ``P()``) and the caches are ``Sharded`` by
    ``launch.steps.cache_specs`` (``shard_caches``' layout, which
    ``decode_step`` takes as it is): each layer's KV sent to its data
    row's sequence stripes as the layer produces it, the Mamba2 state
    heads and conv channels over 'model', the encoder's K/V by batch.
    A sequence that does not split over the stripes raises
    ``ValueError``."""
    x = _embed(params, tokens, cfg, dist)
    enc_kv = None
    if cfg.encoder_layers:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             f"prefill needs frames")
        enc_kv = _encoder_kv(params, frames, cfg, dist, train=False)
    elif cfg.frontend == "patch" and patches is not None:
        x = _prepend(x, patches, dist)
    h, _, kvs, ssm = _run_stack(params, x, cfg, mode="prefill",
                                caches=Caches(kv=None, length=0,
                                              enc_kv=enc_kv),
                                q_offset=q_offset,
                                window_override=window_override, dist=dist,
                                place_kv=_kv_placer(dist))
    kv = None
    if dist.active:
        logits = join_rows([_logits_at(params, rms_norm(
            hr[:, -1:, :], gather(params["final_ln"], hr.device),
            cfg.norm_eps), cfg, dist.grid()[r])[:, 0]
            for r, hr in enumerate(h)], _first_device(dist))
        if kvs:
            kv = KVCache(k=stack_sharded([k for k, _ in kvs]),
                         v=stack_sharded([v for _, v in kvs]))
        if enc_kv is not None:
            spec = (None, batch_entry(dist), None, None, None)
            enc_kv = KVCache(*(shard_rows([e[i] for e in enc_kv], spec,
                                          dist.mesh, batch_dim=1)
                               for i in range(2)))
        n_new = h[0].shape[1]
    else:
        h = rms_norm(h, params["final_ln"], cfg.norm_eps)
        logits = _logits_at(params, h[:, -1:, :], cfg)[:, 0]
        n_new = x.shape[1]
        if kvs:
            kv = KVCache(k=torch.stack([k for k, _ in kvs]),
                         v=torch.stack([v for _, v in kvs]))
    return logits, Caches(kv=kv, length=q_offset + n_new, ssm=ssm,
                          enc_kv=enc_kv)


def decode_step(params, tokens, caches: Caches, cfg: ModelConfig,
                dist: Dist = NO_DIST, *, ring: bool = False,
                window_override=None):
    """tokens (B, S) against preallocated caches (KV written in place; an
    SSM or hybrid state continues from ``caches.ssm`` and is returned
    anew; an encoder-decoder cross-attends ``caches.enc_kv``).
    ``ring``: the KV cache is a sliding-window ring buffer (S = 1).
    Returns (logits (B, S, V) fp32, caches with the length advanced).

    On a mesh (``dist``): the caches are ``Sharded`` by
    ``launch.steps.cache_specs`` (``shard_caches``) at an int length,
    the attention context-parallel over the KV stripes, the mixers
    tensor-parallel; the new state is ``Sharded`` like the old, the
    logits joined on the mesh's first device."""
    x = _embed(params, tokens, cfg, dist)
    h, _, _, ssm = _run_stack(params, x, cfg, mode="decode", caches=caches,
                              ring=ring, window_override=window_override,
                              dist=dist)
    if dist.active:
        grid = dist.grid()
        logits = join_rows([_logits_at(params, rms_norm(
            hr, gather(params["final_ln"], hr.device), cfg.norm_eps), cfg,
            grid[r]) for r, hr in enumerate(h)], _first_device(dist))
    else:
        h = rms_norm(h, params["final_ln"], cfg.norm_eps)
        logits = _logits_at(params, h, cfg)
    return logits, caches._replace(length=caches.length + tokens.shape[1],
                                   ssm=ssm if ssm is not None else caches.ssm)


def decode_step_paged(params, tokens, k_pages, v_pages, block_table,
                      seq_lens, cfg: ModelConfig, *, window_override=None,
                      shard: Optional[PagedShard] = None):
    """One continuous-batching decode iteration over the PAGED store.

    tokens (B, 1); k/v_pages (L, P, page, KV, Dh), written in place;
    block_table (B, max_pages) int32 (0-padded with the null page);
    seq_lens (B,) int32 tokens already written per slot. Returns
    (logits (B, 1, V) fp32, k_pages, v_pages). Uniform attention stacks
    only: a hybrid, SSM or encoder-decoder stack decodes with
    ``decode_step``. With ``shard`` (``decode_step_paged_sharded``),
    k/v_pages are the data shard's per-stripe slabs, one (L, P, page,
    KV/m, Dh) per model position."""
    if cfg.attention_layers != cfg.n_layers or cfg.encoder_layers:
        raise ValueError(f"paged decode covers uniform attention stacks; "
                         f"{cfg.name} ({cfg.kind}) decodes with decode_step")
    use_moe = _use_moe(cfg)
    p_f = params["moe"] if use_moe else params["mlp"]
    x = _embed(params, tokens, cfg)
    for l in range(cfg.n_layers):
        if shard is None:
            kp, vp = k_pages[l], v_pages[l]
        else:
            kp, vp = [s[l] for s in k_pages], [s[l] for s in v_pages]
        x = x + paged_attention_block(
            x, _layer(params["attn"], l), cfg, k_pages=kp, v_pages=vp,
            block_table=block_table, seq_lens=seq_lens,
            window_override=window_override, shard=shard)
        x = x + _ffn(x, _layer(p_f, l), cfg, use_moe)[0]
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _logits_at(params, h, cfg), k_pages, v_pages


def paged_supported_cfg(cfg: ModelConfig) -> bool:
    return cfg.attention_layers == cfg.n_layers and not cfg.encoder_layers


def paged_shard_reason(cfg: ModelConfig, model_shards: int,
                       data_shards: int = 1) -> str:
    """Why the sharded paged decode step can NOT cover ``cfg`` on a
    (data, model) mesh — empty string when it can. KV heads stripe over
    the model axis only for grouped GQA (contiguous query-head groups per
    KV head; the padded ``qh2kv`` remap scatters query heads across KV
    heads, so a head stripe is not self-contained). The reference's rules
    and strings."""
    if not paged_supported_cfg(cfg):
        return "paged decode covers uniform attention stacks only"
    if cfg.moe is not None and cfg.moe.every == 1:
        return ("MoE layers route through their own shard_map dispatch; "
                "the sharded paged step covers dense-MLP stacks")
    if model_shards > 1:
        Hp, KV = cfg.padded_heads, cfg.n_kv_heads
        if not (Hp == cfg.n_heads and Hp % KV == 0):
            return (f"model-parallel KV heads need grouped GQA "
                    f"(padded_heads == n_heads, divisible groups); "
                    f"{cfg.name} pads {cfg.n_heads}→{Hp} query heads "
                    f"over {KV} KV heads")
        if KV % model_shards != 0:
            return (f"n_kv_heads={KV} not divisible by model axis "
                    f"{model_shards}")
    del data_shards   # any data axis works: slots shard row-wise
    return ""


def decode_step_paged_sharded(params, tokens, k_pages, v_pages, block_table,
                              seq_lens, cfg: ModelConfig, mesh, *,
                              window_override=None):
    """``decode_step_paged`` over a (data, model) mesh, one controller:
    decode slots data-parallel (data shard i takes rows [i·B/d, (i+1)·B/d)
    of tokens, table and lengths; every per-slot op is row-independent),
    KV heads model-parallel (``paged_attention_block``'s ``shard``
    branch: each stripe written and attended on its own position's
    device, combined by an exact head concatenation).

    params: the weights once per distinct mesh device
    (``launch.mesh.replicate_params``); a data shard computes on its
    first model position's device. k/v_pages: [data][model] nested
    sequences of (L, P_bank, page, KV/m, Dh) slabs (``DevicePagePool``'s
    ``slabs``). block_table (B, W) holds BANK-LOCAL page ids (each data
    shard's rows index its own bank; the pool converts global → local
    host-side), seq_lens (B,). Returns (logits (B, 1, V) fp32 in row
    order on the mesh's first device, k_pages, v_pages)."""
    m = int(mesh.shape.get("model", 1))
    d = int(mesh.shape.get("data", 1))
    reason = paged_shard_reason(cfg, m, d)
    if reason:
        raise ValueError(f"cannot shard paged decode over {d}x{m}: {reason}")
    B = tokens.shape[0]
    if B % d:
        raise ValueError(f"{B} slots do not split over data={d}")
    bl = B // d
    logits = []
    for di in range(d):
        r = slice(di * bl, (di + 1) * bl)
        devs = tuple(mesh.devices[di, mi] for mi in range(m))
        tables = {dev: (block_table[r].to(dev), seq_lens[r].to(dev))
                  for dev in dict.fromkeys(devs)}
        shard = PagedShard(devices=devs,
                           block_tables=tuple(tables[v][0] for v in devs),
                           seq_lens=tuple(tables[v][1] for v in devs))
        lead = devs[0]
        lg, _, _ = decode_step_paged(
            params[lead], tokens[r].to(lead), k_pages[di], v_pages[di],
            tables[lead][0], tables[lead][1], cfg,
            window_override=window_override, shard=shard)
        logits.append(lg)
    out = mesh.devices[0, 0]
    return torch.cat([lg.to(out) for lg in logits]), k_pages, v_pages
