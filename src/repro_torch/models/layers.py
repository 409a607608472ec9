"""Transformer building blocks in PyTorch (bf16 compute, fp32 reductions)
— the counterparts of the reference's ``repro/models/layers.py`` for the
dense serving path.

Attention keeps the reference's numerics on its plain paths (``_attend``:
fp32 logits, a -1e30 mask, fp32 softmax, probabilities cast to bf16
before the PV product). On CUDA tensors the two hot spots go to the
hand-written kernels: ``causal_attention`` to the chunked-prefill kernel
and ``paged_attention_block`` to the paged decode kernel, each given the
KV-headed cache plus the query-head → KV-head map, so the per-query-head
KV expansion the reference does with ``jnp.take`` is never materialised
on the card. ``decode_attention``, the dense per-slot oracle, stays plain.

PyTorch runs eagerly, so a chunk's ``q_offset`` is a plain Python int and
caches are updated in place where the reference rebinds functionally.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_prefill.ops import flash_prefill_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPE = torch.bfloat16
NEG_INF = -1e30
# Query-chunk length of the plain causal path (bounds the logits buffer).
ATTN_CHUNK_Q = 1024

_FORCE_PLAIN = False


@contextlib.contextmanager
def plain_attention():
    """Run attention through the plain PyTorch versions even on CUDA
    tensors — for holding the kernel path against the plain one on the
    card. Never entered on the serving path."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (B, S, H, D); positions (B, S) or (S,) integer tensor."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs            # (B, S, d/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _qh2kv_cached(n_q: int, n_kv: int, padded_q: int, device: str):
    group = max(n_q // max(n_kv, 1), 1)
    idx = [min(h // group, n_kv - 1) if h < n_q else 0
           for h in range(padded_q)]
    return torch.tensor(idx, dtype=torch.int32, device=device)


def qh2kv_map(n_q: int, n_kv: int, padded_q: int,
              device="cpu") -> torch.Tensor:
    """Padded-query-head → KV-head map (llama grouping; padded heads read
    KV head 0). int32 (padded_q,), cached per device."""
    return _qh2kv_cached(n_q, n_kv, padded_q, str(torch.device(device)))


def _grouped(cfg: ModelConfig) -> bool:
    """Query heads unpadded and divisible by KV: the contiguous (KV, g)
    grouping equals the qh2kv map, no explicit map needed."""
    return cfg.padded_heads == cfg.n_heads \
        and cfg.padded_heads % cfg.n_kv_heads == 0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask, scale):
    """q (B, Sq, H, D); k, v (B, Sk, H, D) or grouped (B, Sk, KV, D) with
    H = KV·g; mask (B|1, 1, Sq, Sk) bool → (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        g = H // KV
        qg = q.reshape(B, Sq, KV, g, D)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                              k.float()) * scale
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                         v.float())
        return o.reshape(B, Sq, H, D).to(v.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def _expand(t: torch.Tensor, qh2kv: Optional[torch.Tensor]) -> torch.Tensor:
    return t if qh2kv is None else t.index_select(2, qh2kv.long())


def causal_attention(q, k, v, q_offset: int, window: int = 0,
                     chunk_q: int = ATTN_CHUNK_Q, *, qh2kv=None):
    """Causal (optionally sliding-window) attention over a full K/V.

    q (B, Sq, H, D) at absolute positions q_offset + [0, Sq); k, v
    (B, Sk, KV, D) at positions [0, Sk), Sk ≥ q_offset + Sq, with KV = H
    (expanded), KV | H (grouped) or any KV with ``qh2kv`` (H,).
    CUDA: the chunked-prefill kernel. CPU: ``_attend`` over query chunks.
    """
    q_offset = int(q_offset)
    if q.is_cuda and not _FORCE_PLAIN:
        return flash_prefill_attention(q, k, v, q_offset=q_offset,
                                       window=window, qh2kv=qh2kv)
    k, v = _expand(k, qh2kv), _expand(v, qh2kv)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for lo in range(0, Sq, chunk_q):
        hi = min(lo + chunk_q, Sq)
        qpos = q_offset + torch.arange(lo, hi, device=q.device)
        m = qpos[:, None] >= kpos[None, :]
        if window:
            m &= (qpos[:, None] - kpos[None, :]) < window
        outs.append(_attend(q[:, lo:hi], k, v, m[None, None], scale))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len, window: int = 0):
    """One-token attention against a linear cache (the dense per-slot
    oracle; plain PyTorch on every device, as in the reference).

    q (B, 1, H, D); k/v_cache (B, S_cache, H|KV, D) with RoPE applied at
    write time; ``cache_len`` counts tokens written including the current
    one — int or (B,) tensor."""
    B, S, _, D = k_cache.shape
    scale = 1.0 / (D ** 0.5)
    clen = torch.as_tensor(cache_len, device=q.device).long()
    if clen.dim() == 1:
        clen = clen[:, None]                                   # (B, 1)
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < torch.clamp(clen, max=S)                     # (1|B, S)
    if window and S > window:
        valid &= pos >= clen - window
    return _attend(q, k_cache, v_cache, valid[:, None, None, :], scale)


def _qkv(x, p, cfg: ModelConfig):
    B, S, _ = x.shape
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, Hp, Dh)
    k = (h @ p["wk"]).reshape(B, S, KV, Dh)
    v = (h @ p["wv"]).reshape(B, S, KV, Dh)
    if cfg.attn_bias:
        q = q + p["bq"].reshape(1, 1, Hp, Dh)
        k = k + p["bk"].reshape(1, 1, KV, Dh)
        v = v + p["bv"].reshape(1, 1, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_block(x, p, cfg: ModelConfig, *, q_offset: int = 0,
                    cache=None, cache_len=None, kv_out: bool = False,
                    window_override: Optional[int] = None):
    """Self-attention sub-block: norm → qkv → rope → attend → out proj.

    Returns (y, kv):
      * prefill (``cache`` None): the new (k, v) if ``kv_out`` else None;
      * extend/decode (``cache`` = (k_cache, v_cache), (B, S_cache, KV,
        Dh)): the S new tokens are written IN PLACE at ``cache_len`` — an
        int (uniform batch: chunked prefill, the causal kernel's runtime
        q_offset) or a (B,) tensor (continuous batching: dense decode) —
        and the updated cache is returned.
    """
    B, S, _ = x.shape
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if window_override is None else window_override
    qh2kv = None if _grouped(cfg) else qh2kv_map(cfg.n_heads, KV, Hp,
                                                 x.device)
    q, k, v = _qkv(x, p, cfg)
    ar = torch.arange(S, device=x.device)

    if cache is None:
        positions = q_offset + ar
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = causal_attention(q, k, v, q_offset, window, qh2kv=qh2kv)
        y = o.reshape(B, S, Hp * Dh) @ p["wo"]
        return y, ((k, v) if kv_out else None)

    k_cache, v_cache = cache
    per_seq = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if per_seq:
        pos = cache_len.to(x.device).long()
        positions = pos[:, None] + ar[None, :]                   # (B, S)
    else:
        pos = int(cache_len)
        positions = (pos + ar)[None, :].expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if per_seq:
        rows = torch.arange(B, device=x.device)[:, None]
        k_cache[rows, positions] = k
        v_cache[rows, positions] = v
        o = decode_attention(q, _expand(k_cache, qh2kv),
                             _expand(v_cache, qh2kv), pos + S, window)
    else:
        k_cache[:, pos:pos + S] = k
        v_cache[:, pos:pos + S] = v
        o = causal_attention(q, k_cache, v_cache, pos, window, qh2kv=qh2kv)
    y = o.reshape(B, S, Hp * Dh) @ p["wo"]
    return y, (k_cache, v_cache)


def paged_attention_block(x, p, cfg: ModelConfig, *, k_pages, v_pages,
                          block_table, seq_lens,
                          window_override: Optional[int] = None):
    """Decode attention sub-block over one layer's PAGED KV store:
    norm → qkv → rope at each slot's depth → scatter the new token's K/V
    into the slot's tail page → attend through the block table.

    x (B, 1, D); k/v_pages (P, page, KV, Dh), updated IN PLACE (the
    reference rebinds ``.at[].set``); block_table (B, max_pages) int32;
    seq_lens (B,) int32 tokens already written per slot. The engine makes
    every active slot's tail page exclusively owned before the step
    (copy-on-write), and inactive slots (length 0, table row 0) write the
    null page 0, which is never read. Returns y (B, 1, D).
    """
    B, S, _ = x.shape
    assert S == 1, "paged decode is one token per slot per step"
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if window_override is None else window_override
    qh2kv = None if _grouped(cfg) else qh2kv_map(cfg.n_heads, KV, Hp,
                                                 x.device)
    q, k, v = _qkv(x, p, cfg)
    pos = seq_lens
    positions = pos.long()[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    pt = k_pages.shape[1]
    pidx = torch.clamp(pos.long() // pt, 0, block_table.shape[1] - 1)
    pids = block_table[torch.arange(B, device=x.device), pidx].long()
    offs = pos.long() % pt
    k_pages[pids, offs] = k[:, 0]
    v_pages[pids, offs] = v[:, 0]

    lens = (pos + 1).to(torch.int32)
    attend = paged_attention_ref if x.is_cuda and _FORCE_PLAIN \
        else paged_decode_attention
    o = attend(q[:, 0], k_pages, v_pages, block_table, lens, qh2kv=qh2kv,
               window=window)
    return o.reshape(B, S, Hp * Dh) @ p["wo"]


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_block(x, p, cfg: ModelConfig):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    gate = F.silu(h @ p["w1"])
    up = h @ p["w3"]
    return (gate * up) @ p["w2"]
