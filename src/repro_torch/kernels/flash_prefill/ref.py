"""Plain PyTorch version of chunked-prefill flash attention (the port of
the reference's ``flash_prefill_ref``): fp32 logits and probabilities,
``-inf`` masking, output cast to q's dtype. ``qh2kv`` (H,) adds the
explicit query-head → KV-head map the serving path needs for padded
GQA; ``None`` is the grouped layout, h // (H // KV).

``flash_prefill_split_ref`` is the kernel's decomposition of the same
function: each 64-row query tile's keys are cut into ``n_splits`` runs of
whole 64-key tiles (``split_tiles``), each run gives an unnormalised
partial (o, m, l), and a log-sum-exp combine merges them."""
from __future__ import annotations

import torch

TILE = 64   # query rows per tile and keys per key tile, as in the kernel


def _head_map(q, k, qh2kv):
    H, KV = q.shape[2], k.shape[2]
    if qh2kv is None:
        qh2kv = torch.arange(H, device=q.device) // (H // KV)
    return qh2kv.long().to(k.device)


def _mask(qpos, kpos, window: int):
    mask = qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def flash_prefill_ref(q, k, v, *, q_offset: int = 0, window: int = 0,
                      qh2kv=None) -> torch.Tensor:
    """q (B, Sq, H, D) at absolute positions q_offset + [0, Sq);
    k, v (B, Sk, KV, D) at positions [0, Sk). Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    idx = _head_map(q, k, qh2kv)
    k_exp = k.index_select(2, idx)                    # (B, Sk, H, D)
    v_exp = v.index_select(2, idx)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = _mask(qpos, kpos, window)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_exp.float()) / (D ** 0.5)
    logits = logits.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = torch.where(torch.isfinite(logits), probs, 0.0)
    den = probs.sum(-1, keepdim=True)
    probs = probs / torch.clamp(den, min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_exp.float())
    return out.to(q.dtype)


def split_tiles(m0: int, Sq: int, Sk: int, q_offset: int, window: int,
                n_splits: int) -> list:
    """The key tiles of the query tile at row m0, cut into ``n_splits``
    runs of whole 64-key tiles: a list of (first key, end key) per split,
    (k, k) for an empty split. The tile's keys run from its window start
    (rounded down to a tile) to min(Sk, q_offset + last row + 1); the
    kernel cuts them the same way."""
    last = min(m0 + TILE, Sq) - 1
    k_hi = min(Sk, q_offset + last + 1)
    k_lo = max(0, q_offset + m0 - window + 1) if window > 0 else 0
    k_lo = k_lo // TILE * TILE
    n_tiles = max(0, -(-(k_hi - k_lo) // TILE))
    per = -(-n_tiles // n_splits)
    runs = []
    for s in range(n_splits):
        t0, t1 = min(n_tiles, s * per), min(n_tiles, (s + 1) * per)
        runs.append((min(k_hi, k_lo + t0 * TILE),
                     min(k_hi, k_lo + t1 * TILE)))
    return runs


def flash_prefill_split_ref(q, k, v, *, q_offset: int = 0, window: int = 0,
                            qh2kv=None, n_splits: int = 1) -> torch.Tensor:
    """The same function as ``flash_prefill_ref``, computed as the kernel
    computes it with ``n_splits`` > 1: per (query tile, split) an fp32
    partial o = Σ e^{s − m} v, m = max s, l = Σ e^{s − m} (m = −inf and
    l = 0 where a row sees no key of the split), then out = Σ_s e^{m_s − M}
    o_s / Σ_s e^{m_s − M} l_s with M = max_s m_s, splits with m_s = −inf
    weighed 0."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    idx = _head_map(q, k, qh2kv)
    k_exp = k.index_select(2, idx).float()
    v_exp = v.index_select(2, idx).float()
    out = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    for m0 in range(0, Sq, TILE):
        qt = q[:, m0:m0 + TILE].float()
        qpos = q_offset + m0 + torch.arange(qt.shape[1], device=q.device)
        parts = []
        for lo, hi in split_tiles(m0, Sq, Sk, q_offset, window, n_splits):
            kpos = torch.arange(lo, hi, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qt, k_exp[:, lo:hi]) \
                / (D ** 0.5)
            s = s.masked_fill(~_mask(qpos, kpos, window)[None, None],
                              float("-inf"))
            m = s.amax(-1) if hi > lo else torch.full(
                s.shape[:-1], float("-inf"), device=q.device)
            mu = torch.where(torch.isfinite(m), m, 0.0)
            p = torch.exp(s - mu[..., None])
            parts.append((torch.einsum("bhqk,bkhd->bhqd", p, v_exp[:, lo:hi]),
                          m, p.sum(-1)))
        M = torch.stack([m for _, m, _ in parts]).amax(0)          # (B,H,q)
        num = torch.zeros_like(parts[0][0])
        den = torch.zeros_like(M)
        for o, m, l in parts:
            w = torch.where(torch.isfinite(m),
                            torch.exp(m - torch.where(torch.isfinite(M), M,
                                                      0.0)), 0.0)
            num = num + o * w[..., None]
            den = den + l * w
        res = torch.where(den[..., None] > 0,
                          num / torch.clamp(den, min=1e-30)[..., None], 0.0)
        out[:, m0:m0 + TILE] = res.permute(0, 2, 1, 3)
    return out.to(q.dtype)
