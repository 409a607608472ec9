"""Plain PyTorch versions of paged decode attention (the port of the
reference's ``paged_attention_ref`` and ``paged_attention_layers_ref``).

Numerics mirror the dense decode path (``models.layers._attend``): fp32
logits, -1e30 masking, fp32 softmax, probabilities cast to the value
dtype before the PV product (done here in fp32 and rounded once). The
paged and dense substrates then differ only in WHERE the KV bytes live.

Head layouts: grouped GQA (``qh2kv=None``, H % KV == 0, query head h
reads KV head h // (H // KV)) or an explicit ``qh2kv`` (H,) map for
padded GQA (smollm: 16 padded query heads over 5 KV heads).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _linearise(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(P, page, KV, D) pages + (B, max_pages) table -> (B, S, KV, D)."""
    g = pages[block_table.long()]             # (B, max_pages, page, KV, D)
    B = g.shape[0]
    return g.reshape(B, g.shape[1] * g.shape[2], *g.shape[3:])


def _valid_mask(S: int, seq_lens: torch.Tensor, window: int) -> torch.Tensor:
    clen = seq_lens.long()[:, None]                             # (B, 1)
    pos = torch.arange(S, device=seq_lens.device)[None, :]
    valid = pos < torch.clamp(clen, max=S)
    if window and S > window:
        valid &= pos >= clen - window
    return valid                                                # (B, S)


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                        qh2kv=None, window: int = 0) -> torch.Tensor:
    """q (B, H, D); k/v_pages (P, page, KV, D); block_table (B, max_pages)
    int32 (0 = null page); seq_lens (B,) int32; qh2kv optional (H,) map.
    Returns (B, H, D) in q.dtype."""
    B, H, D = q.shape
    KV = k_pages.shape[2]
    scale = 1.0 / (D ** 0.5)
    k = _linearise(k_pages, block_table)                  # (B, S, KV, D)
    v = _linearise(v_pages, block_table)
    S = k.shape[1]
    valid = _valid_mask(S, seq_lens, window)
    if qh2kv is None:
        assert H % KV == 0, (
            f"H={H} not divisible by KV={KV}: pass qh2kv for padded GQA")
        qh2kv = torch.arange(H, device=q.device) // (H // KV)
    idx = qh2kv.long().to(k.device)
    k = k.index_select(2, idx)                            # (B, S, H, D)
    v = v.index_select(2, idx)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def paged_attention_layers_ref(qs, k_pages, v_pages, block_table, seq_lens,
                               *, qh2kv=None, window: int = 0) -> torch.Tensor:
    """Batched-over-layers version: qs (L, B, H, D) against the stacked
    (L, P, page, KV, D) page store; one block table and one seq_lens
    shared by every layer. Returns (L, B, H, D)."""
    return torch.stack([
        paged_attention_ref(q, kp, vp, block_table, seq_lens, qh2kv=qh2kv,
                            window=window)
        for q, kp, vp in zip(qs, k_pages, v_pages)])
