"""Plain PyTorch versions of paged decode attention (the port of the
reference's ``paged_attention_ref`` and ``paged_attention_layers_ref``).

Numerics mirror the dense decode path (``models.layers._attend``): fp32
logits, -1e30 masking, fp32 softmax, probabilities cast to the value
dtype before the PV product (done here in fp32 and rounded once). The
paged and dense substrates then differ only in WHERE the KV bytes live.

Head layouts: grouped GQA (``qh2kv=None``, H % KV == 0, query head h
reads KV head h // (H // KV)) or an explicit ``qh2kv`` (H,) map for
padded GQA (smollm: 16 padded query heads over 5 KV heads).

``paged_attention_splits_ref`` (and its layers form) is the CUDA kernel's
decomposition of the same function: per (slot, KV head, split) an fp32
partial over the KV head's query-head group (``kv_head_groups``), the
slot's live tokens cut into runs of whole 64-token tiles
(``split_ranges``) and read page by page through the block table, then a
log-sum-exp merge in split order.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
TILE = 64   # tokens per tile of the kernel's page ring


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


def kv_head_groups(qh2kv, H: int, KV: int) -> list:
    """The query heads of each KV head, ascending — the rows of the
    kernel's query tile for that KV head (an unused KV head has none).
    ``qh2kv=None`` is the grouped layout."""
    if qh2kv is None:
        m = [h // (H // KV) for h in range(H)]
    else:
        m = [int(x) for x in qh2kv.tolist()]
    return [[h for h in range(H) if m[h] == kv] for kv in range(KV)]


def split_ranges(seq_len: int, window: int, max_tokens: int,
                 n_splits: int) -> list:
    """The kernel's split of one slot's live tokens [lo, n_tok): its
    64-token tiles (aligned to absolute positions) cut into ``n_splits``
    runs of whole tiles; a list of (first token, end token) per split,
    clipped to the live range, (t, t) for an empty split."""
    n_tok = min(seq_len, max_tokens)
    lo = max(seq_len - window, 0) if window > 0 else 0
    first = lo // TILE
    n_all = max(-(-n_tok // TILE) - first, 0)
    per = -(-n_all // n_splits)
    runs = []
    for s in range(n_splits):
        a = max((first + min(s * per, n_all)) * TILE, lo)
        b = min((first + min((s + 1) * per, n_all)) * TILE, n_tok)
        runs.append((a, max(a, b)))
    return runs


def paged_attention_layers_splits_ref(qs, k_pages, v_pages, block_table,
                                      seq_lens, *, qh2kv=None,
                                      window: int = 0,
                                      n_splits: int = 1) -> torch.Tensor:
    """``paged_attention_layers_ref`` computed as the CUDA kernel computes
    it: for each (slot, KV head, split), the group's query heads against
    the split's tokens (gathered page by page through the table, so pages
    past the live range, the null page among them, are never read), an
    fp32 partial o = Σ e^{s−m} v with the probabilities rounded to bf16,
    m = max s, l = Σ e^{s−m}; then out = Σ_s e^{m_s−M} o_s / Σ_s e^{m_s−M}
    l_s in split order, empty splits skipped; a slot with no live token
    gives 0. qs (L, B, H, D), pages (L, P, page, KV, D) → (L, B, H, D)."""
    L, B, H, D = qs.shape
    page, KV = k_pages.shape[2], k_pages.shape[3]
    scale = 1.0 / (D ** 0.5)
    groups = kv_head_groups(qh2kv, H, KV)
    out = torch.zeros((L, B, H, D), dtype=torch.float32, device=qs.device)
    for b in range(B):
        runs = split_ranges(int(seq_lens[b]), window,
                            block_table.shape[1] * page, n_splits)
        for kv, heads in enumerate(groups):
            if not heads:
                continue
            qg = qs[:, b, heads].float()                        # (L, G, D)
            parts = []
            for t0, t1 in runs:
                if t1 <= t0:
                    continue
                toks = torch.arange(t0, t1, device=qs.device)
                pids = block_table[b].long()[toks // page]
                k = k_pages[:, pids, toks % page, kv].float()   # (L, n, D)
                v = v_pages[:, pids, toks % page, kv].float()
                s = torch.einsum("lgd,lnd->lgn", qg, k) * scale
                m = s.amax(-1)
                p = torch.exp(s - m[..., None])
                o = torch.einsum("lgn,lnd->lgd",
                                 p.to(torch.bfloat16).float(), v)
                parts.append((o, m, p.sum(-1)))
            if not parts:
                continue
            M = torch.stack([m for _, m, _ in parts]).amax(0)
            num = torch.zeros_like(parts[0][0])
            den = torch.zeros_like(M)
            for o, m, l in parts:
                w = torch.exp(m - M)
                num = num + o * w[..., None]
                den = den + l * w
            out[:, b, heads] = num / den[..., None]
    return out.to(qs.dtype)


def paged_attention_splits_ref(q, k_pages, v_pages, block_table, seq_lens,
                               *, qh2kv=None, window: int = 0,
                               n_splits: int = 1) -> torch.Tensor:
    """One layer of ``paged_attention_layers_splits_ref``: q (B, H, D),
    pages (P, page, KV, D) → (B, H, D)."""
    return paged_attention_layers_splits_ref(
        q[None], k_pages[None], v_pages[None], block_table, seq_lens,
        qh2kv=qh2kv, window=window, n_splits=n_splits)[0]
