"""Plain PyTorch version of chunked-prefill flash attention (the port of
the reference's ``flash_prefill_ref``): fp32 logits and probabilities,
``-inf`` masking, output cast to q's dtype. ``qh2kv`` (H,) adds the
explicit query-head → KV-head map the serving path needs for padded
GQA; ``None`` is the grouped layout, h // (H // KV)."""
from __future__ import annotations

import torch


def flash_prefill_ref(q, k, v, *, q_offset: int = 0, window: int = 0,
                      qh2kv=None) -> torch.Tensor:
    """q (B, Sq, H, D) at absolute positions q_offset + [0, Sq);
    k, v (B, Sk, KV, D) at positions [0, Sk). Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    if qh2kv is None:
        qh2kv = torch.arange(H, device=q.device) // (H // KV)
    idx = qh2kv.long().to(k.device)
    k_exp = k.index_select(2, idx)                    # (B, Sk, H, D)
    v_exp = v.index_select(2, idx)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_exp.float()) / (D ** 0.5)
    logits = logits.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = torch.where(torch.isfinite(logits), probs, 0.0)
    den = probs.sum(-1, keepdim=True)
    probs = probs / torch.clamp(den, min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_exp.float())
    return out.to(q.dtype)
