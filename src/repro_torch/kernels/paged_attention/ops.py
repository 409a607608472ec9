"""Public op: paged decode attention. A CPU tensor takes the plain
PyTorch version; a CUDA tensor launches the hand-written kernel (or the
wrapper raises) — there is no fallback between the two."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def grouped_map(H: int, KV: int, device) -> torch.Tensor:
    """Grouped-GQA query-head → KV-head map, h // (H // KV)."""
    assert H % KV == 0, (H, KV)
    return (torch.arange(H, dtype=torch.int32, device=device)
            // (H // KV)).to(torch.int32)


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                           qh2kv=None, window: int = 0) -> torch.Tensor:
    """q (B, H, D) over one layer's paged KV → (B, H, D)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   seq_lens, qh2kv=qh2kv, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode attention runs on cpu or cuda, "
                         f"not {q.device}")
    if qh2kv is None:
        qh2kv = grouped_map(q.shape[1], k_pages.shape[2], q.device)
    return paged_attention(q, k_pages, v_pages, block_table, seq_lens,
                           qh2kv, window=window)
