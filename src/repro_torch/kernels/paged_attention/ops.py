"""Public ops: paged decode attention, one layer or all layers of a
stacked store in one launch. A CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the hand-written kernel (or the wrapper
raises) — there is no fallback between the two."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.paged_attention.kernel import (paged_attention,
                                                        paged_attention_layers)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_layers_ref, paged_attention_ref)


@functools.lru_cache(maxsize=64)
def _grouped_cached(H: int, KV: int, device: str) -> torch.Tensor:
    return torch.tensor([h // (H // KV) for h in range(H)],
                        dtype=torch.int32, device=device)


def grouped_map(H: int, KV: int, device) -> torch.Tensor:
    """Grouped-GQA query-head → KV-head map, h // (H // KV): int32 (H,),
    built once per (H, KV, device) and shared by every later call (a
    decode step asks for it in every layer)."""
    assert H % KV == 0, (H, KV)
    return _grouped_cached(H, KV, str(torch.device(device)))


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


def paged_decode_attention_layers(qs, k_pages, v_pages, block_table,
                                  seq_lens, *, qh2kv=None,
                                  window: int = 0) -> torch.Tensor:
    """qs (L, B, H, D) over the stacked (L, P, page, KV, D) store →
    (L, B, H, D); on CUDA one kernel launch covers every layer (the
    microbench / layer-parallel entry)."""
    if qs.device.type == "cpu":
        return paged_attention_layers_ref(qs, k_pages, v_pages, block_table,
                                          seq_lens, qh2kv=qh2kv,
                                          window=window)
    if qs.device.type != "cuda":
        raise ValueError(f"paged decode attention runs on cpu or cuda, "
                         f"not {qs.device}")
    if qh2kv is None:
        qh2kv = grouped_map(qs.shape[2], k_pages.shape[3], qs.device)
    return paged_attention_layers(qs, k_pages, v_pages, block_table,
                                  seq_lens, qh2kv, window=window)
