"""ctypes wrapper of the paged decode CUDA kernel
(``csrc/paged_attention.cu``). CUDA tensors only; ``launches`` counts
the kernel launches this wrapper made (one per call: the split pass and
its combine pass, issued together by one C call)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _need(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, qh2kv, *,
                    window: int = 0) -> torch.Tensor:
    """q (B, H, D) bf16; k/v_pages (P, page, KV, D) bf16; block_table
    (B, max_pages) int32; seq_lens (B,) int32; qh2kv (H,) int32 →
    (B, H, D) bf16. Launches on the current stream, no synchronise."""
    _need(q, "q", torch.bfloat16, 3)
    _need(k_pages, "k_pages", torch.bfloat16, 4)
    _need(v_pages, "v_pages", torch.bfloat16, 4)
    _need(block_table, "block_table", torch.int32, 2)
    _need(seq_lens, "seq_lens", torch.int32, 1)
    _need(qh2kv, "qh2kv", torch.int32, 1)
    B, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if D not in (32, 64, 128):
        raise ValueError(f"head_dim {D} not supported (32, 64, 128)")
    if block_table.shape[0] != B or seq_lens.shape[0] != B \
            or qh2kv.shape[0] != H:
        raise ValueError("block_table/seq_lens/qh2kv do not match q")
    devs = {t.device for t in (q, k_pages, v_pages, block_table, seq_lens,
                               qh2kv)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    lib = _build.library("paged_attention")
    split = lib.paged_attention_split_tokens()
    n_splits = -(-block_table.shape[1] * page // split)
    # pass 1 writes one unnormalised (acc, max, sum) partial per split,
    # pass 2 combines them into ``out``
    part = torch.empty((B, H, n_splits, D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), qh2kv.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, H, KV, D, page,
        block_table.shape[1], int(window), 1.0 / D ** 0.5, n_splits, stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
