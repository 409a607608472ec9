"""ctypes wrappers of the paged decode CUDA kernel
(``csrc/paged_attention.cu``): one layer (``paged_attention``) or all L
layers of a stacked page store in one launch (``paged_attention_layers``).
CUDA tensors only; each wrapper's ``launches`` counts the kernel launches
it made (one per call: the split pass and its combine pass, issued
together by one C call)."""
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


def _check(q, k_pages, v_pages, block_table, seq_lens, qh2kv, nd: int):
    """Validate one call's operands (``nd`` = dims of q: 3 for one layer,
    4 with a leading layer axis); returns (B, H, D, page, KV)."""
    _need(q, "q", torch.bfloat16, nd)
    _need(k_pages, "k_pages", torch.bfloat16, nd + 1)
    _need(v_pages, "v_pages", torch.bfloat16, nd + 1)
    _need(block_table, "block_table", torch.int32, 2)
    _need(seq_lens, "seq_lens", torch.int32, 1)
    _need(qh2kv, "qh2kv", torch.int32, 1)
    B, H, D = q.shape[-3:]
    P, page, KV, Dk = k_pages.shape[-4:]
    if nd == 4 and k_pages.shape[0] != q.shape[0]:
        raise ValueError(f"{q.shape[0]} layers of q but {k_pages.shape[0]} "
                         f"of pages")
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
    return B, H, D, page, KV


def _scratch(lib, q, block_table, page: int):
    """(n_splits, partial buffer, output): pass 1 writes one unnormalised
    (acc, max, sum) partial per 256-token split, pass 2 combines them."""
    split = lib.paged_attention_split_tokens()
    n_splits = -(-block_table.shape[1] * page // split)
    part = torch.empty((*q.shape[:-1], n_splits, q.shape[-1] + 2),
                       dtype=torch.float32, device=q.device)
    return n_splits, part, torch.empty_like(q)


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, qh2kv, *,
                    window: int = 0) -> torch.Tensor:
    """q (B, H, D) bf16; k/v_pages (P, page, KV, D) bf16; block_table
    (B, max_pages) int32; seq_lens (B,) int32; qh2kv (H,) int32 →
    (B, H, D) bf16. Launches on the current stream, no synchronise."""
    B, H, D, page, KV = _check(q, k_pages, v_pages, block_table, seq_lens,
                               qh2kv, 3)
    lib = _build.library("paged_attention")
    n_splits, part, out = _scratch(lib, q, block_table, page)
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


def paged_attention_layers(qs, k_pages, v_pages, block_table, seq_lens,
                           qh2kv, *, window: int = 0) -> torch.Tensor:
    """qs (L, B, H, D) bf16; k/v_pages (L, P, page, KV, D) bf16; one
    block_table (B, max_pages) int32, seq_lens (B,) int32 and qh2kv (H,)
    int32 shared by every layer → (L, B, H, D) bf16, all layers in one
    launch. Layer l equals ``paged_attention`` on layer l's operands."""
    B, H, D, page, KV = _check(qs, k_pages, v_pages, block_table, seq_lens,
                               qh2kv, 4)
    L, P = qs.shape[0], k_pages.shape[1]
    lib = _build.library("paged_attention")
    n_splits, part, out = _scratch(lib, qs, block_table, page)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    err = lib.paged_attention_layers_bf16(
        qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), qh2kv.data_ptr(),
        part.data_ptr(), out.data_ptr(), L, B, H, KV, D, page,
        block_table.shape[1], P, int(window), 1.0 / D ** 0.5, n_splits,
        stream)
    _build.check(err, "paged_attention_layers")
    paged_attention_layers.launches += 1
    return out


paged_attention_layers.launches = 0
