"""ctypes wrappers of the paged decode CUDA kernel
(``csrc/paged_attention.cu``): one layer (``paged_attention``) or all L
layers of a stacked page store in one launch (``paged_attention_layers``).
CUDA tensors only; each wrapper's ``launches`` counts its calls, and each
call is one kernel launch: one block per (layer, KV head, slot, split)
serves the KV head's whole query-head group, and the splits of a
(layer, KV head, slot) merge inside the launch (one thread-block cluster
each), so there is no partial buffer and no combine pass."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import TILE

BLOCKS_PER_SM = 2   # live blocks per SM the split over tokens aims for
MAX_SPLITS = 8      # a split's blocks form one cluster: at most 8
MAX_HEADS = 256     # query heads a head map may have (the kernel's copy)
HEAD_DIMS = (32, 64, 96, 128)   # the head dims both attention kernels take


def choose_splits(n_blocks: int, n_tiles: int, sm_count: int) -> int:
    """Token splits for a grid of ``n_blocks`` (layer, KV head, slot)
    blocks whose longest live range holds ``n_tiles`` 64-token tiles: the
    least power of two that gives ``BLOCKS_PER_SM`` blocks per SM, at most
    ``MAX_SPLITS`` and never more splits than tiles. A pure function of
    shapes: it reads no device data (the lengths stay on the card)."""
    want = BLOCKS_PER_SM * sm_count
    s = 1
    while s < MAX_SPLITS and n_blocks * s < want and 2 * s <= n_tiles:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported {HEAD_DIMS}")
    if H > MAX_HEADS:
        raise ValueError(f"{H} query heads; the kernel takes {MAX_HEADS}")
    if block_table.shape[0] != B or seq_lens.shape[0] != B \
            or qh2kv.shape[0] != H:
        raise ValueError("block_table/seq_lens/qh2kv do not match q")
    devs = {t.device for t in (q, k_pages, v_pages, block_table, seq_lens,
                               qh2kv)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pages must be 16-byte aligned (cp.async)")
    return B, H, D, page, KV


def _splits(n_splits: Optional[int], q, B: int, H: int, KV: int,
            n_tiles: int) -> int:
    """The forced split count, checked, or the per-layer choice for this
    card: a layers call takes the same count as a per-layer call, so that
    its layer l stays bit-equal to a per-layer call on layer l."""
    if n_splits is None:
        n_splits = choose_splits(B * min(KV, H), n_tiles,
                                 device_sms(q.device.index))
    if not 1 <= n_splits <= MAX_SPLITS:
        raise ValueError(f"n_splits {n_splits} not in [1, {MAX_SPLITS}]")
    return int(n_splits)


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, qh2kv, *,
                    window: int = 0,
                    n_splits: Optional[int] = None) -> torch.Tensor:
    """q (B, H, D) bf16; k/v_pages (P, page, KV, D) bf16; block_table
    (B, max_pages) int32; seq_lens (B,) int32; qh2kv (H,) int32 →
    (B, H, D) bf16. ``n_splits`` (1–8) sets the split over each slot's
    tokens (default: ``choose_splits`` for this card). Launches on the
    current stream, no synchronise."""
    B, H, D, page, KV = _check(q, k_pages, v_pages, block_table, seq_lens,
                               qh2kv, 3)
    n_tiles = -(-block_table.shape[1] * page // TILE)
    n_splits = _splits(n_splits, q, B, H, KV, n_tiles)
    out = torch.empty_like(q)
    lib = _build.library("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), qh2kv.data_ptr(),
        out.data_ptr(), B, H, KV, D, page, block_table.shape[1], int(window),
        1.0 / D ** 0.5, n_splits, stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.last_splits = n_splits
    return out


paged_attention.launches = 0
paged_attention.last_splits = 0


def paged_attention_layers(qs, k_pages, v_pages, block_table, seq_lens,
                           qh2kv, *, window: int = 0,
                           n_splits: Optional[int] = None) -> torch.Tensor:
    """qs (L, B, H, D) bf16; k/v_pages (L, P, page, KV, D) bf16; one
    block_table (B, max_pages) int32, seq_lens (B,) int32 and qh2kv (H,)
    int32 shared by every layer → (L, B, H, D) bf16, all layers in one
    launch. Layer l equals ``paged_attention`` on layer l's operands with
    the same ``n_splits`` (both default to the per-layer choice)."""
    B, H, D, page, KV = _check(qs, k_pages, v_pages, block_table, seq_lens,
                               qh2kv, 4)
    L, P = qs.shape[0], k_pages.shape[1]
    n_tiles = -(-block_table.shape[1] * page // TILE)
    n_splits = _splits(n_splits, qs, B, H, KV, n_tiles)
    out = torch.empty_like(qs)
    lib = _build.library("paged_attention")
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    err = lib.paged_attention_layers_bf16(
        qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), qh2kv.data_ptr(),
        out.data_ptr(), L, B, H, KV, D, page, block_table.shape[1], P,
        int(window), 1.0 / D ** 0.5, n_splits, stream)
    _build.check(err, "paged_attention_layers")
    paged_attention_layers.launches += 1
    paged_attention_layers.last_splits = n_splits
    return out


paged_attention_layers.launches = 0
paged_attention_layers.last_splits = 0
