"""ctypes wrapper of the chunked-prefill CUDA kernel
(``csrc/flash_prefill.cu``). CUDA tensors only; ``launches`` counts the
wrapper's kernel calls (one per call: the split pass and, with more than
one split, its combine pass, issued together by one C call)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import TILE
from repro_torch.kernels.paged_attention.kernel import (HEAD_DIMS, _need,
                                                        device_sms)

BLOCKS_PER_SM = 2   # live blocks per SM the split over keys aims for


def choose_splits(n_blocks: int, n_key_tiles: int, sm_count: int) -> int:
    """Key splits for a grid of ``n_blocks`` (query tile, head, batch)
    blocks whose longest key range holds ``n_key_tiles`` 64-key tiles:
    1 when the grid already fills ``BLOCKS_PER_SM`` blocks per SM, else
    enough splits to do so, never more than there are key tiles."""
    want = BLOCKS_PER_SM * sm_count
    if n_blocks >= want or n_key_tiles <= 1:
        return 1
    return max(1, min(-(-want // n_blocks), n_key_tiles))


def flash_prefill(q, k, v, qh2kv, *, q_offset: int = 0, window: int = 0,
                  n_splits: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D) bf16 at positions q_offset + [0, Sq); k, v
    (B, Sk, KV, D) bf16; qh2kv (H,) int32 → (B, Sq, H, D) bf16. Keys at
    or past q_offset + Sq are never read. ``n_splits`` sets the split
    over keys (default: ``choose_splits`` for this card). Launches on the
    current stream, no synchronise."""
    _need(q, "q", torch.bfloat16, 4)
    _need(k, "k", torch.bfloat16, 4)
    _need(v, "v", torch.bfloat16, 4)
    _need(qh2kv, "qh2kv", torch.int32, 1)
    B, Sq, H, D = q.shape
    Bk, Sk, KV, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported {HEAD_DIMS}")
    if qh2kv.shape[0] != H:
        raise ValueError("qh2kv does not match q's heads")
    if len({t.device for t in (q, k, v, qh2kv)}) != 1:
        raise ValueError("q, k, v and qh2kv must share one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (TMA)")
    q_offset, window = int(q_offset), int(window)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    out = torch.empty_like(q)
    if Sq == 0:
        return out
    n_blocks = -(-Sq // TILE) * H * B
    key_tiles = -(-max(1, min(Sk, q_offset + Sq)) // TILE)
    if n_splits is None:
        n_splits = choose_splits(n_blocks, key_tiles,
                                 device_sms(q.device.index))
    if not 1 <= n_splits <= 64:
        raise ValueError(f"n_splits {n_splits} not in [1, 64]")
    part_o = part_ml = None
    if n_splits > 1:
        part_o = torch.empty((n_splits, B, H, Sq, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((n_splits, B, H, Sq, 2), dtype=torch.float32,
                              device=q.device)
    lib = _build.library("flash_prefill")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qh2kv.data_ptr(),
        out.data_ptr(), None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), B, Sq, Sk, H, KV, D,
        q_offset, window, n_splits, 1.0 / D ** 0.5, stream)
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    flash_prefill.last_splits = n_splits
    return out


flash_prefill.launches = 0
flash_prefill.last_splits = 0
