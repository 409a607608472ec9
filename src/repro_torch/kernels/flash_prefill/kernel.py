"""ctypes wrapper of the chunked-prefill CUDA kernel
(``csrc/flash_prefill.cu``). CUDA tensors only; ``launches`` counts the
kernel launches this wrapper made."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.kernel import _need


def flash_prefill(q, k, v, qh2kv, *, q_offset: int = 0,
                  window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D) bf16 at positions q_offset + [0, Sq); k, v
    (B, Sk, KV, D) bf16; qh2kv (H,) int32 → (B, Sq, H, D) bf16. Keys at
    or past q_offset + Sq are never read. Launches on the current
    stream, no synchronise."""
    _need(q, "q", torch.bfloat16, 4)
    _need(k, "k", torch.bfloat16, 4)
    _need(v, "v", torch.bfloat16, 4)
    _need(qh2kv, "qh2kv", torch.int32, 1)
    B, Sq, H, D = q.shape
    Bk, Sk, KV, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if D not in (32, 64, 128):
        raise ValueError(f"head_dim {D} not supported (32, 64, 128)")
    if qh2kv.shape[0] != H:
        raise ValueError("qh2kv does not match q's heads")
    if len({t.device for t in (q, k, v, qh2kv)}) != 1:
        raise ValueError("q, k, v and qh2kv must share one device")
    q_offset, window = int(q_offset), int(window)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    out = torch.empty_like(q)
    lib = _build.library("flash_prefill")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qh2kv.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, KV, D, q_offset, window,
        1.0 / D ** 0.5, stream)
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
