"""ctypes wrapper of the chunked SSD-scan CUDA kernel
(``csrc/ssd_scan.cu``). CUDA tensors only; ``launches`` counts the
kernel launches this wrapper made (one per call)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 256   # positions per chunk the kernel holds in shared memory
MAX_STATE = 128   # d_state (n) the kernel holds in shared memory


def _need(t: torch.Tensor, name: str, dtype, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def ssd_scan(x, dt, A, B, C, h0: Optional[torch.Tensor] = None, *,
             chunk: int = 256):
    """x (b, s, h, p) bf16; dt (b, s, h) f32; A (h,) f32; B, C (b, s, n)
    bf16 (one group); h0 optional (b, h, p, n) f32; s % chunk == 0,
    chunk ≤ 256, n ≤ 128 and n % 8 == 0 → (y (b, s, h, p) f32, final
    state (b, h, p, n) f32). Launches on the current stream, no
    synchronise."""
    if x.dim() != 4:
        raise ValueError(f"x must be (b, s, h, p), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    _need(x, "x", torch.bfloat16, (b, s, h, p))
    _need(dt, "dt", torch.float32, (b, s, h))
    _need(A, "A", torch.float32, (h,))
    _need(B, "B", torch.bfloat16, (b, s, n))
    _need(C, "C", torch.bfloat16, (b, s, n))
    if h0 is not None:
        _need(h0, "h0", torch.float32, (b, h, p, n))
    if not 0 < chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}, "
                         f"0 < chunk <= {MAX_CHUNK}")
    if not 0 < n <= MAX_STATE or n % 8:
        raise ValueError(f"d_state {n} not supported (a multiple of 8, at "
                         f"most {MAX_STATE})")
    devs = {t.device for t in (x, dt, A, B, C) + ((h0,) if h0 is not None
                                                 else ())}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    hT = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.library("ssd_scan")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_bf16(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        b, s, h, p, n, chunk, stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, hT


ssd_scan.launches = 0
