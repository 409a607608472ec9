"""ctypes wrapper of the chunked SSD-scan CUDA kernel
(``csrc/ssd_scan.cu``). CUDA tensors only; ``launches`` counts the
wrapper's kernel calls (one per call: the four passes, issued together by
one C call)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 256   # positions per chunk the kernel holds in shared memory
MAX_STATE = 128   # d_state (n) the kernel holds in shared memory


def _need(t: torch.Tensor, name: str, dtype, shape: tuple,
          rows: bool = False) -> None:
    """Device, type and shape; then the layout: contiguous, or with
    ``rows`` a strided view whose innermost dims are packed (stride 1, and
    for 4-D x the head stride p) and whose leading strides are multiples
    of 8 elements, so every row is 16-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    ok = row_layout_ok(t) if rows else t.is_contiguous()
    if not ok or t.data_ptr() % 16:
        what = "rows of 16-byte aligned, packed" if rows else "contiguous"
        raise ValueError(f"{name} must be {what} and 16-byte aligned, got "
                         f"strides {t.stride()}")


def row_layout_ok(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` ((b, s, h, p) or (b, s, n)) in place
    through its batch and row strides: innermost stride 1 (and head stride
    p for x), batch and row strides multiples of 8 elements, below 2^31."""
    st = t.stride()
    inner = (st[-1] == 1) and (t.dim() == 3 or st[2] == t.shape[3])
    return inner and all(s % 8 == 0 and s < 2 ** 31 for s in st[:2])


def ssd_scan(x, dt, A, B, C, h0: Optional[torch.Tensor] = None, *,
             chunk: int = 256, passes: bool = False):
    """x (b, s, h, p) bf16; dt (b, s, h) f32; A (h,) f32; B, C (b, s, n)
    bf16 (one group); h0 optional (b, h, p, n) f32; s % chunk == 0,
    chunk ≤ 256, n ≤ 128, n % 8 == 0, p % 8 == 0 → (y (b, s, h, p) f32,
    final state (b, h, p, n) f32). x, B and C may be strided views
    (``row_layout_ok``). With ``passes`` a third item holds the passes'
    outputs: cb (b, c, l, l; lower triangle), cum (b, h, c, l; fp64),
    states and h_in (b, c, h, p, n). Launches on the current stream, no
    synchronise."""
    if x.dim() != 4:
        raise ValueError(f"x must be (b, s, h, p), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    _need(x, "x", torch.bfloat16, (b, s, h, p), rows=True)
    _need(dt, "dt", torch.float32, (b, s, h))
    _need(A, "A", torch.float32, (h,))
    _need(B, "B", torch.bfloat16, (b, s, n), rows=True)
    _need(C, "C", torch.bfloat16, (b, s, n), rows=True)
    if h0 is not None:
        _need(h0, "h0", torch.float32, (b, h, p, n))
    if not 0 < chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}, "
                         f"0 < chunk <= {MAX_CHUNK}")
    if not 0 < n <= MAX_STATE or n % 8:
        raise ValueError(f"d_state {n} not supported (a multiple of 8, at "
                         f"most {MAX_STATE})")
    if p % 8:
        raise ValueError(f"head_dim {p} not supported (a multiple of 8)")
    devs = {t.device for t in (x, dt, A, B, C) + ((h0,) if h0 is not None
                                                 else ())}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    c = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, h, p), **f32)
    hT = torch.empty((b, h, p, n), **f32)
    cb = torch.empty((b, c, chunk, chunk), **f32)
    cum = torch.empty((b, h, c, chunk), dtype=torch.float64, device=x.device)
    states = torch.empty((b, c, h, p, n), **f32)
    h_in = torch.empty((b, c, h, p, n), **f32)
    lib = _build.library("ssd_scan")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_bf16(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        cb.data_ptr(), cum.data_ptr(), states.data_ptr(), h_in.data_ptr(),
        b, s, h, p, n, chunk, x.stride(0), x.stride(1), B.stride(0),
        B.stride(1), C.stride(0), C.stride(1), stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    if passes:
        return y, hT, dict(cb=cb, cum=cum, states=states, h_in=h_in)
    return y, hT


ssd_scan.launches = 0
