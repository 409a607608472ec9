"""Public op: chunked SSD scan. A CPU tensor takes the plain PyTorch
version (``ref.ssd_chunked``); a CUDA tensor launches the hand-written
kernel (or the wrapper raises) — there is no fallback between the two."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def ssd_scan_op(x, dt, A, B, C, h0: Optional[torch.Tensor] = None, *,
                chunk: int = 256):
    """x (b, s, h, p); dt (b, s, h); A (h,); B, C (b, s, n); h0 optional
    (b, h, p, n) fp32 → (y (b, s, h, p) fp32, final state fp32)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan runs on cpu or cuda, not {x.device}")
    return ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                    B.contiguous(), C.contiguous(),
                    None if h0 is None else h0.contiguous(), chunk=chunk)
