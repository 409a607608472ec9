"""Public op: chunked SSD scan. A CPU tensor takes the plain PyTorch
version (``ref.ssd_chunked``); a CUDA tensor launches the hand-written
kernel (or the wrapper raises) — there is no fallback between the two.
An input that requires grad, with grad mode on, raises on either
device."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.ssd_scan.kernel import row_layout_ok, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when the kernel can read it through its strides (the
    views of the conv output that ``mamba_block`` passes), else a
    contiguous copy."""
    return t if row_layout_ok(t) and t.data_ptr() % 16 == 0 \
        else t.contiguous()


def ssd_scan_op(x, dt, A, B, C, h0: Optional[torch.Tensor] = None, *,
                chunk: int = 256):
    """x (b, s, h, p); dt (b, s, h); A (h,); B, C (b, s, n); h0 optional
    (b, h, p, n) fp32 → (y (b, s, h, p) fp32, final state fp32). Forward
    only: raises under autograd (``kernels.refuse_grad``)."""
    refuse_grad("ssd_scan_op", x, dt, A, B, C, h0)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan runs on cpu or cuda, not {x.device}")
    return ssd_scan(_rows(x), dt.contiguous(), A.contiguous(), _rows(B),
                    _rows(C), None if h0 is None else h0.contiguous(),
                    chunk=chunk)
