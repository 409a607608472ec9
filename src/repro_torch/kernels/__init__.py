"""Hopper kernels (CUDA C++ under csrc/) with plain PyTorch versions beside
them: flash_prefill (chunked-prefill attention), paged_attention
(continuous-batching decode over block tables), ssd_scan (the Mamba2 SSD
mixer). Each ships kernel.py (the build and launch, at first use), ops.py
(the dispatch) and ref.py (the plain oracle). The ops import
``refuse_grad`` from here, so the exports follow its definition."""
from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors) -> None:
    """Raise when autograd would need a gradient through ``op``: grad mode
    is on and an input requires grad. The kernels are forward-only (as
    the reference's Pallas kernels have no VJP), so a kernel's output
    would carry no gradient and training would silently lose it. The
    ops refuse on every device, so the CPU behaves as the card does; the
    training forward (``models.transformer.loss_fn``) never calls them."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} is forward-only (its CUDA kernel has no backward): it "
            f"was called with grad mode on and an input that requires "
            f"grad. Train through loss_fn, whose train mode runs the "
            f"differentiable plain attention and SSD scan, or call {op} "
            f"under torch.no_grad().")


from repro_torch.kernels.flash_prefill import flash_prefill_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_op  # noqa: E402
