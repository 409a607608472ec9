"""Hopper kernels (CUDA C++ under csrc/) with plain PyTorch versions beside them."""
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
