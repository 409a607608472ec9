"""PyTorch/CUDA port of the Mooncake reproduction (``repro`` is the JAX
reference). Imports torch, never jax, and nothing of ``repro``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
a CUDA device that is not there raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` without a usable GPU
    raises — nothing here quietly falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch was asked for a CUDA device but torch sees no GPU; "
            "pass device='cpu' to run the plain PyTorch paths")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
