"""Weights drawn from the seed on the device, for a family's ``draw``.

Every random leaf is a view of one bf16 buffer filled by a few large
``normal_`` calls from a ``torch.Generator`` on the device, then scaled
leaf by leaf in place. A family lists its leaves (shape and scale), lays
the views out as the port's parameters, and sets what is not random
(norm weights, the zeros of the port's padding) itself. The same tensors
go to the port and to the plain reference.
"""
from __future__ import annotations

import math

import torch

DRAW_ELEMS = 1 << 30       # elements per normal_ call


def normal(leaves: list, seed: int, device) -> list:
    """One bf16 tensor of shape ``shape`` drawn from N(0, ``scale``²) for
    each ``(shape, scale)`` of ``leaves``, in that order, from ``seed`` on
    ``device``."""
    device = torch.device(device)
    total = sum(math.prod(shape) for shape, _ in leaves)
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for lo in range(0, total, DRAW_ELEMS):
        buf[lo:lo + DRAW_ELEMS].normal_(generator=gen)
    out, off = [], 0
    for shape, scale in leaves:
        n = math.prod(shape)
        out.append(buf[off:off + n].view(shape).mul_(scale))
        off += n
    return out


def ones(*shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.bfloat16, device=device)
