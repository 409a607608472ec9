"""Plain PyTorch versions of the chunked SSD scan (the port of the
reference's ``ssd_chunked`` in ``models/mamba.py`` and of its per-token
oracle ``ssd_naive_ref``).

``ssd_chunked`` mirrors the reference step by step, in fp32 throughout:
the intra-chunk "attention" ``((C·Bᵀ) ∘ L)(x·dt)`` with the
1-semiseparable mask ``L = exp(segsum(dt·A))``, per-chunk states decayed
to the chunk end, the recurrence over chunk states (a Python loop where
the reference has ``lax.scan``), and each chunk's incoming state decayed
to every position. Single B/C group.
"""
from __future__ import annotations

from typing import Optional

import torch


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L) with out[i, j] = sum(x[j+1 .. i]), -inf
    above the diagonal (strict lower-triangular cumulative sums, diagonal
    0)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h) positive step sizes; A: (h,) negative
    decay rates; B, C: (b, s, n) single-group projections; h0: optional
    (b, h, p, n) fp32 incoming state; s % chunk == 0.
    Returns (y (b, s, h, p) fp32, final state (b, h, p, n) fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    c = s // chunk
    f32 = torch.float32

    xdt = x.to(f32) * dt.to(f32)[..., None]                   # (b,s,h,p)
    dA = dt.to(f32) * A.to(f32)[None, None, :]                # (b,s,h)

    xc = xdt.reshape(b, c, chunk, h, p)
    dAc = dA.reshape(b, c, chunk, h).movedim(-1, 1)            # (b,h,c,l)
    Bc = B.reshape(b, c, chunk, n).to(f32)
    Cc = C.reshape(b, c, chunk, n).to(f32)

    cum = torch.cumsum(dAc, dim=-1)                            # (b,h,c,l)

    # 1. intra-chunk (diagonal blocks): Y_diag = (C Bᵀ ∘ L) (x·dt)
    Lmask = torch.exp(_segsum(dAc))                            # (b,h,c,l,l)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", scores[:, None] * Lmask, xc)

    # 2. per-chunk states: right factor with decay to the chunk end
    decay_states = torch.exp(cum[..., -1:] - cum)              # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)

    # 3. inter-chunk recurrence over chunk states (emit the INCOMING state)
    chunk_decay = torch.exp(cum[..., -1])                      # (b,h,c)
    h_prev = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    h_in = []
    for ic in range(c):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, :, ic, None, None] + states[:, ic]
    h_in = torch.stack(h_in, dim=1)                            # (b,c,h,p,n)

    # 4. inter-chunk outputs: state contribution decayed to each position
    state_decay = torch.exp(cum)                               # (b,h,c,l)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, h_in, state_decay)

    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y, h_prev


def ssd_naive_ref(x, dt, A, B, C, h0: Optional[torch.Tensor] = None):
    """Per-token recurrence oracle: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
    y_t = h_t C_t. Returns (y (b, s, h, p) fp32, final state fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    hs = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t].to(f32) * A.to(f32)[None, :])          # (b,h)
        dBx = torch.einsum("bn,bhp->bhpn", B[:, t].to(f32),
                           x[:, t].to(f32) * dt[:, t].to(f32)[..., None])
        hs = hs * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", hs, C[:, t].to(f32)))
    return torch.stack(ys, dim=1), hs
