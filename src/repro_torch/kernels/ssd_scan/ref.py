"""Plain PyTorch versions of the chunked SSD scan (the port of the
reference's ``ssd_chunked`` in ``models/mamba.py`` and of its per-token
oracle ``ssd_naive_ref``).

``ssd_chunked`` mirrors the reference step by step, in fp32 throughout,
as the four passes the CUDA kernel runs: ``chunk_cb`` (C·Bᵀ once per
chunk), ``chunk_state`` (the cumulative decay and each chunk's own state,
decayed to the chunk end), ``state_pass`` (the recurrence over chunk
states, a Python loop where the reference has ``lax.scan``) and
``chunk_scan`` (the intra-chunk "attention" ``((C·Bᵀ) ∘ L)(x·dt)`` with
the 1-semiseparable mask ``L = exp(segsum(dt·A))``, plus each chunk's
incoming state decayed to every position). Single B/C group.
"""
from __future__ import annotations

from typing import Optional

import torch


def _segsum(cum: torch.Tensor) -> torch.Tensor:
    """cum: (..., L) inclusive cumulative sums -> (..., L, L) with
    out[i, j] = cum_i − cum_j (the sum of the steps j+1 .. i), -inf above
    the diagonal."""
    L = cum.shape[-1]
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=cum.device))
    return out.masked_fill(~mask, float("-inf"))


def chunk_cb(B, C, chunk: int) -> torch.Tensor:
    """Pass 1: C·Bᵀ once per (batch, chunk), shared by every head.
    B, C (b, s, n) → (b, c, l, l) fp32, [i, j] = C_i · B_j."""
    b, s, n = B.shape
    c = s // chunk
    Bc = B.reshape(b, c, chunk, n).to(torch.float32)
    Cc = C.reshape(b, c, chunk, n).to(torch.float32)
    return torch.einsum("bcln,bcsn->bcls", Cc, Bc)


def chunk_state(x, dt, A, B, chunk: int):
    """Pass 2: per (batch, chunk, head) the cumulative decay
    cum = cumsum(dt·A) within the chunk, (b, h, c, l), and the chunk's own
    state S_c = Σ_j (x_j·dt_j e^{cum_last − cum_j})ᵀ B_j, (b, c, h, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    c = s // chunk
    f32 = torch.float32
    xc = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, c, chunk, h, p)
    dA = dt.to(f32) * A.to(f32)[None, None, :]                # (b,s,h)
    cum = torch.cumsum(dA.reshape(b, c, chunk, h).movedim(-1, 1), dim=-1)
    decay_states = torch.exp(cum[..., -1:] - cum)              # (b,h,c,l)
    Bc = B.reshape(b, c, chunk, n).to(f32)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    return cum, states


def state_pass(states, cum, h0: Optional[torch.Tensor] = None):
    """Pass 3: the recurrence over chunk states in order,
    h_in[c] = h; h = h·e^{cum_last,c} + S_c. Returns (h_in (b, c, h, p, n),
    final state (b, h, p, n)), fp32."""
    b, c, h, p, n = states.shape
    chunk_decay = torch.exp(cum[..., -1])                      # (b,h,c)
    h_prev = torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=states.device) \
        if h0 is None else h0.to(torch.float32)
    h_in = []
    for ic in range(c):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, :, ic, None, None] + states[:, ic]
    return torch.stack(h_in, dim=1), h_prev


def chunk_scan(x, dt, C, cb, cum, h_in):
    """Pass 4: y_i = Σ_{j≤i} (CB ∘ e^{cum_i − cum_j})_{ij} (x_j·dt_j)
    + e^{cum_i} C_i · h_inᵀ per (batch, chunk, head) → (b, s, h, p) fp32."""
    b, s, h, p = x.shape
    c, chunk = cum.shape[2], cum.shape[3]
    n = C.shape[-1]
    f32 = torch.float32
    xc = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, c, chunk, h, p)
    Cc = C.reshape(b, c, chunk, n).to(f32)
    # intra-chunk (diagonal blocks): Y_diag = (C Bᵀ ∘ L) (x·dt) with the
    # 1-semiseparable mask L = exp(segsum(dt·A))
    Lmask = torch.exp(_segsum(cum))                            # (b,h,c,l,l)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * Lmask, xc)
    # inter-chunk: the incoming state decayed to each position
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, h_in, torch.exp(cum))
    return (Y_diag + Y_off).reshape(b, s, h, p)


def ssd_chunked(x, dt, A, B, C, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan, the composition of the four passes.

    x: (b, s, h, p); dt: (b, s, h) positive step sizes; A: (h,) negative
    decay rates; B, C: (b, s, n) single-group projections; h0: optional
    (b, h, p, n) fp32 incoming state; s % chunk == 0.
    Returns (y (b, s, h, p) fp32, final state (b, h, p, n) fp32)."""
    if x.shape[1] % chunk:
        raise ValueError(f"seq {x.shape[1]} not divisible by chunk {chunk}")
    cb = chunk_cb(B, C, chunk)
    cum, states = chunk_state(x, dt, A, B, chunk)
    h_in, hT = state_pass(states, cum, h0)
    return chunk_scan(x, dt, C, cb, cum, h_in), hT


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
