"""Mamba2 (SSD — state-space duality) block in PyTorch — the counterpart
of the reference's ``repro/models/mamba.py``. [arXiv:2405.21060]

Prefill and multi-token extends run the chunked SSD scan: on CUDA
tensors the hand-written kernel (``kernels/ssd_scan``), on CPU tensors
its plain version ``ssd_chunked`` (also forced on the card inside
``layers.plain_attention()``, for comparison only, and taken on every
device by the training forward). A single-token step
against a state is the plain recurrence ``ssd_decode``, as in the
reference, which has no kernel for it. Single B/C group.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models import layers
from repro_torch.models.layers import rms_norm


class MambaState(NamedTuple):
    ssm: torch.Tensor   # (B, H, P, N) fp32 (stacked: (L, B, H, P, N))
    conv: torch.Tensor  # (B, d_conv - 1, conv_channels) bf16 (stacked: L first)


def ssd_decode(x, dt, A, B, C, state):
    """Single-step recurrence. x: (b, h, p); dt: (b, h); B, C: (b, n);
    state: (b, h, p, n) fp32. Returns (y (b, h, p), new_state)."""
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32)[None, :])                # (b,h)
    dBx = torch.einsum("bn,bhp->bhpn", B.to(f32),
                       x.to(f32) * dt.to(f32)[..., None])
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, C.to(f32))
    return y, new_state


def _causal_conv(x, w, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (b, s, ch); w: (k, ch); prev: (b, k-1, ch)
    history for decode / chunked prefill. The taps are summed in x's dtype
    in the reference's order (each product rounded, then added one by
    one). Returns (y (b, s, ch), new_prev (b, k-1, ch))."""
    k = w.shape[0]
    b, s, ch = x.shape
    if prev is None:
        prev = torch.zeros((b, k - 1, ch), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)                        # (b, s+k-1, ch)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_prev = xp[:, xp.shape[1] - (k - 1):] if k > 1 \
        else torch.zeros((b, 0, ch), dtype=x.dtype, device=x.device)
    return y, new_prev


def mamba_block(x, p, cfg: ModelConfig, *, state: Optional[MambaState] = None,
                return_state: bool = False, train: bool = False):
    """Mamba2 mixer block (pre-norm; the caller adds the residual).

    x: (B, S, D). With ``state`` this is a decode step (S == 1) or a chunk
    continuation; returns (y, new_state) — else (y, final_state or None).
    ``train`` (the training forward): the scan is ``ssd_chunked`` on
    every device, the reference's own training math, which autograd
    differentiates (the kernel is forward-only).
    """
    s_cfg = cfg.ssm
    B_, S, D = x.shape
    di = s_cfg.d_inner(D)
    nh = s_cfg.n_heads(D)
    hd = s_cfg.head_dim
    n = s_cfg.d_state

    h = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]                  # (B, S, 2*di + 2n + nh)
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)

    conv_in = torch.cat([xs, Bc, Cc], dim=-1)  # (B, S, di + 2n)
    prev = state.conv if state is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], prev)
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = torch.split(conv_out, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, S, nh)
    A = -torch.exp(p["A_log"].float())                         # (nh,)
    xh = xs.reshape(B_, S, nh, hd)

    ssm0 = state.ssm if state is not None else None
    if S == 1 and ssm0 is not None:
        y1, new_ssm = ssd_decode(xh[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0],
                                 ssm0)
        y = y1[:, None]
    else:
        chunk = min(s_cfg.chunk, S)
        pad = (-S) % chunk
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            Bp = F.pad(Bc, (0, 0, 0, pad))
            Cp = F.pad(Cc, (0, 0, 0, pad))
        else:
            xh_p, dt_p, Bp, Cp = xh, dt, Bc, Cc
        plain = train or (x.is_cuda and layers._FORCE_PLAIN)
        scan = ssd_chunked if plain else ssd_scan_op
        y, new_ssm = scan(xh_p, dt_p, A, Bp, Cp, chunk=chunk, h0=ssm0)
        y = y[:, :S]

    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]

    if state is not None or return_state:
        return out, MambaState(ssm=new_ssm, conv=new_conv)
    return out, None
