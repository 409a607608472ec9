"""Mamba2 (SSD — state-space duality) block in PyTorch — the counterpart
of the reference's ``repro/models/mamba.py``. [arXiv:2405.21060]

Prefill and multi-token extends run the chunked SSD scan: on CUDA
tensors the hand-written kernel (``kernels/ssd_scan``), on CPU tensors
its plain version ``ssd_chunked`` (also forced on the card inside
``layers.plain_attention()``, for comparison only, and taken on every
device by the training forward). A single-token step
against a state is the plain recurrence ``ssd_decode``, as in the
reference, which has no kernel for it. Single B/C group.

On a (data, model) mesh the mixer is tensor-parallel over 'model', as
the reference's sharding rules lay its leaves out: each position runs
the conv, the scan (the kernel on CUDA) and the norm's share of its
stripe of the heads (``_mamba_mesh``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.launch.shardings import (Sharded, batch_entry, collective,
                                          gather, take)
from repro_torch.models import layers
from repro_torch.models.layers import NO_DIST, Dist, _on_rows, rms_norm


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


def _scan(xh, dt, A, Bc, Cc, ssm0, s_cfg, train: bool):
    """The SSM of one mixer (or of one position's heads): a one-token
    step against a state by ``ssd_decode``, else the chunked scan — the
    kernel on CUDA outside training, ``ssd_chunked`` otherwise — over
    the sequence padded to a whole chunk. Returns (y (B, S, h, p),
    final state)."""
    S = xh.shape[1]
    if S == 1 and ssm0 is not None:
        y1, new_ssm = ssd_decode(xh[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0],
                                 ssm0)
        return y1[:, None], new_ssm
    chunk = min(s_cfg.chunk, S)
    pad = (-S) % chunk
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(Bc, (0, 0, 0, pad))
        Cp = F.pad(Cc, (0, 0, 0, pad))
    else:
        xh_p, dt_p, Bp, Cp = xh, dt, Bc, Cc
    plain = train or (xh.is_cuda and layers._FORCE_PLAIN)
    scan = ssd_chunked if plain else ssd_scan_op
    y, new_ssm = scan(xh_p, dt_p, A, Bp, Cp, chunk=chunk, h0=ssm0)
    return y[:, :S], new_ssm


def mamba_block(x, p, cfg: ModelConfig, dist: Dist = NO_DIST, *,
                state: Optional[MambaState] = None,
                return_state: bool = False, train: bool = False):
    """Mamba2 mixer block (pre-norm; the caller adds the residual).

    x: (B, S, D). With ``state`` this is a decode step (S == 1) or a chunk
    continuation; returns (y, new_state) — else (y, final_state or None).
    ``train`` (the training forward): the scan is ``ssd_chunked`` on
    every device, the reference's own training math, which autograd
    differentiates (the kernel is forward-only).

    ``dist`` active (x a list of data rows or a whole batch): the mixer
    is tensor-parallel over 'model' (``_mamba_mesh``); ``state`` may be
    whole tensors or ``Sharded`` leaves laid out by ``cache_specs``, and
    the new state is ``Sharded`` that way.
    """
    if dist.active:
        return _on_rows(x, dist, lambda rows: _mamba_mesh(
            rows, p, cfg, dist, state=state,
            want_state=state is not None or return_state, train=train))
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
    y, new_ssm = _scan(xh, dt, A, Bc, Cc, ssm0, s_cfg, train)

    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]

    if state is not None or return_state:
        return out, MambaState(ssm=new_ssm, conv=new_conv)
    return out, None


def _mamba_mesh(rows, p, cfg: ModelConfig, dist: Dist, *, state,
                want_state: bool, train: bool):
    """Each data row's mixer, tensor-parallel over its model positions
    (the reference's rules: ``in_proj`` by columns, ``conv_w`` and
    ``norm`` by channels, ``out_proj`` by rows; its heads constrained
    onto 'model'). Position m of a row takes heads [m·nh/M, (m+1)·nh/M):

      * from ``in_proj`` those heads' z, x and dt columns, and B and C
        whole (one group: every head reads them, so every position
        convolves them — replicated work, as XLA's would be);
      * the causal conv of its x channels and of B, C, from its part of
        the conv state;
      * the SSD scan on its heads (the kernel on CUDA, ``ssd_chunked`` on
        the CPU and in training; ``ssd_decode`` for one token against a
        state) and D;
      * the gated RMSNorm over all of d_inner, its fp32 sum of squares
        summed across the row on the row's device;
      * ``out_proj``'s rows for its heads, the row partials summed in
        fp32 and rounded once.

    Returns (y per row, the new MambaState or None): the SSM state's
    heads and the conv state's channels ``Sharded`` over 'model', the
    batch over the data rows — ``cache_specs``' layout."""
    s_cfg = cfg.ssm
    D = cfg.d_model
    di, nh = s_cfg.d_inner(D), s_cfg.n_heads(D)
    hd, n = s_cfg.head_dim, s_cfg.d_state
    conv_ch = s_cfg.conv_channels(D)
    grid = dist.grid()
    M = grid.shape[1]
    if nh % M or conv_ch % M:
        raise ValueError(f"{cfg.name}: {nh} Mamba2 heads and {conv_ch} conv "
                         f"channels do not split over {M} model positions")
    hl, dl = nh // M, nh // M * hd
    every = slice(None)
    ys, ssm_shards, conv_shards = [], {}, {}
    row0 = 0
    for r, x in enumerate(rows):
        B_, S, _ = x.shape
        rs = slice(row0, row0 + B_)
        row0 += B_
        h = rms_norm(x, gather(p["ln"], x.device), cfg.norm_eps)
        gs, sq, convs = [], [], []
        for m in range(M):
            dev = grid[r, m]
            xc, hc = slice(m * dl, (m + 1) * dl), slice(m * hl, (m + 1) * hl)
            bc = slice(di, di + 2 * n)          # B, C of the conv channels
            w = torch.cat([take(p["in_proj"], dev, (every, sl)) for sl in (
                xc, slice(di + xc.start, di + xc.stop),
                slice(2 * di, 2 * di + 2 * n),
                slice(2 * di + 2 * n + hc.start, 2 * di + 2 * n + hc.stop))],
                dim=-1)
            z, xs, Bc, Cc, dt = torch.split(h.to(dev) @ w,
                                            [dl, dl, n, n, hl], dim=-1)
            conv_w = torch.cat([take(p["conv_w"], dev, (every, xc)),
                                take(p["conv_w"], dev, (every, bc))], dim=-1)
            prev = None if state is None else torch.cat(
                [take(state.conv, dev, (rs, every, xc)),
                 take(state.conv, dev, (rs, every, bc))], dim=-1)
            conv_out, new_conv = _causal_conv(
                torch.cat([xs, Bc, Cc], dim=-1), conv_w, prev)
            xs, Bc, Cc = torch.split(F.silu(conv_out), [dl, n, n], dim=-1)
            dt = F.softplus(dt.float() + take(p["dt_bias"], dev, (hc,)))
            A = -torch.exp(take(p["A_log"], dev, (hc,)).float())
            xh = xs.reshape(B_, S, hl, hd)
            ssm0 = None if state is None else take(state.ssm, dev, (rs, hc))
            y, new_ssm = _scan(xh, dt, A, Bc, Cc, ssm0, s_cfg, train)
            y = y.float() + xh.float() \
                * take(p["D"], dev, (hc,))[None, None, :, None]
            g = y.reshape(B_, S, dl).to(x.dtype) * F.silu(z)
            gf = g.float()
            sq.append(torch.sum(gf * gf, dim=-1, keepdim=True))
            gs.append(g)
            if want_state:
                ssm_shards[(r, m)] = new_ssm
                convs.append(new_conv)
        with collective("all-reduce"):
            tot = sq[0].to(x.device)
            for t in sq[1:]:
                tot = tot + t.to(x.device)
        rstd = torch.rsqrt(tot / di + cfg.norm_eps)
        parts = []
        for m, g in enumerate(gs):
            dev = grid[r, m]
            xc = slice(m * dl, (m + 1) * dl)
            yn = (g.float() * rstd.to(dev)).to(g.dtype) \
                * take(p["norm"], dev, (xc,))
            parts.append(yn @ take(p["out_proj"], dev, (xc,)))
        ys.append(layers._psum(parts, x.device))
        if want_state:
            # the row's new conv state, channel-striped over its positions
            full = torch.cat([c[..., :dl].to(x.device) for c in convs]
                             + [convs[0][..., dl:].to(x.device)], dim=-1)
            cw = conv_ch // M
            for j in range(M):
                conv_shards[(r, j)] = full[..., j * cw:(j + 1) * cw].to(
                    grid[r, j])
    if not want_state:
        return ys, None
    b = batch_entry(dist)
    if b is None:       # one row: keys name the model block alone
        ssm_shards = {k[1:]: t for k, t in ssm_shards.items()}
        conv_shards = {k[1:]: t for k, t in conv_shards.items()}
    first_ssm, first_conv = ssm_shards[next(iter(ssm_shards))], \
        conv_shards[next(iter(conv_shards))]
    return ys, MambaState(
        ssm=Sharded(dist.mesh, (b, "model", None, None),
                    (row0, nh) + tuple(first_ssm.shape[2:]), ssm_shards),
        conv=Sharded(dist.mesh, (b, None, "model"),
                     (row0, first_conv.shape[1], conv_ch), conv_shards))
