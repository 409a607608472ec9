"""Transformer building blocks in PyTorch (bf16 compute, fp32 reductions)
— the counterparts of the reference's ``repro/models/layers.py``: the
attention, MLP and MoE blocks, the paged attention block's KV-head
stripes over a mesh's model axis (``PagedShard``), and the forward on a
(data, model) mesh (``Dist``).

Attention keeps the reference's numerics on its plain paths (``_attend``:
fp32 logits, a -1e30 mask, fp32 softmax, probabilities cast to bf16
before the PV product). On CUDA tensors the two hot spots go to the
hand-written kernels: ``causal_attention`` to the chunked-prefill kernel
and ``paged_attention_block`` to the paged decode kernel, each given the
KV-headed cache plus the query-head → KV-head map, so the per-query-head
KV expansion the reference does with ``jnp.take`` is never materialised
on the card. ``decode_attention``, the dense per-slot oracle, and the
bidirectional attention of the encoder and of cross-attention stay plain,
as in the reference.

On a mesh (``dist.active``) one controller drives every position. The
batch splits over the batch axes into data rows, each a list entry on
its row's first position, where its residual stream lives (a
model-replicated residual, computed once). Over ``model`` the blocks are
Megatron tensor-parallel, as the sharding rules lay the weights out:
attention splits the padded query heads (column-parallel ``wq``, each
position's K/V for the KV heads its query heads read, a local
query-head → KV-head map, row-parallel ``wo``), the MLP its hidden dim,
and the MoE follows the reference's expert- or tensor-parallel
dispatch. Over a KV cache the attention is also context-parallel: the
cache's sequence is striped over the row's positions (``shard_caches``)
and each stripe attends its own slots (``_attention_cache_mesh``). A
row-parallel partial sum is the reference's ``psum``: the partials
summed in fp32 on the row's device and rounded once. The
reference's ``constrain``/``residual_spec``/``batch_spec`` only place
data for XLA, so they have no counterpart.

PyTorch runs eagerly, so a chunk's ``q_offset`` is a plain Python int and
caches are updated in place where the reference rebinds functionally.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shardings import (Sharded, axis_size, collective,
                                          gather, gather_tree, position_device,
                                          take)
from repro_torch.kernels.flash_prefill.ops import flash_prefill_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPE = torch.bfloat16
NEG_INF = -1e30
# Query-chunk length of the plain causal path (bounds the logits buffer).
ATTN_CHUNK_Q = 1024
# Token count at/below which MoE on a mesh uses the global dispatch (all
# rows' tokens at once); above it, the expert- or tensor-parallel path.
# Read at call time, as in the reference.
MOE_GLOBAL_DISPATCH_MAX_TOKENS = 4096
# MoE dispatch group length on a mesh (bounds the dispatch buffer).
MOE_GROUP_TOKENS = 8192

_FORCE_PLAIN = False


class _Logs(threading.local):
    """The routing log of ``record_routing()``, the routing script of
    ``replay_routing()`` and the branch log of ``record_moe_branches()``
    (None when off), each the entering thread's own: two threads may
    replay different routings at once. A remat recompute that autograd
    runs on its CUDA device thread does not see them."""
    routes: Optional[list] = None
    replay: Optional[list] = None
    branches: Optional[list] = None


_LOGS = _Logs()


@contextlib.contextmanager
def plain_attention():
    """Run every kernel op through its plain PyTorch version even on
    CUDA tensors — attention here and the SSD scan in ``models/mamba.py``
    — for holding the kernel path against the plain one on the card.
    Never entered on the serving path."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


@contextlib.contextmanager
def record_routing():
    """Collect the (T, k) expert ids, in choice order, of every
    ``moe_block`` call made inside (one entry per MoE layer per forward,
    in call order) — for setting two runs' routing side by side
    (``dispatched_experts``) or replaying one in the other."""
    prev, _LOGS.routes = _LOGS.routes, []
    try:
        yield _LOGS.routes
    finally:
        _LOGS.routes = prev


@contextlib.contextmanager
def replay_routing(routes: list):
    """Route the ``moe_block`` calls made inside by ``routes`` (what
    ``record_routing`` collected from a run of the same calls), in call
    order, instead of by their own top-k; gates come from this run's
    router. Holds one path's numerics against another's under the same
    routing choices; never entered on the serving path."""
    prev, _LOGS.replay = _LOGS.replay, list(routes)
    try:
        yield
        if _LOGS.replay:
            raise RuntimeError(f"{len(_LOGS.replay)} recorded routes not "
                               f"replayed")
    finally:
        _LOGS.replay = prev


@contextlib.contextmanager
def record_moe_branches():
    """Collect the dispatch each ``moe_block`` call made inside took, in
    call order: "global", "ep" or "tp"."""
    prev, _LOGS.branches = _LOGS.branches, []
    try:
        yield _LOGS.branches
    finally:
        _LOGS.branches = prev


# ---------------------------------------------------------------------------
# the distribution context
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Dist:
    """Distribution context threaded through the forward: a
    ``launch.mesh.Mesh`` (None: one device), the mesh axes that carry the
    batch and the tensor-parallel axis."""
    mesh: Any = None
    batch_axes: Any = ("pod", "data")  # mesh axes carrying the batch dim
    model_axis: str = "model"
    # the most tokens of a MoE layer's global dispatch (None:
    # ``MOE_GLOBAL_DISPATCH_MAX_TOKENS``, read at call time) — a step
    # cut to a mesh's first rows is given the whole step's choice
    moe_global_max_tokens: Optional[int] = None

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def axis_size(self, name) -> int:
        if not self.active:
            return 1
        if isinstance(name, tuple):
            return math.prod(self.mesh.shape[a] for a in name
                             if a in self.mesh.shape)
        return self.mesh.shape.get(name, 1)

    def grid(self) -> np.ndarray:
        """(rows, model) array of devices: one row per index of the batch
        axes (the first batch axis major), its model positions in order;
        every other axis at index 0 (a replica computes nothing new)."""
        names = self.mesh.axis_names
        lead = [a for a in self.batch_axes if a in names]
        if self.model_axis in names:
            lead.append(self.model_axis)
        rest = [a for a in names if a not in lead]
        arr = self.mesh.devices.transpose([names.index(a)
                                           for a in lead + rest])
        arr = arr[(slice(None),) * len(lead) + (0,) * len(rest)]
        return arr.reshape(-1, self.axis_size(self.model_axis))


NO_DIST = Dist()


def split_rows(t: torch.Tensor, dist: Dist) -> list:
    """A batch-leading tensor split into the mesh's data rows, each on
    its row's first position."""
    grid = dist.grid()
    if t.shape[0] % grid.shape[0]:
        raise ValueError(f"a batch of {t.shape[0]} does not split over "
                         f"{grid.shape[0]} data rows")
    return [c.to(d) for c, d in zip(t.chunk(grid.shape[0]), grid[:, 0])]


def join_rows(rows, device) -> torch.Tensor:
    return torch.cat([r.to(device) for r in rows])


def _psum(parts: list, device) -> torch.Tensor:
    """The sum of the model positions' partials on ``device``: fp32
    accumulation, one rounding (a single partial is returned as is)."""
    with collective("all-reduce"):
        if len(parts) == 1:
            return parts[0].to(device)
        acc = parts[0].to(device).float()
        for t in parts[1:]:
            acc = acc + t.to(device).float()
    return acc.to(parts[0].dtype)


def _model_part(leaf, device, dim: int, m: int, n: int) -> torch.Tensor:
    """Slice ``m`` of ``n`` along ``dim`` of a leaf, on ``device``, copied
    only from what holds it (``take``): a sharded leaf split that way
    gathers only that slice."""
    shape = tuple(leaf.shape)
    dim %= len(shape)
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of {shape} does not split over {n} "
                         f"model positions")
    w = shape[dim] // n
    return take(leaf, device, (slice(None),) * dim
                + (slice(m * w, (m + 1) * w),))


def _on_rows(x, dist: Dist, fn):
    """``fn`` over the data rows of x — a list of row tensors, or a whole
    (B, ...) tensor, split into rows and its results joined back on x's
    device. ``fn(rows)`` returns (row outputs, extra)."""
    if isinstance(x, list):
        return fn(x)
    ys, extra = fn(split_rows(x, dist))
    return join_rows(ys, x.device), extra


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (B, S, H, D); positions (B, S) or (S,) integer tensor."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs            # (B, S, d/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _qh2kv_cached(n_q: int, n_kv: int, padded_q: int, device: str):
    group = max(n_q // max(n_kv, 1), 1)
    idx = [min(h // group, n_kv - 1) if h < n_q else 0
           for h in range(padded_q)]
    return torch.tensor(idx, dtype=torch.int32, device=device)


def qh2kv_map(n_q: int, n_kv: int, padded_q: int,
              device="cpu") -> torch.Tensor:
    """Padded-query-head → KV-head map (llama grouping; padded heads read
    KV head 0). int32 (padded_q,), cached per device."""
    return _qh2kv_cached(n_q, n_kv, padded_q, str(torch.device(device)))


def _grouped(cfg: ModelConfig) -> bool:
    """Query heads unpadded and divisible by KV: the contiguous (KV, g)
    grouping equals the qh2kv map, no explicit map needed."""
    return cfg.padded_heads == cfg.n_heads \
        and cfg.padded_heads % cfg.n_kv_heads == 0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask, scale):
    """q (B, Sq, H, D); k, v (B, Sk, H, D) or grouped (B, Sk, KV, D) with
    H = KV·g; mask (B|1, 1, Sq, Sk) bool → (B, Sq, H, D): fp32 logits
    and softmax, the probabilities rounded to v's dtype before the PV
    product."""
    logits = torch.where(mask, _scores(q, k, None, scale), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return _pv(probs.to(v.dtype), v, None).to(v.dtype)


def _scores(q, k, qh2kv, scale: float) -> torch.Tensor:
    """q (B, S, H, D), k (B, Sk, KV, D) → fp32 logits (B, H, S, Sk): the
    grouped contraction where KV divides H without a map, else over the
    keys expanded by ``qh2kv``."""
    B, S, H, D = q.shape
    if qh2kv is None and k.shape[2] != H:
        KV = k.shape[2]
        logits = torch.einsum("bqkgd,bskd->bkgqs",
                              q.reshape(B, S, KV, H // KV, D).float(),
                              k.float()) * scale
        return logits.reshape(B, H, S, k.shape[1])
    return torch.einsum("bqhd,bkhd->bhqk", q.float(),
                        _expand(k, qh2kv).float()) * scale


def _pv(probs, v, qh2kv) -> torch.Tensor:
    """Probabilities (B, H, S, Sk) times v (B, Sk, KV, D) → fp32
    (B, S, H, D)."""
    B, H, S, Sk = probs.shape
    if qh2kv is None and v.shape[2] != H:
        KV = v.shape[2]
        o = torch.einsum("bkgqs,bskd->bqkgd",
                         probs.reshape(B, KV, H // KV, S, Sk).float(),
                         v.float())
        return o.reshape(B, S, H, v.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        _expand(v, qh2kv).float())


def _expand(t: torch.Tensor, qh2kv: Optional[torch.Tensor]) -> torch.Tensor:
    return t if qh2kv is None else t.index_select(2, qh2kv.long())


def causal_attention(q, k, v, q_offset: int, window: int = 0,
                     chunk_q: int = ATTN_CHUNK_Q, *, qh2kv=None):
    """Causal (optionally sliding-window) attention over a full K/V.

    q (B, Sq, H, D) at absolute positions q_offset + [0, Sq); k, v
    (B, Sk, KV, D) at positions [0, Sk), Sk ≥ q_offset + Sq, with KV = H
    (expanded), KV | H (grouped) or any KV with ``qh2kv`` (H,).
    CUDA: the chunked-prefill kernel. CPU: ``chunked_attention``.
    """
    if q.is_cuda and not _FORCE_PLAIN:
        return flash_prefill_attention(q, k, v, q_offset=int(q_offset),
                                       window=window, qh2kv=qh2kv)
    return chunked_attention(q, k, v, q_offset, window, chunk_q, qh2kv=qh2kv)


def chunked_attention(q, k, v, q_offset: int, window: int = 0,
                      chunk_q: int = ATTN_CHUNK_Q, *, qh2kv=None):
    """``causal_attention``'s plain version, on every device: ``_attend``
    over query chunks of ``chunk_q`` rows, each against every key with
    its causal (and window) mask — the reference's ``causal_attention``.
    Built of differentiable ops, it is also the training forward's
    attention (the kernels are forward-only)."""
    q_offset = int(q_offset)
    k, v = _expand(k, qh2kv), _expand(v, qh2kv)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for lo in range(0, Sq, chunk_q):
        hi = min(lo + chunk_q, Sq)
        qpos = q_offset + torch.arange(lo, hi, device=q.device)
        m = qpos[:, None] >= kpos[None, :]
        if window:
            m &= (qpos[:, None] - kpos[None, :]) < window
        outs.append(_attend(q[:, lo:hi], k, v, m[None, None], scale))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len, window: int = 0):
    """One-token attention against a linear cache (the dense per-slot
    oracle; plain PyTorch on every device, as in the reference).

    q (B, 1, H, D); k/v_cache (B, S_cache, H|KV, D) with RoPE applied at
    write time; ``cache_len`` counts tokens written including the current
    one — int or (B,) tensor."""
    B, S, _, D = k_cache.shape
    scale = 1.0 / (D ** 0.5)
    clen = torch.as_tensor(cache_len, device=q.device).long()
    if clen.dim() == 1:
        clen = clen[:, None]                                   # (B, 1)
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < torch.clamp(clen, max=S)                     # (1|B, S)
    if window and S > window:
        valid &= pos >= clen - window
    return _attend(q, k_cache, v_cache, valid[:, None, None, :], scale)


def _qkv(x, p, cfg: ModelConfig, kv: bool = True):
    """Norm and projections → (q, k, v); with ``kv`` False the query only
    (k, v None: a cross-attention block's K/V come from the encoder)."""
    B, S, _ = x.shape
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, Hp, Dh)
    if cfg.attn_bias:
        q = q + p["bq"].reshape(1, 1, Hp, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if not kv:
        return q, None, None
    k = (h @ p["wk"]).reshape(B, S, KV, Dh)
    v = (h @ p["wv"]).reshape(B, S, KV, Dh)
    if cfg.attn_bias:
        k = k + p["bk"].reshape(1, 1, KV, Dh)
        v = v + p["bv"].reshape(1, 1, KV, Dh)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attend_all(q, k, v, qh2kv):
    """Bidirectional attention of q over every key (the encoder's
    self-attention and the decoder's cross-attention): plain ``_attend``
    with an all-true mask on every device, as in the reference, which
    computes both outside any kernel."""
    mask = torch.ones((1, 1, q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    return _attend(q, _expand(k, qh2kv), _expand(v, qh2kv), mask,
                   1.0 / (q.shape[-1] ** 0.5))


def attention_block(x, p, cfg: ModelConfig, dist: Dist = NO_DIST, *,
                    q_offset: int = 0, cache=None, cache_len=None,
                    ring: bool = False, kv_out: bool = False, enc_kv=None,
                    causal: bool = True,
                    window_override: Optional[int] = None,
                    train: bool = False):
    """Attention sub-block: norm → qkv → rope → attend → out proj.

    Returns (y, kv):
      * cross-attention (``enc_kv`` = (k, v), (B, S_enc, KV, Dh), the
        encoder's rope-free K/V): the query alone is projected, carries no
        RoPE and attends every encoder position; kv is None;
      * ``causal`` False (the encoder, no cache): RoPE at positions
        ``q_offset + [0, S)`` and every position attends every other;
      * prefill (``cache`` None): the new (k, v) if ``kv_out`` else None;
        with ``train`` (the training forward) the causal attention is
        ``chunked_attention`` on every device, so gradients flow through
        it;
      * extend/decode (``cache`` = (k_cache, v_cache), (B, S_cache, KV,
        Dh)): the S new tokens are written IN PLACE at ``cache_len`` — an
        int (uniform batch: chunked prefill, the causal kernel's runtime
        q_offset) or a (B,) tensor (continuous batching: dense decode) —
        and the updated cache is returned;
      * ``ring``: the cache IS the sliding window (a ring buffer of
        S_cache slots): one new token per step lands in slot
        ``cache_len % S_cache`` and attends every filled slot.

    ``dist`` active (x a list of data rows, or a whole batch split and
    joined back; kv per row): the causal self-attention is
    tensor-parallel over the query heads (``_attention_mesh``); over a
    cache (``Sharded`` leaves from ``shard_caches``, one length for the
    batch) it is also context-parallel over the cache's sequence stripes
    (``_attention_cache_mesh``) and returns the cache, written in place;
    the encoder's and cross-attention take their leaves whole on each
    row's device (``enc_kv`` then one (k, v) per row, or a whole pair).
    """
    if dist.active:
        if cache is not None:
            return _on_rows(x, dist, lambda rows: _attention_cache_mesh(
                rows, p, cfg, dist, cache=cache, cache_len=cache_len,
                ring=ring, window_override=window_override))
        if enc_kv is None and causal:
            return _on_rows(x, dist, lambda rows: _attention_mesh(
                rows, p, cfg, dist, q_offset=q_offset, kv_out=kv_out,
                window_override=window_override, train=train))

        def whole(rows):
            ekv = enc_kv
            if ekv is not None and not isinstance(ekv, list):
                ekv = list(zip(split_rows(ekv[0], dist),
                               split_rows(ekv[1], dist)))
            outs = [attention_block(
                xr, gather_tree(p, xr.device), cfg, q_offset=q_offset,
                kv_out=kv_out, causal=causal, train=train,
                enc_kv=None if ekv is None else tuple(
                    t.to(xr.device) for t in ekv[r]),
                window_override=window_override)
                for r, xr in enumerate(rows)]
            return [o[0] for o in outs], [o[1] for o in outs]
        return _on_rows(x, dist, whole)

    B, S, _ = x.shape
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if window_override is None else window_override
    qh2kv = None if _grouped(cfg) else qh2kv_map(cfg.n_heads, KV, Hp,
                                                 x.device)
    if enc_kv is not None:
        q, _, _ = _qkv(x, p, cfg, kv=False)
        o = _attend_all(q, enc_kv[0], enc_kv[1], qh2kv)
        return o.reshape(B, S, Hp * Dh) @ p["wo"], None
    q, k, v = _qkv(x, p, cfg)
    ar = torch.arange(S, device=x.device)

    if cache is None:
        positions = q_offset + ar
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if causal:
            attend = chunked_attention if train else causal_attention
            o = attend(q, k, v, q_offset, window, qh2kv=qh2kv)
        else:
            o = _attend_all(q, k, v, qh2kv)
        y = o.reshape(B, S, Hp * Dh) @ p["wo"]
        return y, ((k, v) if kv_out else None)

    k_cache, v_cache = cache
    per_seq = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if per_seq:
        pos = cache_len.to(x.device).long()
        positions = pos[:, None] + ar[None, :]                   # (B, S)
    else:
        pos = int(cache_len)
        positions = (pos + ar)[None, :].expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if ring:
        assert S == 1, "the ring-buffer cache takes one token per step"
        slot = pos % k_cache.shape[1]
        if per_seq:
            rows = torch.arange(B, device=x.device)
            k_cache[rows, slot] = k[:, 0]
            v_cache[rows, slot] = v[:, 0]
        else:
            k_cache[:, slot] = k[:, 0]
            v_cache[:, slot] = v[:, 0]
        o = decode_attention(q, _expand(k_cache, qh2kv),
                             _expand(v_cache, qh2kv), pos + 1, window)
    elif per_seq:
        rows = torch.arange(B, device=x.device)[:, None]
        k_cache[rows, positions] = k
        v_cache[rows, positions] = v
        o = decode_attention(q, _expand(k_cache, qh2kv),
                             _expand(v_cache, qh2kv), pos + S, window)
    else:
        if pos + S > k_cache.shape[1]:
            # a slice past the end would take none of the new tokens (the
            # reference's dynamic_update_slice clamps and overwrites)
            raise ValueError(f"extend of {S} tokens at {pos} past the "
                             f"{k_cache.shape[1]}-slot cache")
        k_cache[:, pos:pos + S] = k
        v_cache[:, pos:pos + S] = v
        o = causal_attention(q, k_cache, v_cache, pos, window, qh2kv=qh2kv)
    y = o.reshape(B, S, Hp * Dh) @ p["wo"]
    return y, (k_cache, v_cache)


def _head_stripes(cfg: ModelConfig, n_model: int) -> list:
    """Each model position's stripe of the padded query heads and what it
    reads: (the KV heads read, ascending; the local query-head → KV-head
    map as a list, or None where it is the grouped (contiguous) one)."""
    Hp = cfg.padded_heads
    if Hp % n_model:
        raise ValueError(f"{Hp} query heads do not split over {n_model} "
                         f"model positions")
    qmap = qh2kv_map(cfg.n_heads, cfg.n_kv_heads, Hp).tolist()
    hl = Hp // n_model
    out = []
    for m in range(n_model):
        heads = qmap[m * hl:(m + 1) * hl]
        used = sorted(set(heads))
        local = [used.index(k) for k in heads]
        g = hl // len(used)
        grouped = hl % len(used) == 0 and local == [h // g for h in range(hl)]
        out.append((used, None if grouped else local))
    return out


def _kv_columns(leaf, device, used: list, Dh: int) -> torch.Tensor:
    """The columns (last axis, KV·Dh) of the KV heads ``used`` of a leaf,
    on ``device``: each run of consecutive heads taken (``take``) from
    the shards that hold it, so a position gathers the heads it reads and
    not the whole leaf."""
    runs: list = []
    for k in used:
        if runs and k == runs[-1][1] + 1:
            runs[-1][1] = k
        else:
            runs.append([k, k])
    lead = (slice(None),) * (len(leaf.shape) - 1)
    parts = [take(leaf, device, lead + (slice(a * Dh, (b + 1) * Dh),))
             for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _stripe_qkv(h, p, cfg: ModelConfig, m: int, M: int, used: list,
                positions):
    """Model position m's projections of the normed rows ``h`` (on its
    device): its stripe of the padded query heads (``wq``'s column slice
    m) and the KV heads ``used``, RoPE applied at ``positions``."""
    Hp, Dh = cfg.padded_heads, cfg.head_dim
    dev = h.device
    B, S, _ = h.shape
    hl = Hp // M
    q = (h @ _model_part(p["wq"], dev, -1, m, M)).reshape(B, S, hl, Dh)
    if cfg.attn_bias:
        q = q + _model_part(p["bq"], dev, -1, m, M).reshape(1, 1, hl, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, gather(p["q_norm"], dev), cfg.norm_eps)
    nu = len(used)
    k = (h @ _kv_columns(p["wk"], dev, used, Dh)).reshape(B, S, nu, Dh)
    v = (h @ _kv_columns(p["wv"], dev, used, Dh)).reshape(B, S, nu, Dh)
    if cfg.attn_bias:
        k = k + _kv_columns(p["bk"], dev, used, Dh).reshape(1, 1, nu, Dh)
        v = v + _kv_columns(p["bv"], dev, used, Dh).reshape(1, 1, nu, Dh)
    if cfg.qk_norm:
        k = rms_norm(k, gather(p["k_norm"], dev), cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _full_kv(ks, vs, stripes, n_kv: int, device):
    """The full-headed (k, v) from the positions' KV heads: each KV head
    from the first position that computed it."""
    src = [next((m, used.index(j)) for m, (used, _) in enumerate(stripes)
                if j in used) for j in range(n_kv)]
    return tuple(torch.stack([t[m][:, :, i].to(device) for m, i in src],
                             dim=2) for t in (ks, vs))


def _attention_mesh(rows, p, cfg: ModelConfig, dist: Dist, *, q_offset: int,
                    kv_out: bool, window_override, train: bool):
    """The causal self-attention of each data row, tensor-parallel over
    its model positions: position m projects its stripe of the padded
    query heads (``wq``'s column slice m) and the KV heads those read,
    attends them under its local query-head → KV-head map (the
    chunked-prefill kernel on CUDA outside training) and applies
    ``wo``'s row slice m; the partials are summed on the row's device.
    Returns (y per row, the full-headed (k, v) per row if ``kv_out``)."""
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if window_override is None else window_override
    grid = dist.grid()
    M = grid.shape[1]
    stripes = _head_stripes(cfg, M)
    hl = Hp // M
    attend = chunked_attention if train else causal_attention
    ys, kvs = [], []
    for r, x in enumerate(rows):
        B, S, D = x.shape
        h = rms_norm(x, gather(p["ln"], x.device), cfg.norm_eps)
        parts, ks, vs = [], [], []
        for m, (used, local) in enumerate(stripes):
            dev = grid[r, m]
            q, k, v = _stripe_qkv(h.to(dev), p, cfg, m, M, used,
                                  q_offset + torch.arange(S, device=dev))
            qh2kv = None if local is None else torch.tensor(
                local, dtype=torch.int32, device=dev)
            o = attend(q, k, v, q_offset, window, qh2kv=qh2kv)
            parts.append(o.reshape(B, S, hl * Dh)
                         @ _model_part(p["wo"], dev, 0, m, M))
            ks.append(k)
            vs.append(v)
        ys.append(_psum(parts, x.device))
        if kv_out:
            kvs.append(_full_kv(ks, vs, stripes, KV, x.device))
    return ys, (kvs if kv_out else None)


def _row_stripes(leaf, dist: Dist, r: int, n_rows: int) -> list:
    """Data row r's part of a batch-leading cache leaf (B, S, ...) placed
    by ``shard_caches``: its stripes along dim 1 in order, each a view on
    its own position's device (written in place)."""
    if not isinstance(leaf, Sharded):
        raise ValueError("on a mesh the caches are Sharded leaves: place "
                         "them with launch.shardings.shard_caches")
    if any(a is not None for a in leaf.spec[2:]):
        raise ValueError(f"a cache leaf sharded past its sequence "
                         f"({leaf.spec})")
    if leaf.spec[0] is not None:
        if axis_size(leaf.mesh, leaf.spec[0]) != n_rows:
            raise ValueError(f"a cache batch split over {leaf.spec[0]} "
                             f"does not match {n_rows} data rows")
        sub = leaf.block(0, r)
        return [sub.shards[k] for k in sorted(sub.shards)]
    rows = leaf.shape[0] // n_rows
    return [t[r * rows:(r + 1) * rows]
            for _, t in sorted(leaf.shards.items())]


def _attention_cache_mesh(rows, p, cfg: ModelConfig, dist: Dist, *, cache,
                          cache_len, ring: bool, window_override):
    """Context-parallel extend/decode of each data row over its cache
    stripes (``shard_caches``: the sequence split into contiguous slot
    ranges, one per position of the row, or of the mesh for a batch of
    one).

    Projections and ``wo`` are ``_attention_mesh``'s: position m of the
    row projects its stripe of the query heads and the KV heads it reads.
    The new tokens' K/V (every KV head) go to the stripes that hold their
    slots — ``cache_len`` onwards, or slot ``cache_len % S_cache`` of a
    ring. The queries of all heads go to every stripe, which computes the
    masked fp32 logits over its slots and their max; once the maxes are
    combined on the row's device, each stripe takes exp(l − max) and its
    sum, and once the sums are combined, its bf16 probabilities (the
    reference's fp32 softmax rounded to bf16) times its V in fp32. Each
    head stripe's owner sums those partials in fp32, rounds once, and
    applies its rows of ``wo``; the row partials are summed as in
    ``_attention_mesh``. The mask is ``decode_attention``'s: slots below
    min(length, S_cache), and for a linear cache of a windowed arch
    longer than the window the last ``window`` positions."""
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
        raise ValueError("the context-parallel decode takes one length for "
                         "the batch (the serve step's), not one per slot")
    k_leaf, v_leaf = cache
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if window_override is None else window_override
    grid = dist.grid()
    M = grid.shape[1]
    stripes = _head_stripes(cfg, M)
    hl = Hp // M
    qmap = None if _grouped(cfg) else qh2kv_map(cfg.n_heads, KV, Hp)
    pos = int(cache_len)
    S_cache = k_leaf.shape[1]
    scale = 1.0 / (Dh ** 0.5)
    ys = []
    for r, x in enumerate(rows):
        B, S, _ = x.shape
        if ring and S != 1:
            raise ValueError("the ring-buffer cache takes one token per step")
        if not ring and pos + S > S_cache:
            raise ValueError(f"extend of {S} tokens at {pos} past the "
                             f"{S_cache}-slot cache")
        ks = _row_stripes(k_leaf, dist, r, len(grid))
        vs = _row_stripes(v_leaf, dist, r, len(grid))
        Sj = S_cache // len(ks)
        h = rms_norm(x, gather(p["ln"], x.device), cfg.norm_eps)
        qs, kn, vn = [], [], []
        for m, (used, _) in enumerate(stripes):
            dev = grid[r, m]
            q, k, v = _stripe_qkv(h.to(dev), p, cfg, m, M, used,
                                  pos + torch.arange(S, device=dev))
            qs.append(q)
            kn.append(k)
            vn.append(v)
        q = torch.cat([t.to(x.device) for t in qs], dim=2)   # (B, S, Hp, Dh)
        k_new, v_new = _full_kv(kn, vn, stripes, KV, x.device)
        lo_new = pos % S_cache if ring else pos
        logits, maxes = [], []
        for j, (kc, vc) in enumerate(zip(ks, vs)):
            dev, lo = kc.device, j * Sj
            a, b = max(lo_new, lo), min(lo_new + S, lo + Sj)
            if a < b:                          # this stripe holds new slots
                kc[:, a - lo:b - lo] = k_new[:, a - lo_new:b - lo_new].to(dev)
                vc[:, a - lo:b - lo] = v_new[:, a - lo_new:b - lo_new].to(dev)
            kpos = lo + torch.arange(Sj, device=dev)[None, :]
            clen = pos + 1 + torch.arange(S, device=dev)[:, None]   # (S, 1)
            valid = kpos < torch.clamp(clen, max=S_cache)
            if window and S_cache > window:
                valid &= kpos >= clen - window
            l = torch.where(valid[None, None], _scores(
                q.to(dev), kc, None if qmap is None else qmap.to(dev),
                scale), NEG_INF)
            logits.append(l)
            maxes.append(l.amax(-1))
        with collective("all-reduce"):
            mx = torch.stack([t.to(x.device) for t in maxes]).amax(0)
        es = [torch.exp(l - mx.to(l.device)[..., None]) for l in logits]
        with collective("all-reduce"):
            tot = es[0].sum(-1).to(x.device)
            for e in es[1:]:
                tot = tot + e.sum(-1).to(x.device)
        outs = [_pv((e / tot.to(e.device)[..., None]).to(DTYPE), vc,
                    None if qmap is None else qmap.to(vc.device))
                for e, vc in zip(es, vs)]                   # (B, S, Hp, Dh)
        parts = []
        for m in range(M):
            dev = grid[r, m]
            with collective("reduce-scatter"):
                acc = outs[0][:, :, m * hl:(m + 1) * hl].to(dev)
                for o in outs[1:]:
                    acc = acc + o[:, :, m * hl:(m + 1) * hl].to(dev)
            parts.append(acc.to(DTYPE).reshape(B, S, hl * Dh)
                         @ _model_part(p["wo"], dev, 0, m, M))
        ys.append(_psum(parts, x.device))
    return ys, cache


@dataclass(frozen=True)
class PagedShard:
    """One data shard's model axis inside ``decode_step_paged_sharded``:
    for each KV-head stripe (model position, in head order), its device
    and that device's copies of the shard's bank-local block table and
    lengths. ``n_model == 1`` on the data shard's own device is the
    single-device step."""
    devices: tuple
    block_tables: tuple
    seq_lens: tuple

    @property
    def n_model(self) -> int:
        return len(self.devices)


def _scatter_attend(q, k, v, k_pages, v_pages, block_table, pos, qh2kv,
                    window: int):
    """Write each slot's new (k, v) row (B, KV, Dh) into its tail page
    (inactive slots write the null page 0, which is never read), then
    attend q (B, H, Dh) through the block table → (B, H, Dh)."""
    B = q.shape[0]
    pt = k_pages.shape[1]
    pidx = torch.clamp(pos.long() // pt, 0, block_table.shape[1] - 1)
    pids = block_table[torch.arange(B, device=q.device), pidx].long()
    offs = pos.long() % pt
    k_pages[pids, offs] = k
    v_pages[pids, offs] = v
    lens = (pos + 1).to(torch.int32)
    attend = paged_attention_ref if q.is_cuda and _FORCE_PLAIN \
        else paged_decode_attention
    return attend(q, k_pages, v_pages, block_table, lens, qh2kv=qh2kv,
                  window=window)


def paged_attention_block(x, p, cfg: ModelConfig, *, k_pages, v_pages,
                          block_table, seq_lens,
                          window_override: Optional[int] = None,
                          shard: Optional[PagedShard] = None):
    """Decode attention sub-block over one layer's PAGED KV store:
    norm → qkv → rope at each slot's depth → scatter the new token's K/V
    into the slot's tail page → attend through the block table.

    x (B, 1, D); k/v_pages (P, page, KV, Dh), updated IN PLACE (the
    reference rebinds ``.at[].set``); block_table (B, max_pages) int32;
    seq_lens (B,) int32 tokens already written per slot. The engine makes
    every active slot's tail page exclusively owned before the step
    (copy-on-write), and inactive slots (length 0, table row 0) write the
    null page 0, which is never read. Returns y (B, 1, D).

    ``shard``: KV heads are striped over the data shard's model
    positions, and k/v_pages are per-stripe slabs (P, page, KV/m, Dh), one
    per position in head order, each on its position's device (which
    takes the block table and lengths from ``shard``). The projections
    compute the FULL head set on x's device, so every per-head value is
    the single-device one; each stripe (KV/m KV heads and their g·KV/m
    query heads, grouped GQA only) is written and attended on its own
    device; the stripes' outputs concatenate on the head axis ahead of
    the output projection — the exact recombination, never a partial-sum
    reduce.
    """
    B, S, _ = x.shape
    assert S == 1, "paged decode is one token per slot per step"
    Hp, KV, Dh = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if window_override is None else window_override
    qh2kv = None if _grouped(cfg) else qh2kv_map(cfg.n_heads, KV, Hp,
                                                 x.device)
    q, k, v = _qkv(x, p, cfg)
    pos = seq_lens
    positions = pos.long()[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if shard is None:
        o = _scatter_attend(q[:, 0], k[:, 0], v[:, 0], k_pages, v_pages,
                            block_table, pos, qh2kv, window)
    else:
        m = shard.n_model
        if m > 1:
            assert qh2kv is None and KV % m == 0, \
                "model-parallel KV heads require grouped GQA with KV % m == 0"
        kv_loc = KV // m
        q_loc = Hp // m
        outs = []
        for mi, dev in enumerate(shard.devices):
            qs = q[:, 0, mi * q_loc:(mi + 1) * q_loc].to(dev).contiguous()
            ks = k[:, 0, mi * kv_loc:(mi + 1) * kv_loc].to(dev)
            vs = v[:, 0, mi * kv_loc:(mi + 1) * kv_loc].to(dev)
            outs.append(_scatter_attend(
                qs, ks, vs, k_pages[mi], v_pages[mi], shard.block_tables[mi],
                shard.seq_lens[mi], None if qh2kv is None else qh2kv.to(dev),
                window))
        o = torch.cat([t.to(x.device) for t in outs], dim=1)
    return o.reshape(B, S, Hp * Dh) @ p["wo"]


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_block(x, p, cfg: ModelConfig, dist: Dist = NO_DIST):
    """Gated MLP. ``dist`` active: tensor-parallel over the hidden dim
    (``w1``/``w3`` by columns, ``w2`` by rows, the partials summed)."""
    if dist.active:
        return _on_rows(x, dist, lambda rows: (
            [_mlp_mesh(xr, p, cfg, dist.grid()[r]) for r, xr in
             enumerate(rows)], None))[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    gate = F.silu(h @ p["w1"])
    up = h @ p["w3"]
    return (gate * up) @ p["w2"]


def _mlp_mesh(x, p, cfg: ModelConfig, devices) -> torch.Tensor:
    """One data row's MLP over its model positions ``devices``."""
    M = len(devices)
    h = rms_norm(x, gather(p["ln"], x.device), cfg.norm_eps)
    parts = []
    for m, dev in enumerate(devices):
        hm = h.to(dev)
        gate = F.silu(hm @ _model_part(p["w1"], dev, -1, m, M))
        up = hm @ _model_part(p["w3"], dev, -1, m, M)
        parts.append((gate * up) @ _model_part(p["w2"], dev, 0, m, M))
    return _psum(parts, x.device)


# ---------------------------------------------------------------------------
# MoE (single device: the reference's ``_moe_dispatch_compute`` path)
# ---------------------------------------------------------------------------

def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest in descending order, the lower
    index first among equal values (a stable descending sort; bare
    ``torch.topk`` breaks ties its own way)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(gates_idx, n_experts: int, capacity: int):
    """gates_idx (T, k) expert ids → flat slot ids (T*k,) into an
    (E*C [+1 overflow]) buffer, in the flat (T, k) order; slot E*C means
    'dropped'."""
    flat_e = gates_idx.reshape(-1).long()
    oh = F.one_hot(flat_e, n_experts)                        # (Tk, E)
    pos = torch.cumsum(oh, dim=0) - oh
    pos_e = torch.sum(pos * oh, dim=-1)     # position within its expert
    slot = flat_e * capacity + pos_e
    return torch.where(pos_e < capacity, slot, n_experts * capacity)


def _expert_ffn(buf, w1, w2, w3):
    """buf (E, C, D); w1, w3 (E, D, F), w2 (E, F, D) → (E, C, D)."""
    gate = F.silu(torch.bmm(buf, w1))
    up = torch.bmm(buf, w3)
    return torch.bmm(gate * up, w2)


def _route(xf, router_w, top_k: int):
    """Router logits from fp32 operands, as the reference's steps compute
    them: under jit XLA keeps its ``(xf @ router_w).astype(float32)`` in
    fp32; only an op-by-op run rounds the product to bf16 first."""
    logits = xf.float() @ router_w.float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if _LOGS.replay is not None:
        idx = _LOGS.replay.pop(0).to(probs.device)
        if idx.shape != (probs.shape[0], top_k):
            raise RuntimeError(f"replayed routes {tuple(idx.shape)} do not "
                               f"fit {probs.shape[0]} rows of top-{top_k}")
        gates = torch.gather(probs, -1, idx)
    else:
        gates, idx = _top_k(probs, top_k)                     # (T, k)
    if _LOGS.routes is not None:
        _LOGS.routes.append(idx.clone())
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch-style): E * mean(f_e * p_e)
    E = router_w.shape[-1]
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(idx[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce)
    return gates.to(xf.dtype), idx, aux


def _moe_dispatch_compute(xf, router_w, w1, w2, w3, top_k: int,
                          capacity: int):
    """Capacity-routed MoE on a flat token slab (T, D) → (y, aux). Kept
    rows are written to their unique slots by index (dropped ones to the
    overflow row, discarded); a dropped choice reads the zero row back.
    The writes are out of place, so autograd takes them as they are."""
    T, D = xf.shape
    E = router_w.shape[-1]
    gates, idx, aux = _route(xf, router_w, top_k)
    slot = _dispatch_indices(idx, E, capacity)                # (T*k,)
    buf = xf.new_zeros((E * capacity + 1, D)).index_put(
        (slot,), xf.repeat_interleave(top_k, dim=0))
    out = _expert_ffn(buf[:-1].view(E, capacity, D), w1, w2, w3)
    out_flat = torch.cat([out.reshape(E * capacity, D), xf.new_zeros((1, D))])
    y = out_flat[slot].view(T, top_k, D)
    return torch.sum(y * gates[:, :, None], dim=1), aux


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Expert capacity for a slab of ``n_tokens`` rows (the reference's
    ``cap_of``, in its float order)."""
    moe = cfg.moe
    return max(int(n_tokens * moe.top_k / moe.n_experts
                   * moe.capacity_factor + 0.999), moe.top_k)


def dispatched_experts(cfg: ModelConfig, idx: torch.Tensor) -> torch.Tensor:
    """The (T, k) expert ids of one ``moe_block`` call over T rows → the
    experts that computed each row, ascending, a choice dropped at the
    call's capacity as -1."""
    E, C = cfg.moe.n_experts, moe_capacity(cfg, idx.shape[0])
    slot = _dispatch_indices(idx, E, C).view(idx.shape)
    return torch.where(slot < E * C, idx, -1).sort(dim=-1).values


def moe_block(x, p, cfg: ModelConfig, dist: Dist = NO_DIST):
    """x (B, S, D) → (y, aux loss). Every row handed over takes part in
    the routing — a paged step's idle slots too — and the capacity is
    that of all B·S rows.

    ``dist`` active (x a list of data rows or a whole batch): the
    reference's choice of dispatch over all T = B·S tokens — global (all
    tokens routed at once on the first position, each expert run where
    its weights are, ``_moe_global``) at T ≤
    ``MOE_GLOBAL_DISPATCH_MAX_TOKENS`` (``dist.moe_global_max_tokens``
    where set); expert-parallel when the config
    says "ep", the experts divide over ``model`` and T over data × model
    (``_moe_ep``); else tensor-parallel experts (``_moe_tp``)."""
    if not dist.active:
        B, S, D = x.shape
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        T = B * S
        y, aux = _moe_dispatch_compute(
            h.reshape(T, D), p["router"], p["w1"], p["w2"], p["w3"],
            cfg.moe.top_k, moe_capacity(cfg, T))
        return y.reshape(B, S, D), aux
    return _on_rows(x, dist, lambda rows: _moe_mesh(rows, p, cfg, dist))


def _moe_mesh(rows, p, cfg: ModelConfig, dist: Dist):
    moe = cfg.moe
    grid = dist.grid()
    dp, ep = grid.shape
    T_total = sum(r.shape[0] * r.shape[1] for r in rows)
    hs = [rms_norm(x, gather(p["ln"], x.device), cfg.norm_eps).reshape(
        -1, x.shape[-1]) for x in rows]
    most = MOE_GLOBAL_DISPATCH_MAX_TOKENS if dist.moe_global_max_tokens \
        is None else dist.moe_global_max_tokens
    if T_total <= most:
        branch = "global"
    elif moe.parallelism == "ep" and moe.n_experts % ep == 0 \
            and T_total % (dp * ep) == 0:
        branch = "ep"
    else:
        branch = "tp"
    if _LOGS.branches is not None:
        _LOGS.branches.append(branch)
    if branch == "global":
        ys, aux = _moe_global(hs, p, cfg, grid, T_total)
        return [y.view(x.shape) for y, x in zip(ys, rows)], aux
    T_loc = T_total // (dp * ep) if branch == "ep" else T_total // dp
    n_groups = max(T_loc // MOE_GROUP_TOKENS, 1)
    if T_loc % n_groups:
        raise ValueError(f"{T_loc} tokens a position do not split into "
                         f"{n_groups} dispatch groups")
    cap = moe_capacity(cfg, T_loc // n_groups)
    run = _moe_ep if branch == "ep" else _moe_tp
    ys, auxes = [], []
    for r, (x, h) in enumerate(zip(rows, hs)):
        y, a = run(h, p, cfg, grid[r], cap, n_groups)
        ys.append(y.view(x.shape))
        auxes.extend(a)
    # the reference's pmean over the token axes (EP) / batch axes (TP)
    dev = grid[0, 0]
    with collective("all-reduce"):
        aux = sum(a.to(dev) for a in auxes) / len(auxes)
    return ys, aux


def expert_owners(w1, grid: np.ndarray) -> list:
    """The positions that hold the experts' weights under
    ``shard_params``, block-major: each 'model' block of ``w1`` (a block
    of the experts of an "ep" config, of every expert's hidden columns of
    a "tp" one), then its FSDP shards over 'data' in order. A leaf not
    sharded over 'model': the grid's columns, then rows."""
    if isinstance(w1, Sharded) and "model" in w1.spec:
        return [position_device(w1.mesh, c) for c in owner_coords(w1)]
    return [d for m in range(grid.shape[1]) for d in grid[:, m]]


def owner_coords(w1: Sharded) -> list:
    """The mesh coordinates ({axis: index}) of ``expert_owners``'
    positions, in its order."""
    j = w1.dims().index(w1.spec.index("model"))
    return [w1.coords(k) for k in sorted(w1.shards, key=lambda k: (k[j], k))]


def owner_experts(n_experts: int, n_owners: int) -> list:
    """The experts each owner of the global dispatch runs, in
    ``expert_owners``' order: the experts split evenly, in order (an
    owner may run none)."""
    return [slice(i * n_experts // n_owners, (i + 1) * n_experts // n_owners)
            for i in range(n_owners)]


def _moe_global(hs, p, cfg: ModelConfig, grid, T_total: int):
    """The global dispatch over every data row's normed tokens (``hs``,
    one (T_r, D) slab a row on its device), with the reference's
    numerics: routed together on the mesh's first position, at the
    capacity of all ``T_total`` of them, into one (E, cap, D) buffer,
    whose expert slabs are run where the weights are. The experts split
    evenly, in order, over the positions of ``expert_owners`` — for an
    "ep" config each position's experts are among those it holds — and
    each position receives its experts' slabs and takes its experts'
    whole weights (a "tp" config's hidden columns gathered from the
    shards, as an FSDP gather: no partial sums, so the expert outputs are
    bitwise those of one product), and sends its outputs back, as
    ``_moe_ep``'s slabs travel. Each row is sent its choices' outputs,
    which it weights and sums. No position gathers a whole ``w1``,
    ``w2`` or ``w3`` unless it is the only one. Returns (y per row,
    aux)."""
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    dev = grid[0, 0]
    cap = moe_capacity(cfg, T_total)
    h = torch.cat([t.to(dev) for t in hs])
    gates, idx, aux = _route(h, gather(p["router"], dev), k)
    buf, slot = _dispatch(h, idx, E, cap)                     # (E, cap, D)
    # each T-sized buffer is freed before the next is made: they all sit
    # on the first position, whose peak grows with the rows' tokens
    del h
    owners = expert_owners(p["w1"], grid)
    outs = []
    for d, e in zip(owners, owner_experts(E, len(owners))):
        if e.stop == e.start:
            continue
        with collective("all-to-all"):
            recv = buf[e].to(d)
        o = _expert_ffn(recv, *(take(p[n], d, (e,))
                                for n in ("w1", "w2", "w3")))
        with collective("all-to-all"):
            outs.append(o.to(dev))
    del buf
    D = outs[0].shape[-1]
    out_flat = torch.cat([o.reshape(-1, D) for o in outs]
                         + [outs[0].new_zeros((1, D))])
    del outs
    sel = out_flat[slot]                  # (T·k, D); a dropped choice: 0
    del out_flat
    # split, not sliced row by row: a slice's backward writes a zero-filled
    # gradient of the whole, once a row; a split's joins the rows' once
    sizes = [x.shape[0] for x in hs]
    ys = []
    for x, part, g in zip(hs, sel.split([n * k for n in sizes]),
                          gates.split(sizes)):
        with collective("all-to-all"):
            mine = part.to(x.device)
        g = g.to(x.device)
        ys.append(torch.sum(mine.view(x.shape[0], k, D) * g[:, :, None],
                            dim=1))
    return ys, aux


def _group_combine(out, slot, gates, E: int, cap: int):
    """The expert outputs (E, cap, D) read back at each choice's slot
    (a dropped choice reads a zero row) and weighted by its gate."""
    D = out.shape[-1]
    out_flat = torch.cat([out.reshape(E * cap, D), out.new_zeros((1, D))])
    G, k = gates.shape
    return torch.sum(out_flat[slot].view(G, k, D) * gates[:, :, None], dim=1)


def _dispatch(xg, idxg, E: int, cap: int):
    """A group's rows into its (E, cap, D) capacity buffer; with the
    flat slot of each (row, choice)."""
    slot = _dispatch_indices(idxg, E, cap)
    D = xg.shape[-1]
    buf = xg.new_zeros((E * cap + 1, D)).index_put(
        (slot,), xg.repeat_interleave(idxg.shape[1], dim=0))
    return buf[:-1].view(E, cap, D), slot


def _moe_ep(h, p, cfg: ModelConfig, devices, cap: int, n_groups: int):
    """One data row, expert-parallel: position m routes its contiguous
    slice of the row's tokens and holds experts [m·E/ep, (m+1)·E/ep).
    Per group, the reference's tiled ``all_to_all`` both ways: position m
    receives every position's capacity slab of its experts, in source
    order along the capacity axis, computes them, and returns each
    source's slab. Returns (y (T, D), each position's aux)."""
    ep = len(devices)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    E_loc = E // ep
    with collective("all-to-all"):
        xs = [c.to(d) for c, d in zip(h.chunk(ep), devices)]
    routed = [_route(xf, gather(p["router"], d), k)
              for xf, d in zip(xs, devices)]
    w = [tuple(_model_part(p[n], d, 0, m, ep) for n in ("w1", "w2", "w3"))
         for m, d in enumerate(devices)]
    ys = [[] for _ in devices]
    for g in range(n_groups):
        bufs, slots, gates = [], [], []
        for (gt, idx, _), xf in zip(routed, xs):
            G = xf.shape[0] // n_groups
            sl = slice(g * G, (g + 1) * G)
            buf, slot = _dispatch(xf[sl], idx[sl], E, cap)
            bufs.append(buf)
            slots.append(slot)
            gates.append(gt[sl])
        outs = []
        for m, d in enumerate(devices):
            with collective("all-to-all"):
                recv = torch.cat([b[m * E_loc:(m + 1) * E_loc].to(d)
                                  for b in bufs], dim=1)   # (E_loc, ep·C, D)
            outs.append(_expert_ffn(recv, *w[m]))
        for i, d in enumerate(devices):
            with collective("all-to-all"):
                back = torch.cat([o[:, i * cap:(i + 1) * cap].to(d)
                                  for o in outs])           # (E, C, D)
            ys[i].append(_group_combine(back, slots[i], gates[i], E, cap))
    with collective("all-to-all"):
        y = torch.cat([torch.cat(parts).to(h.device) for parts in ys])
    return y, [a for _, _, a in routed]


def _moe_tp(h, p, cfg: ModelConfig, devices, cap: int, n_groups: int):
    """One data row, tensor-parallel experts: the row's tokens routed
    once on its device (every model position would route them alike),
    each group's capacity buffer run through every position's slice of
    the experts' hidden dim, the partial outputs summed. Returns (y (T,
    D), [aux])."""
    M = len(devices)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    gates, idx, aux = _route(h, gather(p["router"], h.device), k)
    w = [(_model_part(p["w1"], d, -1, m, M), _model_part(p["w2"], d, -2, m, M),
          _model_part(p["w3"], d, -1, m, M)) for m, d in enumerate(devices)]
    G = h.shape[0] // n_groups
    ys = []
    for g in range(n_groups):
        sl = slice(g * G, (g + 1) * G)
        buf, slot = _dispatch(h[sl], idx[sl], E, cap)
        out = _psum([_expert_ffn(buf.to(d), *w[m])
                     for m, d in enumerate(devices)], h.device)
        ys.append(_group_combine(out, slot, gates[sl], E, cap))
    return torch.cat(ys), [aux]
