"""Public ops: paged decode attention, one layer or all layers of a
stacked store in one launch. A CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the hand-written kernel (or the wrapper
raises) — there is no fallback between the two. An input that requires
grad, with grad mode on, raises on either device (forward only:
``kernels.refuse_grad``)."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.paged_attention.kernel import (paged_attention,
                                                        paged_attention_layers)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_layers_ref, paged_attention_ref)


@functools.lru_cache(maxsize=64)
def _grouped_cached(H: int, KV: int, device: str) -> torch.Tensor:
    return torch.tensor([h // (H // KV) for h in range(H)],
                        dtype=torch.int32, device=device)


def grouped_map(H: int, KV: int, device) -> torch.Tensor:
    """Grouped-GQA query-head → KV-head map, h // (H // KV): int32 (H,),
    built once per (H, KV, device) and shared by every later call (a
    decode step asks for it in every layer)."""
    assert H % KV == 0, (H, KV)
    return _grouped_cached(H, KV, str(torch.device(device)))


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                           qh2kv=None, window: int = 0,
                           n_splits: Optional[int] = None) -> torch.Tensor:
    """q (B, H, D) over one layer's paged KV → (B, H, D). ``n_splits``
    forces the kernel's split over tokens (CUDA only: the plain version
    does not split)."""
    refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   seq_lens, qh2kv=qh2kv, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode attention runs on cpu or cuda, "
                         f"not {q.device}")
    if qh2kv is None:
        qh2kv = grouped_map(q.shape[1], k_pages.shape[2], q.device)
    return paged_attention(q, k_pages, v_pages, block_table, seq_lens,
                           qh2kv, window=window, n_splits=n_splits)


def paged_decode_attention_sharded(q, k_pages, v_pages, block_table,
                                   seq_lens, *, mesh, window: int = 0,
                                   n_splits: Optional[int] = None
                                   ) -> torch.Tensor:
    """Mesh entry: one layer's paged decode attention over a (data,
    model) mesh — batch rows split over ``data``, KV-head stripes (and
    the grouped query heads that attend them) over ``model``. Each
    position runs the unchanged ``paged_decode_attention`` (the kernel on
    CUDA) on its rows and stripe, on its own device; the outputs
    reassemble to the global (B, H, D) on q's device. Attention is
    row- and head-local, so with the unsharded call's ``n_splits`` the
    result is bitwise ``paged_decode_attention`` on the whole arrays.
    Grouped GQA only. At this op-level entry the page store is shared by
    every data shard (one bank, global page ids); the engine's
    ``DevicePagePool(mesh=...)`` banks pages per data shard instead."""
    refuse_grad("paged_decode_attention_sharded", q, k_pages, v_pages)
    d = int(mesh.shape.get("data", 1))
    m = int(mesh.shape.get("model", 1))
    B, H, _ = q.shape
    KV = k_pages.shape[2]
    assert H % KV == 0 and KV % m == 0, \
        f"sharded paged attention is grouped-GQA only (H={H}, KV={KV}, m={m})"
    assert B % d == 0, f"{B} rows do not split over data={d}"
    bl, kv_loc = B // d, KV // m
    q_loc = kv_loc * (H // KV)
    rows = []
    for di in range(d):
        r = slice(di * bl, (di + 1) * bl)
        heads = []
        for mi in range(m):
            dev = mesh.devices[di, mi]
            kv = slice(mi * kv_loc, (mi + 1) * kv_loc)
            o = paged_decode_attention(
                q[r, mi * q_loc:(mi + 1) * q_loc].to(dev).contiguous(),
                k_pages[:, :, kv].to(dev).contiguous(),
                v_pages[:, :, kv].to(dev).contiguous(),
                block_table[r].to(dev).contiguous(), seq_lens[r].to(dev),
                window=window, n_splits=n_splits)
            heads.append(o.to(q.device))
        rows.append(torch.cat(heads, dim=1))
    return torch.cat(rows, dim=0)


def paged_decode_attention_layers(qs, k_pages, v_pages, block_table,
                                  seq_lens, *, qh2kv=None,
                                  window: int = 0) -> torch.Tensor:
    """qs (L, B, H, D) over the stacked (L, P, page, KV, D) store →
    (L, B, H, D); on CUDA one kernel launch covers every layer (the
    microbench / layer-parallel entry)."""
    refuse_grad("paged_decode_attention_layers", qs, k_pages, v_pages)
    if qs.device.type == "cpu":
        return paged_attention_layers_ref(qs, k_pages, v_pages, block_table,
                                          seq_lens, qh2kv=qh2kv,
                                          window=window)
    if qs.device.type != "cuda":
        raise ValueError(f"paged decode attention runs on cpu or cuda, "
                         f"not {qs.device}")
    if qh2kv is None:
        qh2kv = grouped_map(qs.shape[2], k_pages.shape[3], qs.device)
    return paged_attention_layers(qs, k_pages, v_pages, block_table,
                                  seq_lens, qh2kv, window=window)
