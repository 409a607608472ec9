"""Layer-wise prefill (§5.2) — the port's own copy of the reference's
``serving/layerwise.py``.

Mechanism (paper): before layer l's attention, *wait* for layer l's async
KV load and *launch* layer l+1's; after the attention, *launch* layer l's
async store. Total latency then ≈ max(compute, transfer) instead of
compute + transfer.

  * ``schedule`` prices that per-layer timeline analytically off the
    Conductor's ``CostModel``, and ``occupation_cost`` the §5.2 S·T
    accounting of a request's KVCache residency;
  * ``ChunkOverlapPlan``/``overlap_split`` are the executable split of a
    tiered prefix that ``PrefillWorker``'s overlapped path runs (head
    recompute while the tail streams off disk);
  * ``verify_stream_order`` checks the ordering contract on the port's
    ``prefill``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import CostModel, InstanceSpec


@dataclass
class LayerwiseTimeline:
    t_compute_layer: float        # compute time per layer (s)
    t_store_layer: float          # KV store (device→DRAM/remote) per layer
    t_load_layer: float           # prefix KV load per layer
    total_overlapped: float       # layer-wise prefill wall time
    total_serial: float           # store-after-compute wall time
    store_hidden: bool            # store stream fits behind compute?

    @property
    def overhead(self) -> float:
        """Extra latency of layer-wise prefill vs no-store prefill —
        the paper's 'Layer-wise latency' curve in Figure 7."""
        n = max(self.n_layers, 1) if hasattr(self, "n_layers") else 1
        return self.total_overlapped - self.t_compute_layer * n


def schedule(cfg: ModelConfig, input_tokens: int, prefix_tokens: int = 0,
             inst: InstanceSpec = InstanceSpec(),
             store_bw: float | None = None) -> LayerwiseTimeline:
    """Per-layer launch/wait timeline of §5.2.

    Compute proceeds layer by layer; layer l's store starts when its
    attention completes and streams at ``store_bw``. With L layers:

      total_overlapped = t_load_0 + L·t_c + max(0, t_s − t_c)
                         (+ residual if the store stream backlogs)
      total_serial     = t_load_total + L·t_c + L·t_s
    """
    cm = CostModel(cfg, inst)
    L = max(cfg.attention_layers, 1)
    bw = store_bw if store_bw is not None else inst.hw.net_bw
    t_c = cm.prefill_time(input_tokens, prefix_tokens) / L
    per_layer_bytes = cm.kv_bytes(input_tokens) / L
    t_s = per_layer_bytes / bw
    load_bytes = cm.kv_bytes(prefix_tokens) / L
    t_l = load_bytes / inst.hw.dram_bw

    # load of layer l overlaps compute of layer l-1 (wait-before-attend):
    load_exposed = t_l + max(0.0, (L - 1) * (t_l - t_c))
    # stores pipeline behind compute; the last layer's store is exposed,
    # plus any backlog if t_s > t_c
    store_exposed = t_s + max(0.0, (L - 1) * (t_s - t_c))
    total_overlapped = load_exposed + L * t_c + store_exposed
    total_serial = L * (t_l + t_c + t_s)
    tl = LayerwiseTimeline(
        t_compute_layer=t_c, t_store_layer=t_s, t_load_layer=t_l,
        total_overlapped=total_overlapped, total_serial=total_serial,
        store_hidden=t_s <= t_c)
    tl.n_layers = L  # type: ignore[attr-defined]
    return tl


def occupation_cost(cfg: ModelConfig, input_tokens: int, *,
                    inst: InstanceSpec = InstanceSpec(),
                    inline_slowdown: float = 4.0) -> dict:
    """§5.2's S·T argument: VRAM-seconds held by a request's KVCache under
    (a) layer-wise streaming prefill (KV leaves as produced: T ≈ t_layer
    average residency ≈ total/2) and (b) chunked prefill inlined into a
    decode batch (T stretched by ``inline_slowdown``)."""
    cm = CostModel(cfg, inst)
    S = cm.kv_bytes(input_tokens)
    tl = schedule(cfg, input_tokens, inst=inst)
    t_fast = tl.total_overlapped
    return dict(
        kv_bytes=S,
        layerwise_cost=S * t_fast / 2,              # drains as it fills
        inline_cost=S * t_fast * inline_slowdown,   # held for the whole
        ratio=2 * inline_slowdown,                  # stretched prefill
    )


@dataclass
class ChunkOverlapPlan:
    """Per-chunk load-vs-compute schedule for a tiered prefix (§5.2 grafted
    onto Jin et al.'s split): recompute the non-DRAM blocks of
    [dram_head, split) on the card WHILE blocks [split, n) stream from
    SSD layer by layer, then compute the uncached suffix once both land.
    DRAM blocks interleaved inside the head span are ASSEMBLED from the
    pool (chunk-skipping), not recomputed.

    ``t_overlapped``/``t_blocking`` cover the prefix phase only (the suffix
    cost is identical in both schedules and cancels out of the compare).
    """
    split: int                 # first block index loaded (not recomputed)
    n_resident: int
    dram_head: int
    t_head: float              # recompute time of non-DRAM in [dram_head, split)
    t_load: float              # load time of SSD blocks in [split, n)
    t_blocking: float          # load ALL SSD blocks, no overlap
    t_overlapped: float        # max(t_head, t_load)
    head_recompute: int = 0    # non-DRAM blocks recomputed in the head span
    head_skipped: int = 0      # DRAM blocks assembled mid-span (not recomputed)

    @property
    def predicted_speedup(self) -> float:
        return self.t_blocking / self.t_overlapped \
            if self.t_overlapped > 0 else 1.0


def overlap_split(tiers: list[str], t_compute_block: float,
                  t_load_block: float) -> ChunkOverlapPlan:
    """Choose the head/tail split of a resident prefix.

    ``tiers`` is the per-block residency ("dram"/"ssd") of the prefix
    chain, as ``HostKVPool.plan_fetch`` reports it. Candidate split s lies
    in [dram_head, n]: the engine recomputes the NON-DRAM blocks of
    [dram_head, s) — DRAM blocks inside the span are chunk-skipped and
    priced free — and loads the SSD blocks in [s, n). The pick minimises
    max(head recompute, tail load); s = dram_head is the blocking
    all-load schedule and s = n pure recompute, so the chosen split is
    never predicted slower than either.
    """
    n = len(tiers)
    d0 = 0
    while d0 < n and tiers[d0] == "dram":
        d0 += 1
    ssd_after = [0] * (n + 1)       # SSD blocks in [s, n)
    for s in range(n - 1, -1, -1):
        ssd_after[s] = ssd_after[s + 1] + (tiers[s] == "ssd")
    t_blocking = ssd_after[d0] * t_load_block
    best = None
    nondram = 0                     # non-DRAM blocks in [d0, s)
    for s in range(d0, n + 1):
        t_head = nondram * t_compute_block
        t_load = ssd_after[s] * t_load_block
        t_ov = max(t_head, t_load)
        if best is None or t_ov < best[0]:
            best = (t_ov, s, t_head, t_load, nondram)
        if s < n:
            nondram += tiers[s] != "dram"
    t_ov, s, t_head, t_load, rec = best
    skipped = sum(1 for t in tiers[d0:s] if t == "dram")
    return ChunkOverlapPlan(split=s, n_resident=n, dram_head=d0,
                            t_head=t_head, t_load=t_load,
                            t_blocking=t_blocking, t_overlapped=t_ov,
                            head_recompute=rec, head_skipped=skipped)


def verify_stream_order(cfg: ModelConfig, params, tokens) -> bool:
    """Structural check that per-layer KV is available layer by layer:
    the prefill's stacked KV is finite and holds one entry per attention
    layer in layer order — the precondition for §5.2's async store (layer
    l's KV is fully determined before layer l+1 runs)."""
    from repro_torch.models.transformer import prefill
    dev = params["embed"].device
    t = torch.as_tensor(tokens, device=dev).reshape(1, -1)
    _, caches = prefill(params, t, cfg)
    k = caches.kv.k  # (L, B, S, KV, Dh) — the layer-major stream order
    return bool(torch.isfinite(k.float()).all()) and k.shape[0] == \
        cfg.attention_layers
