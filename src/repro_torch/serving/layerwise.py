"""Layer-wise prefill (§5.2) — the port's own copy of the executable half
of the reference's ``serving/layerwise.py``: the load-vs-recompute split
of a tiered prefix (``ChunkOverlapPlan``, ``overlap_split``) that
``PrefillWorker``'s overlapped path runs, and ``verify_stream_order``
on the port's ``prefill``.

The reference's analytic timeline (``schedule``) and its occupation-cost
accounting (``occupation_cost``) price transfers with the simulator's
``CostModel``; they come with the port of the cost model.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig


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
