"""The overlapped compute-AND-load arm — Jin et al., "Compute Or Load KV
Cache? Why Not Both?" (PAPERS.md; closes the ROADMAP open item).

The plain SSD arm is all-or-nothing: load the WHOLE SSD-resident part of
the prefix, then prefill the suffix. Jin et al. observe that recompute and
load use disjoint resources (GPU flops vs SSD read bandwidth), so the
optimal plan splits the prefix: RECOMPUTE the head on the accelerator
*while* the tail streams from SSD, then compute the suffix when both land.

With a tier prefix of ``dram`` free blocks and ``ssd`` demoted blocks, the
arm picks the number of tail blocks ``k`` to load (recomputing the other
``ssd - k`` head blocks) that minimises

    TTFT(k) = max(t_queue + t_head(ssd - k),  t_load(k)) + t_suffix

where ``t_load`` prices the node's FIFO SSD channel backlog and ``t_head``
prices recomputing blocks [dram, dram + ssd - k) of the sequence (the
demoted span is treated as contiguous after the DRAM prefix — block
interleaving makes this an approximation, in the same way the cost model's
leading-prefix accounting already is). ``k = ssd`` degenerates to the
plain SSD arm and ``k = 0`` to pure recompute, so the chosen split is
never predicted-slower than either pure arm — the split search is why not
both.

Everything else (local/peer arms, balancing threshold) is inherited from
``kvcache``; only the SSD arm is replaced by the split-search arm.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.policies.base import Arm, register_policy
from repro_torch.core.policies.routing import KVCacheRouting
from repro_torch.core.trace import BLOCK_TOKENS


@register_policy("prefill", "why_not_both")
class WhyNotBothRouting(KVCacheRouting):

    #: split granularity — candidate k values per arm (quartiles of the
    #: SSD span); the TTFT(k) surface is piecewise-linear in k with one
    #: crossover, so a coarse scan lands within a quartile of optimal
    n_splits = 4

    def _overlap_arm(self, inst, req, now: float) -> Optional[Arm]:
        tier_prefix = getattr(inst.pool, "tier_prefix", None)
        if tier_prefix is None:
            return None
        tp = tier_prefix(req.hash_ids)
        if tp.ssd == 0:
            return None
        L = req.input_length
        d_tok = tp.dram * BLOCK_TOKENS
        t_queue = inst.queue_time(now)
        t_suffix = inst.cost.prefill_time(L, tp.total * BLOCK_TOKENS)
        has_chan = self.ctx.messenger.has_ssd_channel(inst.iid)

        def t_load(k: int) -> float:
            if k == 0:
                return 0.0
            nbytes = inst.cost.kv_bytes(k * BLOCK_TOKENS)
            if has_chan:
                return self.ctx.messenger.estimate_ssd(inst.iid, nbytes, now)
            return inst.cost.ssd_load_time(k * BLOCK_TOKENS)

        ks = sorted({max(round(tp.ssd * f / self.n_splits), 0)
                     for f in range(self.n_splits + 1)})
        best_k, best_ttft, best_head = None, float("inf"), 0.0
        for k in ks:
            m = tp.ssd - k            # head blocks recomputed
            t_head = inst.cost.prefill_time((tp.dram + m) * BLOCK_TOKENS,
                                            d_tok)
            ttft = max(t_queue + t_head, t_load(k)) + t_suffix
            if ttft < best_ttft:
                best_k, best_ttft, best_head = k, ttft, t_head
        if best_k is None:
            return None
        if best_k == 0:
            # recompute the whole demoted span: nothing to enqueue, but the
            # arm must still exist — the inherited gate may have proposed
            # peer_fetch instead of a local recompute for this instance
            return Arm("overlap", inst, best_ttft, best_head + t_suffix,
                       prefix_blocks=tp.total)
        k = best_k
        nbytes = inst.cost.kv_bytes(k * BLOCK_TOKENS)
        arm = Arm("overlap", inst, best_ttft, best_head + t_suffix,
                  prefix_blocks=tp.total, ssd_blocks=k)

        def commit(now: float) -> float:
            if has_chan:
                done = self.ctx.messenger.enqueue_ssd(inst.iid, nbytes, now)
            else:
                done = now + inst.cost.ssd_load_time(k * BLOCK_TOKENS)
            arm.ssd_load_time = done - now
            # the head recompute runs while the tail streams: shifting the
            # land time left by t_head makes the Conductor's generic
            # max(queue, landed) + compute_time reproduce
            # max(queue + t_head, load) + t_suffix exactly
            return done - best_head

        arm.commit = commit
        return arm

    def _ssd_arms(self, inst, req, now) -> list[Arm]:
        arm = self._overlap_arm(inst, req, now)
        return [arm] if arm is not None else []
