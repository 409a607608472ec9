"""FlowKV-style load-aware transfer routing (Li et al., PAPERS.md).

Algorithm 1 gates the cache-balancing transfer on a prefix-length RATIO
(best/local >= threshold). That heuristic is blind in two regimes:

  * near-complete local prefixes — a node holding 7 of 8 blocks never
    fetches the last one (8/7 < 1.3) even when the transfer is ~free;
  * queue skew — the cache holder keeps winning min-TTFT while its queue
    grows, and the transfer price that would justify spreading the work
    is never even computed.

This policy drops the ratio gate and PRICES the transfer directly: every
instance proposes BOTH its local-recompute arm and the fetch-best-prefix
arm (the Messenger estimate already includes sender-side congestion, so a
jammed holder link makes fetching expensive on its own), and every arm's
selection score carries a queue-imbalance penalty

    score = ttft + alpha * max(queue_time - mean_queue_time, 0)

so hot nodes shed work slightly before raw min-TTFT would move it —
trading a little predicted latency now for a flatter queue distribution
(the FlowKV "load-aware" trade). ``ttft`` itself stays honest: SLO
admission and the simulator see the unpenalised prediction.
"""
from __future__ import annotations

from repro_torch.core.policies.base import Arm, register_policy
from repro_torch.core.policies.routing import (CacheAwareRouting,
                                               find_best_prefix,
                                               peer_fetch_arm, recompute_arm)


@register_policy("prefill", "load_aware")
class LoadAwareRouting(CacheAwareRouting):

    alpha = 0.5   # seconds of predicted TTFT paid per second of imbalance

    def propose(self, req, instances, now):
        best_len, best_inst = find_best_prefix(instances, req.hash_ids)
        mean_q = sum(i.queue_time(now) for i in instances) / len(instances)
        arms: list[Arm] = []
        for inst in instances:
            penalty = self.alpha * max(inst.queue_time(now) - mean_q, 0.0)
            prefix_len = inst.pool.prefix_len(req.hash_ids)
            local = recompute_arm(inst, req, now, prefix_len)
            local.score = local.ttft + penalty
            arms.append(local)
            if best_inst is not None and best_inst is not inst \
                    and best_len > prefix_len:
                fetch = peer_fetch_arm(self.ctx, inst, req, now,
                                       best_len, best_inst, prefix_len)
                fetch.score = fetch.ttft + penalty
                arms.append(fetch)
            for ssd in self._ssd_arms(inst, req, now):
                ssd.score = ssd.ttft + penalty
                arms.append(ssd)
            for pa in self._peer_ssd_arms(inst, req, now, instances):
                pa.score = pa.ttft + penalty
                arms.append(pa)
        return arms
