"""Built-in prefill routing policies — Algorithm 1 and its Figure-8
baselines, ported onto the Arm/registry API.

* ``kvcache`` — full Algorithm 1 (cache-aware + cache load balancing +
  hot-spot migration), plus the SSD load arm on tiered pools and the
  peer-SSD fetch arm when the cluster runs a ``GlobalBlockDirectory``.
* ``cache_aware`` — §6.1 only: always the local prefix, never migrate
  (the Figure 8 "cache-aware" baseline). SSD arm still applies; peer
  arms never do (they are transfers).
* ``load_balance`` — least-loaded prefill instance, prefix incidental.
* ``random`` — uniform random instance.

The arm constructors here are the shared vocabulary every routing policy
builds from; new policies (``load_aware``, ``why_not_both``) reuse them.
Estimation (``propose``) never mutates; the returned closures carry the
side effects.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from repro_torch.core.policies.base import Arm, PolicyContext, register_policy
from repro_torch.core.trace import BLOCK_TOKENS

if TYPE_CHECKING:
    from repro_torch.core.conductor import PrefillInstance
    from repro_torch.core.trace import Request


def find_best_prefix(instances, block_keys):
    """Longest DRAM prefix across the pool and its holder (Alg. 1 l. 4-7)."""
    best_len, best_inst = 0, None
    for inst in instances:
        n = inst.pool.prefix_len(block_keys)
        if n > best_len:
            best_len, best_inst = n, inst
    return best_len, best_inst


def recompute_arm(inst, req, now: float, prefix_len: int = None) -> Arm:
    """Arm 1 — recompute on the instance's local DRAM prefix.

    ``prefix_len`` skips the O(blocks) prefix walk when the caller already
    computed it (policies call it once per instance)."""
    n = inst.pool.prefix_len(req.hash_ids) if prefix_len is None \
        else prefix_len
    t_prefill = inst.cost.prefill_time(req.input_length, n * BLOCK_TOKENS)
    return Arm("recompute", inst, inst.queue_time(now) + t_prefill,
               t_prefill, prefix_blocks=n)


def peer_fetch_arm(ctx: PolicyContext, inst, req, now: float,
                   best_len: int, best_inst,
                   prefix_len: int = None) -> Arm:
    """Arm 2 — cache balancing: replicate the best peer prefix here
    (hot-spot migration, Alg. 1 line 28, happens at commit)."""
    if prefix_len is None:
        prefix_len = inst.pool.prefix_len(req.hash_ids)
    transfer_blocks = best_len - prefix_len
    nbytes = inst.cost.kv_bytes(transfer_blocks * BLOCK_TOKENS)
    t_transfer = ctx.messenger.estimate(best_inst.iid, nbytes, now)
    t_prefill = inst.cost.prefill_time(req.input_length,
                                       best_len * BLOCK_TOKENS)

    def commit(now: float) -> float:
        ctx.messenger.enqueue(best_inst.iid, nbytes, now)
        inst.pool.insert(req.hash_ids[:best_len], start_pos=0)
        return now

    return Arm("peer_fetch", inst,
               t_transfer + inst.queue_time(now) + t_prefill, t_prefill,
               prefix_blocks=best_len, migrate_blocks=transfer_blocks,
               transfer_from=best_inst, commit=commit)


def ssd_load_arm(ctx: PolicyContext, inst, req, now: float) -> Optional[Arm]:
    """Arm 3 — compute-vs-load (Jin et al.): the prefix extends into the
    node's SSD tier; the load is prefetched on the FIFO SSD read channel
    and overlaps the queue wait."""
    tier_prefix = getattr(inst.pool, "tier_prefix", None)
    if tier_prefix is None:
        return None
    tp = tier_prefix(req.hash_ids)
    if tp.ssd == 0:
        return None
    nbytes = inst.cost.kv_bytes(tp.ssd * BLOCK_TOKENS)
    if ctx.messenger.has_ssd_channel(inst.iid):
        t_ssd = ctx.messenger.estimate_ssd(inst.iid, nbytes, now)
    else:
        t_ssd = inst.cost.ssd_load_time(tp.ssd * BLOCK_TOKENS)
    t_prefill = inst.cost.prefill_time(req.input_length,
                                       tp.total * BLOCK_TOKENS)
    arm = Arm("ssd_load", inst, max(inst.queue_time(now), t_ssd) + t_prefill,
              t_prefill, prefix_blocks=tp.total, ssd_blocks=tp.ssd)

    def commit(now: float) -> float:
        if ctx.messenger.has_ssd_channel(inst.iid):
            done = ctx.messenger.enqueue_ssd(inst.iid, nbytes, now)
        else:
            done = now + inst.cost.ssd_load_time(tp.ssd * BLOCK_TOKENS)
        arm.ssd_load_time = done - now
        return done

    arm.commit = commit
    return arm


def peer_ssd_arm(ctx: PolicyContext, inst, req, now: float,
                 instances) -> Optional[Arm]:
    """Arm 4 — the global pool: the chain extends past this instance's
    local residency onto a PEER's SSD (``GlobalBlockDirectory``). The
    fetch is priced as the peer's SSD read + the network hop, prefetched
    like the local SSD arm (it overlaps the queue wait), and the blocks
    REPLICATE here at commit — the peer keeps its copy, exactly like
    hot-spot migration."""
    if ctx.directory is None:
        return None
    tier_prefix = getattr(inst.pool, "tier_prefix", None)
    tp = tier_prefix(req.hash_ids) if tier_prefix is not None else None
    local = tp.total if tp is not None else inst.pool.prefix_len(req.hash_ids)
    k, peer_iid = ctx.directory.best_ssd_extension(
        req.hash_ids, local, exclude={inst.iid})
    if k == 0:
        return None
    peer = next((p for p in instances if p.iid == peer_iid), None)
    if peer is None:
        return None                 # directory names a node we can't route to
    nbytes = inst.cost.kv_bytes(k * BLOCK_TOKENS)
    if ctx.messenger.has_ssd_channel(peer_iid):
        t_fetch = ctx.messenger.estimate_peer_ssd(peer_iid, nbytes, now)
    else:
        t_fetch = inst.cost.peer_ssd_load_time(k * BLOCK_TOKENS)
    # the local prefix's own SSD span still has to load locally
    n_local_ssd = tp.ssd if tp is not None else 0
    t_local = 0.0
    local_bytes = inst.cost.kv_bytes(n_local_ssd * BLOCK_TOKENS)
    if n_local_ssd:
        if ctx.messenger.has_ssd_channel(inst.iid):
            t_local = ctx.messenger.estimate_ssd(inst.iid, local_bytes, now)
        else:
            t_local = inst.cost.ssd_load_time(n_local_ssd * BLOCK_TOKENS)
    prefix = local + k
    t_prefill = inst.cost.prefill_time(req.input_length, prefix * BLOCK_TOKENS)
    arm = Arm("peer_ssd", inst,
              max(inst.queue_time(now), t_fetch, t_local) + t_prefill,
              t_prefill, prefix_blocks=prefix, ssd_blocks=n_local_ssd,
              peer_ssd_blocks=k, transfer_from=peer)

    def commit(now: float) -> float:
        done = ctx.messenger.enqueue_peer_ssd(peer_iid, nbytes, now) \
            if ctx.messenger.has_ssd_channel(peer_iid) \
            else now + inst.cost.peer_ssd_load_time(k * BLOCK_TOKENS)
        if n_local_ssd:
            if ctx.messenger.has_ssd_channel(inst.iid):
                done = max(done, ctx.messenger.enqueue_ssd(
                    inst.iid, local_bytes, now))
            else:
                done = max(done, now + inst.cost.ssd_load_time(
                    n_local_ssd * BLOCK_TOKENS))
        arm.ssd_load_time = done - now
        # replicate the fetched span into the local pool (the Conductor's
        # generic lookup/insert only covers locally-resident prefixes)
        inst.pool.insert(req.hash_ids[local:prefix], start_pos=local)
        return done

    arm.commit = commit
    return arm


# ---------------------------------------------------------------------------


class _RoutingPolicy:
    """Base for routing policies: holds the PolicyContext."""

    def __init__(self, ctx: PolicyContext) -> None:
        self.ctx = ctx


@register_policy("prefill", "random")
class RandomRouting(_RoutingPolicy):
    def propose(self, req, instances, now):
        return [recompute_arm(self.ctx.rng.choice(instances), req, now)]


@register_policy("prefill", "load_balance")
class LoadBalanceRouting(_RoutingPolicy):
    def propose(self, req, instances, now):
        inst = min(instances, key=lambda i: i.queue_free_at)
        return [recompute_arm(inst, req, now)]


@register_policy("prefill", "cache_aware")
class CacheAwareRouting(_RoutingPolicy):
    """§6.1 only: every instance proposes its local arm (plus SSD load on
    tiered pools); no cross-instance transfers ever."""

    def _ssd_arms(self, inst, req, now) -> list[Arm]:
        arm = ssd_load_arm(self.ctx, inst, req, now)
        return [arm] if arm is not None else []

    def _peer_ssd_arms(self, inst, req, now, instances) -> list[Arm]:
        """Global-pool arm (needs ctx.directory); shared by the
        transfer-proposing subclasses — CacheAwareRouting itself stays
        transfer-free per §6.1."""
        arm = peer_ssd_arm(self.ctx, inst, req, now, instances)
        return [arm] if arm is not None else []

    def propose(self, req, instances, now):
        arms = []
        for inst in instances:
            arms.append(recompute_arm(inst, req, now))
            arms.extend(self._ssd_arms(inst, req, now))
        return arms


@register_policy("prefill", "kvcache")
class KVCacheRouting(CacheAwareRouting):
    """Full Algorithm 1: each instance proposes EITHER local recompute or
    fetch-the-best-peer-prefix, gated by the balancing threshold (line 8),
    plus the SSD arm on tiered pools and the peer-SSD arm when a global
    block directory is wired in."""

    def propose(self, req, instances, now):
        block_keys = req.hash_ids
        best_len, best_inst = find_best_prefix(instances, block_keys)
        arms = []
        for inst in instances:
            prefix_len = inst.pool.prefix_len(block_keys)
            ratio = (best_len / prefix_len) if prefix_len else (
                float("inf") if best_len else 1.0)
            if ratio < self.ctx.balancing_threshold or best_inst is None:
                arms.append(recompute_arm(inst, req, now, prefix_len))
            else:
                arms.append(peer_fetch_arm(self.ctx, inst, req, now,
                                           best_len, best_inst, prefix_len))
            arms.extend(self._ssd_arms(inst, req, now))
            arms.extend(self._peer_ssd_arms(inst, req, now, instances))
        return arms
