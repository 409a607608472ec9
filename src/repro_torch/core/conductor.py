"""Conductor — Mooncake's KVCache-centric global scheduler (§6,
Algorithm 1); the port's own copy of the reference's ``core/conductor.py``.

For each request the Conductor asks its prefill routing policy for a list
of candidate ``Arm``s — ways to serve the prefill, each with a predicted
TTFT — and commits the best one. The built-in arms are

  * recompute (cache-aware, local):  T_queue + T_prefill(len, local_prefix)
  * peer fetch (cache balancing):    T_transfer + T_queue + T_prefill(len, best_prefix)
  * SSD load (compute-vs-load):      max(T_queue, T_ssd_load) + T_prefill(len, tier_prefix)
  * overlap (why-not-both):          max(T_queue + T_head, T_ssd_load) + T_suffix
  * peer SSD (global pool):          max(T_queue, T_peer_ssd + T_hop) + T_prefill(len, ext_prefix)

The SSD load is *prefetched*: it starts immediately on the node's SSD read
channel and overlaps the queue wait, so only the slower of queue-drain and
load delays the compute. The channel serialises loads FIFO
(``Messenger.estimate_ssd``), so a node whose SSD is already streaming one
long prefix makes the next load correctly expensive. Which arms exist for
a request is the routing policy's business (``strategy`` resolves through
the policy registry — see ``repro_torch.core.policies``); the Conductor is only
the commit machinery: SLO admission (line 25), hot-spot migration
bookkeeping (line 28 — hot blocks spread automatically because they keep
winning matches), queue/pool/decode accounting.

Overload-oriented admission policies (§7) wrap ``schedule`` with earlier,
load-based rejection — see ``repro_torch.core.policies.admission``. They
set the ``accounting`` knob ("pending" counts accepted-but-still-
prefilling work in decode pre-selection; "current" reproduces the §7.2
time lag).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.cache import CachePool
from repro_torch.core.costmodel import CostModel
from repro_torch.core.messenger import Messenger
from repro_torch.core.policies.base import Arm, PolicyContext, get_policy
from repro_torch.core.trace import BLOCK_TOKENS, Request


@dataclass
class PrefillInstance:
    """One prefill node (group): local cache pool + FIFO work queue."""
    iid: int
    pool: CachePool
    cost: CostModel
    queue_free_at: float = 0.0     # time the queue drains
    total_busy: float = 0.0
    n_scheduled: int = 0

    def queue_time(self, now: float) -> float:
        return max(self.queue_free_at - now, 0.0)

    def utilization(self, now: float) -> float:
        return self.total_busy / now if now > 0 else 0.0


@dataclass
class DecodeInstance:
    """One decoding node: continuous batch of active requests."""
    iid: int
    cost: CostModel
    active: int = 0                 # requests in the batch
    kv_tokens: float = 0.0          # total context tokens held
    pending: int = 0                # accepted, prefill not yet done
    pending_tokens: float = 0.0
    n_scheduled: int = 0

    def avg_ctx(self) -> float:
        return self.kv_tokens / self.active if self.active else 0.0

    def predicted_tbt(self, extra_reqs: int = 0, extra_tokens: float = 0.0,
                      include_pending: bool = True) -> float:
        b = self.active + extra_reqs + (self.pending if include_pending else 0)
        toks = self.kv_tokens + extra_tokens \
            + (self.pending_tokens if include_pending else 0.0)
        if b == 0:
            return 0.0
        return self.cost.decode_iter_time(b, toks / b)

    def vram_ok(self, extra_tokens: float, include_pending: bool = True) -> bool:
        cap = self.cost.decode_capacity_tokens()
        held = self.kv_tokens + (self.pending_tokens if include_pending else 0.0)
        return held + extra_tokens <= cap


@dataclass
class Decision:
    accepted: bool
    prefill: Optional[PrefillInstance] = None
    decode: Optional[DecodeInstance] = None
    expected_ttft: float = 0.0
    expected_tbt: float = 0.0
    prefix_blocks: int = 0              # blocks reused (local or migrated)
    migrated_blocks: int = 0            # hot-spot replication volume
    transfer_from: Optional[int] = None
    ssd_blocks: int = 0                 # prefix blocks loaded from local SSD
    peer_ssd_blocks: int = 0            # prefix blocks fetched off a peer SSD
    ssd_load_time: float = 0.0          # committed load duration incl. channel
                                        # backlog (overlaps the queue wait)
    compute_time: float = 0.0           # prefill busy-time the arm charges
    arm_kind: str = ""                  # which arm won (see policies.base.Arm)
    reject_reason: str = ""


class Conductor:
    """Algorithm 1 + hot-spot migration, driven by registry policies.

    ``strategy`` names a registered prefill routing policy — built-ins:

    * ``kvcache`` — full Algorithm 1 (cache-aware + cache load balancing)
    * ``cache_aware`` — §6.1 only: always use the local prefix, never
      migrate (the Figure 8 "cache-aware" baseline)
    * ``load_balance`` — pick the least-loaded prefill instance
    * ``random`` — uniform random instance
    * ``load_aware`` — FlowKV-style priced transfers + imbalance penalty
    * ``why_not_both`` — overlapped head-recompute + tail-SSD-load arm

    ``accounting`` ("pending" | "current") controls whether decode
    pre-selection counts accepted-but-still-prefilling requests; §7
    admission policies set it to match their stage model.
    """

    def __init__(self, prefills: list[PrefillInstance],
                 decodes: list[DecodeInstance], messenger: Messenger, *,
                 ttft_slo: float, tbt_slo: float,
                 balancing_threshold: float = 1.3,
                 strategy: str = "kvcache", decode_policy: str = "min_tbt",
                 accounting: str = "pending", rng=None,
                 directory=None) -> None:
        self.P = prefills
        self.D = decodes
        self.messenger = messenger
        self.ttft_slo = ttft_slo
        self.tbt_slo = tbt_slo
        import random as _random
        self.ctx = PolicyContext(messenger=messenger,
                                 balancing_threshold=balancing_threshold,
                                 rng=rng or _random.Random(0),
                                 directory=directory)
        self.strategy = strategy
        self.prefill_policy = get_policy("prefill", strategy)(self.ctx)
        self.decode_policy = get_policy("decode", decode_policy)(self.ctx)
        self.accounting = accounting
        self.n_migrations = 0
        self.migrated_bytes = 0.0
        self.n_ssd_loads = 0
        self.ssd_loaded_bytes = 0.0
        self.n_peer_ssd_loads = 0
        self.peer_ssd_bytes = 0.0

    @property
    def threshold(self) -> float:
        return self.ctx.balancing_threshold

    @property
    def accounting(self) -> str:
        return self._accounting

    @accounting.setter
    def accounting(self, mode: str) -> None:
        if mode not in ("pending", "current"):
            raise ValueError(f"accounting must be 'pending' or 'current', "
                             f"got {mode!r}")
        self._accounting = mode

    @property
    def account_pending(self) -> bool:
        """Whether decode pre-selection counts in-flight commitments."""
        return self.accounting == "pending"

    def propose(self, req: Request, now: float) -> list[Arm]:
        """Candidate arms for a request (pure — no side effects)."""
        return self.prefill_policy.propose(req, self.P, now)

    # ---- the public entry point ---------------------------------------
    def schedule(self, req: Request, now: float) -> Decision:
        arms = self.propose(req, now)
        if not arms:
            return Decision(False, reject_reason="no prefill arm")
        arm = min(arms, key=lambda a: a.sort_key)   # first wins ties
        if arm.ttft > self.ttft_slo:
            # a score-biased pick (e.g. load_aware's imbalance penalty) must
            # not reject a request another proposed arm could serve in SLO
            arm = min(arms, key=lambda a: a.ttft)
        d, tbt = self.decode_policy.select(req, self.D, now,
                                           include_pending=self.account_pending)
        if d is None:
            return Decision(False, reject_reason="no decode slot (VRAM)")
        if arm.ttft > self.ttft_slo or tbt > self.tbt_slo:
            reason = "TTFT SLO" if arm.ttft > self.ttft_slo else "TBT SLO"
            return Decision(False, reject_reason=reason,
                            expected_ttft=arm.ttft, expected_tbt=tbt)

        # ---- commit: the arm's own side effects (peer transfer enqueue +
        # block replication, SSD channel enqueue) happen in its closure;
        # ``load_done`` is when the arm's data lands — compute starts once
        # both the queue has drained and the data is there.
        inst = arm.instance
        load_done = arm.land(now)
        if arm.migrate_blocks and arm.transfer_from is not None:
            self.n_migrations += 1
            self.migrated_bytes += inst.cost.kv_bytes(
                arm.migrate_blocks * BLOCK_TOKENS)
        if arm.ssd_blocks:
            self.n_ssd_loads += 1
            self.ssd_loaded_bytes += inst.cost.kv_bytes(
                arm.ssd_blocks * BLOCK_TOKENS)
        if arm.peer_ssd_blocks:
            self.n_peer_ssd_loads += 1
            self.peer_ssd_bytes += inst.cost.kv_bytes(
                arm.peer_ssd_blocks * BLOCK_TOKENS)

        # queue the prefill work (cache inserts happen at completion in the
        # simulator; here we update the pool optimistically so back-to-back
        # requests in a session see the blocks). For a tiered pool the
        # lookup PROMOTES the loaded SSD blocks into DRAM.
        inst.pool.lookup(req.hash_ids[:arm.prefix_blocks])
        inst.pool.insert(req.hash_ids[arm.prefix_blocks:],
                         start_pos=arm.prefix_blocks)
        inst.queue_free_at = max(inst.queue_free_at, load_done,
                                 now) + arm.compute_time
        inst.total_busy += arm.compute_time
        inst.n_scheduled += 1
        d.pending += 1
        d.pending_tokens += req.input_length + req.output_length
        d.n_scheduled += 1
        return Decision(True, prefill=inst, decode=d, expected_ttft=arm.ttft,
                        expected_tbt=tbt, prefix_blocks=arm.prefix_blocks,
                        migrated_blocks=arm.migrate_blocks,
                        transfer_from=arm.transfer_from.iid
                        if arm.transfer_from else None,
                        ssd_blocks=arm.ssd_blocks,
                        peer_ssd_blocks=arm.peer_ssd_blocks,
                        ssd_load_time=arm.ssd_load_time,
                        compute_time=arm.compute_time, arm_kind=arm.kind)
