"""Built-in decode-placement policies.

``min_tbt`` is the paper's SelectDecodingInstance: among instances with
VRAM headroom, the one whose predicted TBT after joining is lowest.

``kv_pressure`` additionally penalises placement by per-node KVCache
occupancy — and, crucially, its occupancy term ALWAYS counts pending
(accepted-but-still-prefilling) commitments, independent of the
``accounting`` knob. The knob reproduces the §7.2 time-lag ablation in
the TBT *estimate*; occupancy is about future VRAM pressure, where a
committed request consumes bytes whether or not it has started decoding.
Under naive ("current") accounting min_tbt piles concurrent arrivals
onto the momentarily-emptiest node; kv_pressure's lag-free pressure term
spreads them, so fewer later arrivals bounce off the ``vram_ok`` gate in
KV-heavy regimes. The returned TBT stays the honest ``predicted_tbt``
(SLO checks see latency, not the shaped score), mirroring the
Arm.score / Arm.ttft split.

``session_affinity`` pins multi-turn sessions to the node that served
their previous turn (identified by the deepest previously-placed block of
the request's hash chain), with bounded degradation: stickiness yields to
min_tbt once the home node's predicted TBT drifts past 1.5× the best
node's. See the class docstring for the memory/purity contract.

``include_pending`` is the Conductor's ``accounting`` knob (§7.2): the
naive baseline pre-selects on the CURRENT decode state only — accepted
requests still prefilling are invisible (the time lag that causes wasted
prefill) — while pending-aware accounting counts in-flight commitments.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.core.policies.base import PolicyContext, register_policy


@register_policy("decode", "min_tbt")
class MinTBTDecode:
    def __init__(self, ctx: PolicyContext) -> None:
        self.ctx = ctx

    def select(self, req, instances, now, include_pending: bool = True):
        tokens = req.input_length + req.output_length
        ok = [d for d in instances if d.vram_ok(tokens, include_pending)]
        if not ok:
            return None, float("inf")
        d = min(ok, key=lambda d: d.predicted_tbt(
            1, tokens, include_pending=include_pending))
        return d, d.predicted_tbt(1, tokens, include_pending=include_pending)


@register_policy("decode", "kv_pressure")
class KVPressureDecode:
    """min_tbt shaped by per-node KV occupancy (see module docstring)."""

    alpha = 4.0     # quadratic penalty weight: mild until ~50% occupancy

    def __init__(self, ctx: PolicyContext) -> None:
        self.ctx = ctx

    def _occupancy(self, d, tokens: float) -> float:
        # pending commitments always count: bytes are promised to the node
        # regardless of the §7.2 accounting knob (see module docstring)
        held = d.kv_tokens + tokens + d.pending_tokens
        return held / max(d.cost.decode_capacity_tokens(), 1.0)

    def select(self, req, instances, now, include_pending: bool = True):
        tokens = req.input_length + req.output_length
        ok = [d for d in instances if d.vram_ok(tokens, include_pending)]
        if not ok:
            return None, float("inf")

        def score(d) -> float:
            tbt = d.predicted_tbt(1, tokens, include_pending=include_pending)
            occ = self._occupancy(d, tokens)
            return tbt * (1.0 + self.alpha * occ * occ) + 1e-9 * occ

        d = min(ok, key=score)
        return d, d.predicted_tbt(1, tokens, include_pending=include_pending)


@register_policy("decode", "session_affinity")
class SessionAffinityDecode:
    """Sticky decode placement for multi-turn sessions.

    A later turn of a chat/doc session extends the previous turn's hash
    chain, so the deepest previously-placed block on the chain identifies
    the node that last decoded this session. Returning there keeps the
    session's working set (decode-side KV, sampling state, any node-local
    caches a real deployment pins) on one machine instead of scattering a
    conversation across the pool.

    Stickiness is bounded: the home node is kept only while its predicted
    TBT stays within ``max_tbt_ratio`` of the best available node's (and
    it still has VRAM headroom) — a hot home degrades to plain min_tbt
    rather than dragging the session's SLO down with it.

    The placement map is policy-internal memory, recorded at selection
    time and bounded LRU (``max_tracked_blocks`` — idle sessions age out,
    so the map can't grow with total unique blocks seen over a long
    deployment); a post-selection SLO rejection can leave a mapping for a
    session that never joined, which at worst redirects its next turn
    through the bounded-degradation gate — never to an inadmissible node.
    The returned TBT stays the honest ``predicted_tbt`` of the pick (SLO
    checks see latency, not affinity), mirroring the Arm.score / Arm.ttft
    split.
    """

    max_tbt_ratio = 1.5        # sticky while home TBT <= ratio × best TBT
    max_tracked_blocks = 65536  # LRU bound on the placement map

    def __init__(self, ctx: PolicyContext) -> None:
        self.ctx = ctx
        # block key -> decode iid last chosen (LRU: recent sessions last)
        self._home: OrderedDict = OrderedDict()

    def select(self, req, instances, now, include_pending: bool = True):
        tokens = req.input_length + req.output_length
        ok = [d for d in instances if d.vram_ok(tokens, include_pending)]
        if not ok:
            return None, float("inf")

        def tbt(d) -> float:
            return d.predicted_tbt(1, tokens, include_pending=include_pending)

        best = min(ok, key=tbt)
        pick = best
        home_iid = next((self._home[h] for h in reversed(req.hash_ids)
                         if h in self._home), None)
        if home_iid is not None:
            home = next((d for d in ok if d.iid == home_iid), None)
            if home is not None and tbt(home) <= self.max_tbt_ratio * tbt(best):
                pick = home
        for h in req.hash_ids:
            self._home[h] = pick.iid
            self._home.move_to_end(h)
        while len(self._home) > self.max_tracked_blocks:
            self._home.popitem(last=False)
        return pick, tbt(pick)
