"""Overload-oriented admission policies (§7) on the policy registry — the
port's own copy of the reference's ``core/policies/admission.py``, both
halves: the Conductor wrapper the simulator drives, and the engine-side
classmethods the serving loop evaluates against a live
``BackpressureSignal``.

Load definition (§7.1): with disaggregated pools, load is SLO satisfaction
directly — l_prefill = predicted max TTFT / TTFT_SLO over the prefill pool,
l_decode = predicted TBT / TBT_SLO over the decode pool.

Three policies (Table 3):

  * ``baseline``   — each stage checks its own load when the request
    REACHES it: prefill load at arrival, decode load after prefill
    completes. A decode-side rejection wastes the finished prefill (§7.2).
  * ``early``      — at arrival, reject if max(prefill, decode load)
    exceeds 1. No prefill waste, but scheduling on the *current* decode
    load lags reality by one prefill duration → anti-phase fluctuation
    (§7.3, Figure 9/10a).
  * ``predictive`` — §7.4 system-level prediction: estimate the decode
    load at t_now + TTFT by (i) adding every accepted request whose
    prefill finishes before then, (ii) retiring requests whose decode will
    have exceeded the uniform decode time t_d. Accept against the
    PREDICTED load.

Each policy declares how the Conductor's decode pre-selection accounts for
in-flight work through the class-level ``accounting`` knob ("current" =
visible decode state only, the §7.2 time lag; "pending" = count
accepted-but-still-prefilling commitments), applied to
``Conductor.accounting`` at construction. ``decode_double_check`` marks
policies whose decode-side check happens AFTER prefill (the simulator
re-validates at join time and may waste the finished prefill).

Engine side, the same three names: ``baseline`` sees only the intake
queue in front of prefill; ``early`` both pools' current state, blind to
accepted requests still mid-prefill; ``predictive`` counts in-flight
prefills and spilled preemption victims too — the §7.4 information lag
closed by measurement.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.policies.base import get_policy, register_policy
from repro_torch.core.trace import Request


@dataclass
class _InFlight:
    """Accepted request whose prefill will finish at ``prefill_done``."""
    prefill_done: float
    tokens: float
    decode_iid: int


@dataclass
class BackpressureSignal:
    """Engine-side load snapshot the serving loop hands to admission:
    the arrival queue, the decode slot table, the device page pool, the
    prefills accepted but not yet joined, and the spilled victims."""
    queue_depth: int
    queue_capacity: int
    slots_used: int
    slots_total: int
    prefills_active: int = 0
    pages_pinned: int = 0
    pages_total: int = 0
    spilled: int = 0

    @property
    def queue_frac(self) -> float:
        return self.queue_depth / self.queue_capacity \
            if self.queue_capacity else 0.0

    @property
    def slot_frac(self) -> float:
        return self.slots_used / self.slots_total if self.slots_total else 0.0

    @property
    def page_frac(self) -> float:
        return self.pages_pinned / self.pages_total if self.pages_total \
            else 0.0

    def committed_frac(self, include_prefills: bool,
                       include_spilled: bool = False) -> float:
        cap = self.queue_capacity + self.slots_total
        if not cap:
            return 0.0
        n = self.queue_depth + self.slots_used
        if include_prefills:
            n += self.prefills_active
        if include_spilled:
            n += self.spilled
        return n / cap


class AdmissionPolicy:
    """Wraps a Conductor with overload admission. Subclasses decide.

    Priority-aware (§10): a request of priority p is admitted while the
    load stays under base_limit + priority_relief·p — higher-priority
    traffic keeps flowing into the overload region that sheds best-effort
    requests.
    """
    name = "base"
    kind = "admission"
    #: how the Conductor's decode pre-selection counts in-flight work
    accounting = "pending"
    #: True -> the decode-side SLO check runs AFTER prefill (§7.2 waste)
    decode_double_check = False

    def __init__(self, conductor, priority_relief: float = 0.25) -> None:
        self.c = conductor
        self.priority_relief = priority_relief
        self.in_flight: list[_InFlight] = []
        conductor.accounting = self.accounting

    # best-effort traffic sheds at base_limit; each priority level buys
    # priority_relief more load headroom (hard SLO checks stay universal)
    base_limit = 0.85
    default_relief = 0.25           # priority_relief when no instance exists

    def load_limit(self, req: Request) -> float:
        return self.base_limit + self.priority_relief * max(req.priority, 0)

    # ---- load measurements (§7.1) ----
    def prefill_load(self, now: float) -> float:
        """max over instances of (queue + typical prefill) / TTFT_SLO."""
        loads = [p.queue_time(now) / self.c.ttft_slo for p in self.c.P]
        return max(loads) if loads else 0.0

    def decode_load(self, now: float) -> float:
        """CURRENT decode load — §7.1. Deliberately blind to accepted
        requests still in prefill: that information lag between the pools
        is what causes the §7.3 fluctuation."""
        loads = [d.predicted_tbt(include_pending=False) / self.c.tbt_slo
                 for d in self.c.D]
        return max(loads) if loads else 0.0

    def admit(self, req: Request, now: float) -> bool:
        raise NotImplementedError

    # ---- engine-side backpressure (serving loop) ----
    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        """Load the policy sees from a live-engine snapshot."""
        raise NotImplementedError

    @classmethod
    def engine_admit(cls, sig: BackpressureSignal, priority: int = 0) -> bool:
        limit = cls.base_limit + cls.default_relief * max(priority, 0)
        return cls.engine_load(sig) <= limit

    def schedule(self, req: Request, now: float):
        from repro_torch.core.conductor import Decision
        if not self.admit(req, now):
            return Decision(False, reject_reason=f"{self.name} admission")
        dec = self.c.schedule(req, now)
        if dec.accepted:
            self.in_flight.append(_InFlight(
                prefill_done=now + dec.expected_ttft,
                tokens=req.input_length + req.output_length,
                decode_iid=dec.decode.iid))
        return dec

    def on_decode_join(self, decode_iid: int, now: float) -> None:
        self.in_flight = [f for f in self.in_flight
                          if f.prefill_done > now or f.decode_iid != decode_iid]


@register_policy("admission", "baseline")
class BaselineAdmission(AdmissionPolicy):
    """Stage-local checks only; the decode check happens in the simulator
    AFTER prefill (double-check of §3 step 4) and may waste prefill work.
    The Conductor's decode pre-selection sees only the CURRENT decode state
    (``accounting = "current"``) — the §7.2 time lag."""
    accounting = "current"
    decode_double_check = True

    def admit(self, req: Request, now: float) -> bool:
        return self.prefill_load(now) <= self.load_limit(req)

    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        return sig.queue_frac


@register_policy("admission", "early")
class EarlyRejection(AdmissionPolicy):
    """§7.2: gate on the max of both pools' CURRENT loads at arrival.
    The decode view is stale by one prefill duration (the Conductor's
    decode pre-selection shares the stale view), producing the anti-phase
    load fluctuation of Figure 9/10a."""
    accounting = "current"

    def admit(self, req: Request, now: float) -> bool:
        return max(self.prefill_load(now),
                   self.decode_load(now)) <= self.load_limit(req)

    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        return max(sig.committed_frac(include_prefills=False), sig.page_frac)


@register_policy("admission", "predictive")
class PredictiveEarlyRejection(AdmissionPolicy):
    """§7.4 system-level prediction with uniform decode time t_d."""

    def __init__(self, conductor, t_d: float = 10.0,
                 priority_relief: float = 0.25) -> None:
        super().__init__(conductor, priority_relief)
        self.t_d = t_d

    def predicted_decode_load(self, now: float, horizon: float) -> float:
        """Average TBT ratio over decode instances at ``now + horizon``."""
        t = now + horizon
        per_inst: dict[int, tuple[int, float]] = {}
        for d in self.c.D:
            # requests currently decoding, minus those done within horizon:
            # approximate retirement as a uniform drain over t_d
            frac_left = max(1.0 - horizon / self.t_d, 0.0)
            b = d.active * frac_left
            toks = d.kv_tokens * frac_left
            per_inst[d.iid] = (b, toks)
        # add accepted requests whose prefill completes before t
        for f in self.in_flight:
            if f.prefill_done <= t:
                b, toks = per_inst[f.decode_iid]
                per_inst[f.decode_iid] = (b + 1, toks + f.tokens)
        ratios = []
        for d in self.c.D:
            b, toks = per_inst[d.iid]
            if b < 1:
                ratios.append(0.0)
                continue
            tbt = d.cost.decode_iter_time(max(int(b), 1), toks / b)
            ratios.append(tbt / self.c.tbt_slo)
        return sum(ratios) / len(ratios) if ratios else 0.0

    def admit(self, req: Request, now: float) -> bool:
        limit = self.load_limit(req)
        if self.prefill_load(now) > limit:
            return False
        # horizon = the TTFT this request would see (approx: best queue)
        horizon = min(p.queue_time(now) for p in self.c.P) \
            + self.c.P[0].cost.prefill_time(req.input_length, 0)
        return self.predicted_decode_load(now, horizon) <= limit

    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        return max(sig.committed_frac(include_prefills=True,
                                      include_spilled=True), sig.page_frac)


def make_admission(name: str, conductor, **kw) -> AdmissionPolicy:
    """Build a registered admission policy around a Conductor."""
    return get_policy("admission", name)(conductor, **kw)
