"""Engine-side §7 admission: the ``baseline``/``early``/``predictive``
policies as the serving loop evaluates them against a live
``BackpressureSignal`` (own copy of the engine half of the reference's
``core/policies/admission.py``; the simulator half, which wraps a
Conductor, is not ported yet).

  * ``baseline``   — stage-local: only the intake queue in front of
    prefill (blind to decode saturation, §7.2).
  * ``early``      — both pools' CURRENT state, blind to accepted
    requests still mid-prefill (the §7.3 stale view).
  * ``predictive`` — counts in-flight prefills and spilled preemption
    victims too: the §7.4 information lag closed by measurement.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.policies.base import register_policy


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
    """A request of priority p is admitted while the policy's engine load
    stays under ``base_limit + default_relief·p``."""
    name = "base"
    kind = "admission"
    base_limit = 0.85
    default_relief = 0.25

    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        raise NotImplementedError

    @classmethod
    def engine_admit(cls, sig: BackpressureSignal, priority: int = 0) -> bool:
        limit = cls.base_limit + cls.default_relief * max(priority, 0)
        return cls.engine_load(sig) <= limit


@register_policy("admission", "baseline")
class BaselineAdmission(AdmissionPolicy):
    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        return sig.queue_frac


@register_policy("admission", "early")
class EarlyRejection(AdmissionPolicy):
    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        return max(sig.committed_frac(include_prefills=False), sig.page_frac)


@register_policy("admission", "predictive")
class PredictiveEarlyRejection(AdmissionPolicy):
    @classmethod
    def engine_load(cls, sig: BackpressureSignal) -> float:
        return max(sig.committed_frac(include_prefills=True,
                                      include_spilled=True), sig.page_frac)
