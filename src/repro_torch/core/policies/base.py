"""Pluggable scheduling-policy API: candidate Arms and one string-keyed
policy registry (the port's own copy of the reference's
``core/policies/base.py``).

  * ``Arm`` — one candidate way to serve a request's prefill: a predicted
    TTFT, the block counts behind it (prefix / migrate / SSD), and a
    ``commit(now)`` closure that performs the arm's messenger/pool side
    effects exactly once, when the Conductor picks it. ``propose`` is pure;
    only ``commit`` mutates.
  * ``PrefillPolicy`` — ``propose(req, instances, now) -> list[Arm]``. The
    Conductor takes the min-TTFT arm (first wins on ties), so a policy is
    just "which arms exist" — strategies compose by proposing more arms.
  * ``DecodePolicy`` — ``select(req, instances, now) -> (instance, tbt)``.
  * ``AdmissionPolicy`` (``policies.admission``) — the serving loop's §7
    backpressure; the simulator's Conductor wrapper is not ported yet.

All kinds share one registry: ``@register_policy(kind, name)`` at class
level, ``get_policy(kind, name)`` to resolve (raising a ``ValueError``
that lists what IS registered), ``list_policies(kind)`` to enumerate.
Built-in policies live in sibling modules and load lazily on first
lookup; user policies register by decorating a class anywhere before the
Conductor is built.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional, Protocol

if TYPE_CHECKING:  # import cycles: conductor imports this module
    from repro_torch.core.conductor import DecodeInstance, PrefillInstance
    from repro_torch.core.messenger import Messenger
    from repro_torch.core.trace import Request


@dataclass
class Arm:
    """One candidate (instance, data-placement) pair for a request's prefill.

    ``ttft`` is the predicted time to first token and is what SLO checks
    see; ``score`` (defaults to ``ttft``) is what the Conductor minimises —
    policies that shape routing beyond raw latency (e.g. load-aware
    imbalance penalties) bias ``score`` while keeping ``ttft`` honest.

    ``compute_time`` is the prefill busy-time the arm charges to the
    instance's queue; for plain arms it equals ``prefill_time(L, prefix)``
    but overlapped arms (head recompute + tail load) charge more compute
    while finishing earlier.

    ``commit(now)`` performs the arm's messenger/pool side effects
    (peer-transfer enqueue, SSD-channel enqueue, block replication) and
    returns the time the arm's data lands — the Conductor starts compute at
    ``max(queue drained, data landed)``. ``None`` means nothing to do.
    Committing may fill ``ssd_load_time`` (the committed channel time).
    """
    kind: str                       # "recompute" | "peer_fetch" | "ssd_load" | "overlap" | "peer_ssd"
    instance: "PrefillInstance"
    ttft: float
    compute_time: float
    prefix_blocks: int = 0          # blocks reused (local, migrated or loaded)
    migrate_blocks: int = 0         # hot-spot replication volume
    transfer_from: Optional["PrefillInstance"] = None
    ssd_blocks: int = 0             # prefix blocks loaded from local SSD
    peer_ssd_blocks: int = 0        # prefix blocks fetched off a PEER's SSD
    ssd_load_time: float = 0.0      # filled by commit for SSD-loading arms
    score: Optional[float] = None   # selection key; None -> ttft
    commit: Optional[Callable[[float], float]] = None

    @property
    def sort_key(self) -> float:
        return self.ttft if self.score is None else self.score

    def land(self, now: float) -> float:
        """Run the commit closure; returns when the arm's data is ready."""
        return now if self.commit is None else self.commit(now)


@dataclass
class PolicyContext:
    """Everything a policy may consult besides the instances themselves.

    ``directory`` is the cluster's ``GlobalBlockDirectory`` when the
    shared KVCache pool is enabled (None otherwise); routing policies use
    it to propose the peer-SSD fetch arm. Reads only — commits go through
    the messenger/pools like every other arm side effect.
    """
    messenger: "Messenger"
    balancing_threshold: float = 1.3
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    directory: Optional[object] = None   # GlobalBlockDirectory | None


class PrefillPolicy(Protocol):
    """Routing strategy: propose candidate arms for a request's prefill."""
    kind: str
    name: str

    def __init__(self, ctx: PolicyContext) -> None: ...

    def propose(self, req: "Request", instances: list["PrefillInstance"],
                now: float) -> list[Arm]: ...


class DecodePolicy(Protocol):
    """Decode placement: pick the instance a request will decode on."""
    kind: str
    name: str

    def __init__(self, ctx: PolicyContext) -> None: ...

    def select(self, req: "Request", instances: list["DecodeInstance"],
               now: float, include_pending: bool = True): ...


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

POLICY_KINDS = ("prefill", "decode", "admission")

_REGISTRY: dict[tuple[str, str], type] = {}


def register_policy(kind: str, name: str):
    """Class decorator: register under ``(kind, name)`` and stamp the class
    with ``kind``/``name`` attributes."""
    if kind not in POLICY_KINDS:
        raise ValueError(f"unknown policy kind {kind!r}; "
                         f"kinds: {list(POLICY_KINDS)}")

    def deco(cls):
        cls.kind = kind
        cls.name = name
        _REGISTRY[(kind, name)] = cls
        return cls
    return deco


_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True  # before the imports: admission re-enters here
    import importlib
    for mod in ("routing", "load_aware", "why_not_both", "decode",
                "admission"):
        importlib.import_module(f"repro_torch.core.policies.{mod}")


def get_policy(kind: str, name: str) -> type:
    """Resolve a registered policy class; unknown names raise a
    ``ValueError`` listing what is registered for that kind."""
    _ensure_builtins()
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        known = sorted(n for k, n in _REGISTRY if k == kind)
        raise ValueError(
            f"unknown {kind} policy {name!r}; registered: {known}") from None


def list_policies(kind: Optional[str] = None) -> list:
    """Registered names for ``kind``, or all ``(kind, name)`` pairs."""
    _ensure_builtins()
    if kind is None:
        return sorted(_REGISTRY)
    return sorted(n for k, n in _REGISTRY if k == kind)
