"""Public request/response surface of the serving engines.

One request shape flows through the whole stack — ``ServingLoop.submit``,
``DecodeWorker.join`` and the launcher all speak ``ServingRequest`` and
report through ``RequestOutput``. (Own copy of the reference's
``repro/serving/request.py``.)

``priority`` is the §10 priority class (higher = more important): it buys
admission headroom under backpressure, orders pending joins, and — with
decode preemption enabled — lets a request spill a strictly
lower-priority victim's KV to the host tier instead of waiting behind
it. ``deadline`` is carried for schedulers/telemetry (seconds, same
clock as ``time.monotonic()``); the loop does not enforce it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ServingRequest:
    """One generation request, as submitted by a client.

    ``tokens`` may be ``None`` for a direct ``DecodeWorker.join`` (a
    joined slot doesn't need the prompt); anything submitted to a
    ``ServingLoop`` must carry real tokens — preemption recovery
    (recompute restore) replays them.
    """
    req_id: int
    tokens: Optional[np.ndarray]
    max_new: int
    session: Optional[object] = None
    priority: int = 0
    deadline: Optional[float] = None    # monotonic-clock seconds; advisory

    def __post_init__(self) -> None:
        if self.tokens is not None:
            self.tokens = np.asarray(self.tokens)
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")


@dataclass
class RequestOutput:
    """Per-request result stream + lifecycle telemetry.

    ``tokens``/``token_t`` grow as the engine emits (``token_t`` are
    ``time.monotonic()`` stamps); ``preemptions`` counts how many times
    the request was victim-spilled to the host KV tier; ``restores``
    names the restore arm used for each re-join (``"reload"`` — staged
    back from spilled bytes — or ``"recompute"`` — re-prefilled);
    ``completed_iter`` is the loop iteration the final token landed on
    (deterministic in ``iterate()``-driven mode, the benchmarks' clock).
    """
    req_id: int
    priority: int = 0
    tokens: list = field(default_factory=list)
    token_t: list = field(default_factory=list)
    done: bool = False
    preemptions: int = 0
    restores: list = field(default_factory=list)
    completed_iter: Optional[int] = None
