"""The serving stack's span recorder: one a process, off by default.

``span(name, req_id=None)`` is a context manager around one phase of the
work. While the recorder is off it returns one shared no-op object: no
clock read, no span kept. While it is on, a span keeps its name, its
start and end on ``time.monotonic_ns()`` (the clock of
``RequestOutput.token_t``), the span it opened inside (a thread-local
stack, so each thread nests on its own), its thread, the request it
serves (given, or else the enclosing span's) and, for a copy, the bytes
it moved (``moved(n)`` before the end). ``add(name, t0_ns, t1_ns)``
keeps a span whose clock pair the caller already read for its own
timing, and adopts as children the spans this thread closed inside that
interval.

Spans are kept in memory as plain tuples of numbers and strings, which
the garbage collector stops tracking, at most ``CAPACITY``; ``dropped``
counts those refused once it was full. ``take()`` hands them over as
``Span``s and clears them. No span waits for the device: every wait a
span shows is one the program makes anyway.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

CAPACITY = 1 << 20

_on = False
_kept: list = []        # tuples in Span's field order
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
dropped = 0


class Span(NamedTuple):
    sid: int
    name: str
    t0: int                     # time.monotonic_ns()
    t1: int
    parent: Optional[int]       # the enclosing span's sid
    thread: int                 # threading.get_ident()
    req_id: Optional[int] = None
    nbytes: Optional[int] = None


class _Off:
    """The span handed out while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def moved(self, nbytes: int) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _keep(rec: tuple) -> None:
    global dropped
    with _lock:
        if len(_kept) < CAPACITY:
            _kept.append(rec)
        else:
            dropped += 1


class _Open:
    __slots__ = ("sid", "name", "parent", "req_id", "nbytes", "t0", "stack")

    def __init__(self, name: str, req_id: Optional[int]) -> None:
        st = _stack()
        top = st[-1] if st else None
        if req_id is None and top is not None:
            req_id = top.req_id
        self.sid = next(_ids)
        self.name = name
        self.parent = None if top is None else top.sid
        self.req_id = req_id
        self.nbytes = None
        self.stack = st

    def __enter__(self):
        self.stack.append(self)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        self.stack.pop()
        _keep((self.sid, self.name, self.t0, t1, self.parent,
               threading.get_ident(), self.req_id, self.nbytes))
        return False

    def moved(self, nbytes: int) -> None:
        """The bytes this span copied."""
        self.nbytes = nbytes


def span(name: str, req_id: Optional[int] = None):
    """A context manager timing one phase; ``moved(n)`` on what it
    returns records the bytes it copied."""
    if not _on:
        return _OFF
    return _Open(name, req_id)


def add(name: str, t0_ns: int, t1_ns: int,
        req_id: Optional[int] = None) -> None:
    """Keep a span the caller timed itself (``time.monotonic_ns()``).
    Spans this thread closed inside [t0_ns, t1_ns] at the same depth
    become its children."""
    if not _on:
        return
    st = _stack()
    top = st[-1] if st else None
    if req_id is None and top is not None:
        req_id = top.req_id
    outer = None if top is None else top.sid
    me = threading.get_ident()
    sid = next(_ids)
    with _lock:
        for i in range(len(_kept) - 1, -1, -1):
            s = _kept[i]
            if s[5] != me:
                continue
            if s[2] < t0_ns:
                break
            if s[4] == outer and s[3] <= t1_ns:
                _kept[i] = s[:4] + (sid,) + s[5:]
    _keep((sid, name, t0_ns, t1_ns, outer, me, req_id, None))


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> list:
    """The spans kept so far, oldest end first; the recorder keeps none
    after this call."""
    global _kept
    with _lock:
        out, _kept = _kept, []
    return [Span._make(s) for s in out]
