"""The traced run's device side: ``torch.profiler`` over a slice of the
window, opened and closed by the engine thread between loop iterations
so that the slice holds whole iterations, and its events read back.

The profiler records CUDA activity only (kernels, copies, sets). A
marker kernel launched on an idle card just after the profiler opens
ties the trace's clock to the host's, so device idle gaps can be
labelled with the harness span that was open on the host at the time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

MARKER_CYCLES = 2000


@dataclass
class DeviceOp:
    name: str
    t0: float        # host monotonic seconds
    t1: float


@dataclass
class Trace:
    """Device operations of the slice [t0, t1) (host monotonic)."""
    t0: float = 0.0
    t1: float = 0.0
    ops: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds in which at least one operation ran on the device."""
        busy = 0.0
        cur = None
        for op in sorted(self.ops, key=lambda o: o.t0):
            a, b = max(op.t0, self.t0), min(op.t1, self.t1)
            if b <= a:
                continue
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy

    def gaps(self) -> list:
        """(start, end) of every interval with nothing on the device."""
        out, end = [], self.t0
        for op in sorted(self.ops, key=lambda o: o.t0):
            if op.t0 > end:
                out.append((end, min(op.t0, self.t1)))
            end = max(end, op.t1)
        if end < self.t1:
            out.append((end, self.t1))
        return [g for g in out if g[1] > g[0]]

    def time_of(self, pred) -> tuple[float, int]:
        """Device seconds and count of the operations whose name passes."""
        sel = [o for o in self.ops if pred(o.name)]
        return sum(o.t1 - o.t0 for o in sel), len(sel)


class Tracer:
    """Owned by the engine thread: ``tick()`` before each iteration opens
    the profiler once the host clock passes ``start`` and closes it once
    it passes ``stop``."""

    def __init__(self, start: float, stop: float, device) -> None:
        self.start, self.stop_at = start, stop
        self.device = device
        self.prof = None
        self.trace: Optional[Trace] = None
        self._marker_host_ns = 0
        self.done = False

    @staticmethod
    def warm(device) -> None:
        """Open and close the profiler once, so that opening it inside the
        window does not pay CUPTI's first start."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize(device)

    def tick(self, now: float) -> None:
        if self.done:
            return
        if self.prof is None and now >= self.start:
            self._open()
        elif self.prof is not None and now >= self.stop_at:
            self.close()

    def _open(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self._marker_host_ns = time.monotonic_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize(self.device)
        self.trace = Trace(t0=time.monotonic())

    def close(self) -> None:
        """Close the slice (idempotent); the events are read by
        ``collect``."""
        if self.prof is None or self.done:
            return
        import torch
        torch.cuda.synchronize(self.device)
        self.trace.t1 = time.monotonic()
        self.prof.stop()
        self.done = True

    def collect(self) -> Optional[Trace]:
        """The slice's device operations on the host clock, the marker
        left out; None when no slice was taken."""
        if self.trace is None:
            return None
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        # the marker: the spin kernel, else the first operation (the card
        # was idle when it was launched)
        marker = next((e for e in events if "spin" in e[0]),
                      events[0] if events else None)
        offset_ns = (self._marker_host_ns - marker[1]) if marker else 0
        ops = [DeviceOp(name, (s + offset_ns) / 1e9, (e + offset_ns) / 1e9)
               for name, s, e in events if (name, s, e) != marker]
        self.trace.ops = [o for o in ops if o.t1 > self.trace.t0
                          and o.t0 < self.trace.t1]
        self.prof = None
        return self.trace


def _device_events(prof) -> list:
    """(name, start ns, end ns) of every CUDA-side event: kineto's own
    records where this PyTorch exposes them, else the profiler's
    function events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    kr = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kr is not None:
        for e in kr.events():
            if e.device_type() != cuda:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), int(s), int(s + d)))
        return out
    for e in prof.events():
        if e.device_type == cuda:
            s = int(e.time_range.start * 1000)
            out.append((e.name, s, int(e.time_range.end * 1000)))
    return out
