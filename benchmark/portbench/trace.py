"""The traced window: ``torch.profiler`` over the card, the harness's own
host spans, and what the per-layer readers take from them.

The trace records device activity alone (CUDA), not every host operator:
the window launches hundreds of thousands of kernels, and the host side
comes from the harness's spans around its calls into the program, in
:class:`Spans`. Host and device timestamps are put on one clock by a
marker kernel launched first in the window: its device start less the
host time of its launch.

``busy`` is the union of the kernels' intervals over the window (the
``kernel_busy`` of ``chip_smoke.py``, copied); the idle time between them
is attributed to the main thread's span that covered it.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

NON_KERNEL = ("Memcpy", "Memset")


class Spans:
    """Host spans (thread, name, start ns, end ns) on ``time.time_ns``."""

    def __init__(self):
        self.items: List[Tuple[str, str, int, int]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((threading.current_thread().name, name, t0, t1))

    def wrap(self, fn: Callable, name: str) -> Callable:
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def durations(self, name: str, t0: int = 0, t1: Optional[int] = None) -> List[float]:
        """Seconds of the spans ``name`` that started in [t0, t1]."""
        return [(b - a) / 1e9 for _, n, a, b in self.items
                if n == name and a >= t0 and (t1 is None or a <= t1)]


@dataclass
class Trace:
    """What one traced window left: device kernels [(name, start ns, end
    ns)] on the host clock, and the window's bounds."""

    start_ns: int
    end_ns: int
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[Tuple[int, int]] = []
        for a, b in sorted((max(a, self.start_ns), min(b, self.end_ns))
                           for _, a, b in self.kernels):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.kernels if match(n)) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, int] = defaultdict(int)
        for name, a, b in self.kernels:
            total[name] += b - a
        return [[k, v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, spans: Spans, thread: str = "MainThread", n: int = 10
                     ) -> List[list]:
        """The device's idle seconds in the window, by the ``thread`` span
        that covered them (the thread's spans do not nest); idle time
        under no span counts as ``outside spans``."""
        gaps, prev = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.end_ns > prev:
            gaps.append((prev, self.end_ns))
        own = sorted((a, b, name) for th, name, a, b in spans.items if th == thread)
        ends = [b for _, b, _ in own]
        idle: Dict[str, int] = defaultdict(int)
        for g0, g1 in gaps:
            covered = 0
            i = bisect.bisect_right(ends, g0)
            while i < len(own) and own[i][0] < g1:
                a, b, name = own[i]
                o = min(g1, b) - max(g0, a)
                if o > 0:
                    idle[name] += o
                    covered += o
                i += 1
            idle["outside spans"] += max(g1 - g0 - covered, 0)
        return [[k, v / 1e9] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:n]]


class Tracer:
    """Profiles the card between :meth:`start` and :meth:`stop`."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_start = self.t_marker = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_start = time.time_ns()
        marker = torch.empty(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self.t_marker = time.time_ns()
        marker.fill_(1.0)
        torch.cuda.synchronize(self.device)

    def stop(self) -> Trace:
        import torch
        torch.cuda.synchronize(self.device)
        t_end = time.time_ns()
        self.prof.stop()
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            raw.append((e.name(), int(start), int(start + dur)))
        self.prof = None
        raw.sort(key=lambda k: k[1])
        kernels = [k for k in raw if not k[0].startswith(NON_KERNEL)]
        # the marker is the first kernel: its device start against the host
        # time of its launch puts the device on the host clock
        offset = kernels[0][1] - self.t_marker if kernels else 0
        kernels = [(n, a - offset, b - offset) for n, a, b in kernels[1:]]
        return Trace(self.t_start, t_end, kernels)
