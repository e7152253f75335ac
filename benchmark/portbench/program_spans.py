"""The program's own spans (``brats21_tpu_torch/utils/profiling.py``) in a
traced window, and the card's idle time put down to them.

The program records its spans while a ``torch.profiler`` runs in its
process, as it does in a traced window, on ``time.time_ns``: the clock
onto which :class:`trace.Tracer` puts the kernels. Each idle gap of the
card goes to the innermost span that the main thread (the one thread that
launches work on the card) had open during it; idle time under no program
span is ``outside program spans``. A program without the recorder, or one
that recorded nothing, gives None throughout.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

#: the thread that launches the program's work on the card
MAIN = "MainThread"
OUTSIDE = "outside program spans"

Piece = Tuple[int, int, str]


def window_spans(ctx) -> Optional[list]:
    """The program's spans that started in the window (``ctx.run.t0_ns``
    on), or None where the program records none."""
    try:
        from brats21_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return read(ctx.run.t0_ns) or None


def named(spans: Sequence, prefix: str) -> list:
    """The spans whose name is ``prefix`` or starts with it."""
    return [s for s in spans if s.name == prefix or s.name.startswith(prefix)]


def cases(spans: Sequence) -> int:
    """The cases the main thread enqueued in the window (its ``eval.case``
    spans)."""
    return sum(s.name == "eval.case" for s in spans)


def innermost(spans: Sequence) -> List[Piece]:
    """One thread's time as (start ns, end ns, name) pieces of the
    innermost span open then, in order. A thread's spans nest; a child
    that ends after its parent (clock ties) is cut at the parent's end."""
    pieces: List[Piece] = []
    stack: List[Tuple[int, str]] = []         # (end ns, name), innermost last
    cursor = 0

    def emit(a: int, b: int, name: str) -> None:
        if b > a:
            pieces.append((a, b, name))

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            end, name = stack.pop()
            emit(cursor, end, name)
            cursor = end
        if stack:
            emit(cursor, s.start_ns, stack[-1][1])
        cursor = s.start_ns
        stack.append((min(s.end_ns, stack[-1][0]) if stack else s.end_ns, s.name))
    while stack:
        end, name = stack.pop()
        emit(cursor, end, name)
        cursor = end
    return pieces


def idle_gaps(trace) -> List[Tuple[int, int]]:
    """The window's intervals in which no kernel ran on the card."""
    gaps, prev = [], trace.start_ns
    for a, b in trace.busy_intervals():
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if trace.end_ns > prev:
        gaps.append((prev, trace.end_ns))
    return gaps


def idle_pieces(trace, spans: Sequence, thread: str = MAIN) -> List[Piece]:
    """The card's idle time as (start ns, end ns, name) pieces, each named
    by the innermost ``thread`` span over it, or :data:`OUTSIDE`; together
    they cover every idle nanosecond of the window once."""
    own = innermost([s for s in spans if s.thread == thread])
    ends = [b for _, b, _ in own]
    out: List[Piece] = []
    for g0, g1 in idle_gaps(trace):
        cursor = g0
        i = bisect.bisect_right(ends, g0)
        while i < len(own) and own[i][0] < g1:
            a, b, name = own[i]
            a, b = max(a, g0), min(b, g1)
            if b > a:
                if a > cursor:
                    out.append((cursor, a, OUTSIDE))
                out.append((a, b, name))
                cursor = b
            i += 1
        if g1 > cursor:
            out.append((cursor, g1, OUTSIDE))
    return out


def idle_by_name(pieces: Sequence[Piece]) -> Dict[str, float]:
    """Idle seconds by span name, largest first."""
    total: Dict[str, int] = defaultdict(int)
    for a, b, name in pieces:
        total[name] += b - a
    return {k: v / 1e9 for k, v in sorted(total.items(), key=lambda kv: -kv[1])}


def overlap_s(pieces: Sequence[Piece], intervals: Sequence[Tuple[int, int]]
              ) -> Tuple[float, float]:
    """(seconds of ``pieces`` inside ``intervals`` under a program span,
    seconds of them outside every program span); ``pieces`` in order, the
    intervals disjoint."""
    intervals = sorted(intervals)
    covered = outside = 0
    j = 0
    for a, b, name in pieces:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            o = min(b, intervals[k][1]) - max(a, intervals[k][0])
            if name == OUTSIDE:
                outside += o
            else:
                covered += o
            k += 1
    return covered / 1e9, outside / 1e9
