"""The program's own spans in a traced span: the regions the training loop
names on the profiler's timeline (``s2vt_tpu_torch/utils/profiling.py::
annotate``), read from the host events of the traced span's main thread.

The feed's spans are ``s2vt.feed.batch``, ``.send`` and ``.take``; a step's
are ``s2vt.step`` and ``s2vt.step.*`` (its parts, and the dropout
generator's ``s2vt.step.seed`` before it). A program that names no such
span reads None, as does a run off the card or without a traced span.
Recording slows the host, so these are the profiled host's times: read
them across commits.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

Intervals = List[Tuple[float, float]]


def is_feed(name: str) -> bool:
    return name.startswith("s2vt.feed.")


def is_step(name: str) -> bool:
    return name == "s2vt.step" or name.startswith("s2vt.step.")


def union(intervals, lo: float, hi: float) -> Intervals:
    """The union of ``intervals``, clipped to [lo, hi], in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_s(x: Intervals, y: Intervals) -> float:
    """Seconds in both of two ordered lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        total += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def _named(ctx: dict, loop: str, match: Callable[[str], bool]) -> Optional[Intervals]:
    """The union of the main thread's spans that ``match`` names, or None."""
    span = ctx["span"]
    if ctx["loop"] != loop or span is None or ctx["device_type"] != "cuda":
        return None
    hits = union(((a, b) for a, b, name in span.host if match(name)), span.lo, span.hi)
    return hits or None


def host_ms(ctx: dict, loop: str, match: Callable[[str], bool]) -> Optional[float]:
    """Host milliseconds a unit of work (a step) inside the spans ``match``
    names."""
    hits = _named(ctx, loop, match)
    if hits is None or not ctx["span_units"]:
        return None
    return 1e3 * sum(b - a for a, b in hits) / ctx["span_units"]


def idle_share(ctx: dict, loop: str, match: Callable[[str], bool]) -> Optional[float]:
    """The share (%) of the card's idle time in the traced span (the span
    less the union of its device intervals) that falls inside the spans
    ``match`` names."""
    hits = _named(ctx, loop, match)
    if hits is None:
        return None
    span = ctx["span"]
    edges = [span.lo] + [t for iv in span.busy_intervals() for t in iv] + [span.hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle_s = sum(b - a for a, b in idle)
    if idle_s <= 0:
        return None
    return 100.0 * overlap_s(idle, hits) / idle_s
