"""Reading a traced span from ``torch.profiler``'s Chrome trace.

A span is the ``SPAN`` annotation, which closes after a synchronise: the
device's activity and the host's events inside it. Device time is the
union of the intervals in which a kernel, copy or fill ran, not their sum.
Idle gaps are named by the innermost event of the host's main thread (the
one that opened the annotation) open at each gap's midpoint. Recording
slows the host, and so lengthens the span; the times of device operations
are the card's own.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

SPAN = "bench.traced_span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


class Span:
    """The device and host events of one traced span, times in seconds."""

    def __init__(self, events: Sequence[dict]):
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in events if e.get("name") == SPAN]
        if not spans:
            raise ValueError(f"the trace holds no {SPAN!r} annotation")
        s = spans[0]
        self.lo, self.hi = s["ts"] * 1e-6, (s["ts"] + s["dur"]) * 1e-6
        inside = [e for e in events if self.lo <= e["ts"] * 1e-6 <= self.hi]
        self.device = sorted(((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"], e["cat"])
                              for e in inside if e.get("cat") in DEVICE_CATS))
        self.host = sorted(((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                            for e in inside if e.get("cat") in HOST_CATS
                            and e.get("tid") == s.get("tid") and e["name"] != SPAN),
                           key=lambda h: (h[0], -h[1]))

    @classmethod
    def from_file(cls, path: str) -> "Span":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the span."""
        out: List[List[float]] = []
        for a, b, _, _ in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    @property
    def kernel_count(self) -> int:
        return sum(1 for e in self.device if e[3] == "kernel")

    def kernel_stats(self, symbols: Sequence[str]) -> Tuple[int, float]:
        """(records, summed seconds) of the kernels whose name holds one of
        ``symbols``."""
        hits = [b - a for a, b, name, cat in self.device
                if cat == "kernel" and any(s in name for s in symbols)]
        return len(hits), sum(hits)

    def top_device_ops(self, n: int = 10) -> List[list]:
        """[name, seconds] of the ``n`` device operations that took most time,
        summed by name."""
        by: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[host event, seconds] of the device's idle time inside the span,
        summed by the innermost host event open at each gap's midpoint, the
        ``n`` largest."""
        edges = [self.lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.hi)
        gaps = sorted(((a + b) / 2, b - a) for a, b in zip(edges[0::2], edges[1::2]) if b > a)
        by: Dict[str, float] = defaultdict(float)
        stack: List[tuple] = []     # the open host events, innermost last
        j = 0
        for t, length in gaps:
            while j < len(self.host) and self.host[j][0] <= t:
                while stack and stack[-1][1] < self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            by[stack[-1][2] if stack else "(no host event)"] += length
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def traced(work, path: str, device) -> Span:
    """Run ``work()`` under ``torch.profiler`` inside the ``SPAN``
    annotation, which closes after a synchronise, write the Chrome trace to
    ``path`` and read it back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            work()
            if cuda:
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    return Span.from_file(path)
