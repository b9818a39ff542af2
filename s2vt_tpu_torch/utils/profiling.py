"""Tracing and profiling utilities.

Counterpart of ``s2vt_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace of host and card activity (the CPU and, where a
card is present, the CUDA activities) and writes it into ``log_dir`` as a
Chrome trace (``*.pt.trace.json``: ui.perfetto.dev, chrome://tracing or
TensorBoard's profile plugin); ``annotate`` names a region on that timeline;
``ThroughputMeter`` counts clips/s (and clips/s per card); ``Timer`` is a
scoped wall-clock timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "./runs/profile"):
    """Profile the enclosed code; on exit write its Chrome trace into
    ``log_dir``. Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """clips/sec (and clips/sec/card) over a sliding window."""

    def __init__(self, n_chips: Optional[int] = None):
        self.n_chips = n_chips if n_chips is not None else (torch.cuda.device_count() or 1)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._clips = 0

    def update(self, clips: int) -> None:
        self._clips += clips

    @property
    def clips_per_sec(self) -> float:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._clips / dt

    @property
    def clips_per_sec_per_chip(self) -> float:
        return self.clips_per_sec / max(self.n_chips, 1)

    def summary(self) -> Dict[str, float]:
        cps = self.clips_per_sec  # one snapshot; per-card derives from it
        return {"clips_per_sec": cps,
                "clips_per_sec_per_chip": cps / max(self.n_chips, 1),
                "clips": float(self._clips)}


class Timer:
    """Scoped wall-clock timer: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
