"""Tracing utilities: the port's one way to trace, on ``torch.profiler``.

``trace`` captures a ``torch.profiler`` trace of host and card activity
(the CPU and, where a card is present, the CUDA activities) and writes it
into ``log_dir`` as a Chrome trace (``*.pt.trace.json``: ui.perfetto.dev,
chrome://tracing or TensorBoard's profile plugin).

``annotate`` names a region of the host's work on that timeline. While a
torch profiler records (``trace``, or any ``torch.profiler.profile``), a
region is a ``record_function``: a ``user_annotation`` event in the same
Chrome trace as the card's kernels and copies, on the profiler's clock, so
each of the card's idle gaps can be put down to the region the host had
open. Otherwise it is one shared null context: one read of the profiler's
Python flag, no allocation, no operator call. The training loop's regions
(``training/loop.py``) are named ``s2vt.feed.*``, ``s2vt.step`` and
``s2vt.step.*``, and ``s2vt.epoch.sync``.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler

# The context ``annotate`` hands out while no profiler records.
NULL_SPAN = contextlib.nullcontext()


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
    """A region named ``name`` on the profiler's timeline while a torch
    profiler records; else ``NULL_SPAN``. The flag is torch's own Python
    copy of the profiler's state, set and cleared as a profiler starts and
    stops, so reading it calls nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return NULL_SPAN
