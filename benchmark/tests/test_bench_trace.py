"""The trace reader on a hand-made Chrome trace: device time as the union of
intervals, idle gaps named by the host's innermost open event, kernel
records by symbol."""

import json

import pytest

from benchmark import harness
from benchmark.trace import SPAN, Span, traced


def _events():
    X = lambda cat, name, ts, dur, tid=1: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                            "dur": dur, "tid": tid}
    return [X("user_annotation", SPAN, 0, 100),
            X("user_annotation", "bench.step", 0, 60),
            X("cpu_op", "aten::mm", 5, 10),
            X("cpu_op", "Optimizer.step", 70, 20),
            X("cpu_op", "other_thread_op", 40, 50, tid=2),
            X("kernel", "k_a", 10, 20, tid=7),
            X("kernel", "k_a", 20, 20, tid=8),       # overlaps the first on another stream
            X("gpu_memcpy", "Memcpy HtoD", 50, 5, tid=7),
            X("kernel", "k_b_mma", 90, 30, tid=7),   # runs past the span's end
            X("kernel", "k_out", 150, 10, tid=7)]    # outside the span


def test_busy_is_a_union():
    span = Span(_events())
    assert span.window_s == pytest.approx(100e-6)
    flat = [t for iv in span.busy_intervals() for t in iv]
    assert flat == pytest.approx([10e-6, 40e-6, 50e-6, 55e-6, 90e-6, 100e-6])
    assert span.busy_s == pytest.approx(45e-6)
    assert span.kernel_count == 3


def test_kernel_stats_by_symbol():
    span = Span(_events())
    assert span.kernel_stats(["k_a"]) == (2, pytest.approx(40e-6))
    assert span.kernel_stats(["k_b"]) == (1, pytest.approx(30e-6))
    assert span.kernel_stats(["k_out"]) == (0, 0)


def test_idle_gaps_named_by_the_main_thread():
    gaps = dict(Span(_events()).idle_gaps())
    # [0, 10): aten::mm is open at 5; [40, 50) and [55, 90): bench.step at 45,
    # Optimizer.step at 72.5; the other thread's op never names a gap
    assert gaps == pytest.approx({"aten::mm": 10e-6, "bench.step": 10e-6,
                                  "Optimizer.step": 35e-6})


def test_traced_on_the_cpu(tmp_path):
    import torch
    span = traced(lambda: torch.ones(4) @ torch.ones(4), str(tmp_path / "t.json"), "cpu")
    assert span.window_s > 0 and span.busy_s == 0
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


def test_device_idle_against_the_untraced_window():
    # 45 us busy over 3 traced steps against an untraced window of 10 steps
    # in 200 us: 15 us busy of every 20 us
    ctx = {"loop": "train", "device_type": "cuda", "span": Span(_events()), "span_units": 3,
           "window_s": 200e-6, "window_units": 10}
    assert harness.device_idle(ctx, "train") == pytest.approx(25.0)
    assert harness.device_idle(dict(ctx, loop="caption"), "train") is None
    assert harness.device_idle(dict(ctx, span=None), "train") is None
