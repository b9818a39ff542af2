"""Kernel #1 (``ops/fused_s2vt.py``, ``csrc/fused_s2vt_fwd.cu``), both LSTM
chains of a train step over 2L-1 steps: its roofline
share (``harness.roofline``)."""

from benchmark import harness, yardstick


def read(ctx):
    cfg = ctx["cfg"]
    return harness.roofline(ctx, "train", "fused_s2vt_fwd", yardstick.fused_s2vt_fwd(
        ctx["batch"], 2 * cfg["length"] - 1, cfg["dim_hidden"], cfg["dtype"]))
