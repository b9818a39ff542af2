"""Kernel #2 (``ops/fused_s2vt.py``, ``csrc/fused_s2vt_bwd.cu``), the fused
backward of both LSTM chains: its roofline
share (``harness.roofline``)."""

from benchmark import harness, yardstick


def read(ctx):
    cfg = ctx["cfg"]
    return harness.roofline(ctx, "train", "fused_s2vt_bwd", yardstick.fused_s2vt_bwd(
        ctx["batch"], 2 * cfg["length"] - 1, cfg["dim_hidden"], cfg["dtype"]))
