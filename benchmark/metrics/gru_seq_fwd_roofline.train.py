"""Kernel #5 (``ops/fused_gru.py``, ``csrc/gru_seq_fwd.cu``), one GRU chain
of a train step over 2L-1 steps: its roofline
share (``harness.roofline``)."""

from benchmark import harness, yardstick


def read(ctx):
    cfg = ctx["cfg"]
    return harness.roofline(ctx, "train", "gru_seq_fwd", yardstick.gru_seq_fwd(
        ctx["batch"], 2 * cfg["length"] - 1, cfg["dim_hidden"], cfg["dtype"]))
