"""Kernel #6 (``ops/fused_gru.py``, ``csrc/gru_seq_bwd.cu``), the backward
of one GRU chain: its roofline
share (``harness.roofline``)."""

from benchmark import harness, yardstick


def read(ctx):
    cfg = ctx["cfg"]
    return harness.roofline(ctx, "train", "gru_seq_bwd", yardstick.gru_seq_bwd(
        ctx["batch"], 2 * cfg["length"] - 1, cfg["dim_hidden"], cfg["dtype"]))
