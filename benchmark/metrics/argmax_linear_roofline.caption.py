"""Kernel #8 (``ops/fused_decode.py``, ``csrc/argmax_linear.cu``), one
greedy step's out-projection and argmax: its roofline share
(``harness.roofline``)."""

from benchmark import harness, yardstick


def read(ctx):
    cfg = ctx["cfg"]
    return harness.roofline(ctx, "caption", "argmax_linear", yardstick.argmax_linear(
        ctx["batch"], cfg["dim_hidden"], cfg["vocab_size"], cfg["dtype"]))
