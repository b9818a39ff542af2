"""Kernel #9 (``ops/fused_conv.py``, ``csrc/conv3x3_bn_relu.cu``), VGG16's 13
fused conv + BatchNorm + ReLU blocks, both routes: its roofline share in a
traced run of the extract loop, the sum of the 13 blocks' least times at a
request's frames (``benchmark/yardstick_cnn.py``) times the traced requests
over the device seconds of the kernel's records. None unless the program's
counter launched as many calls as the profiler kept records."""

from benchmark import harness, yardstick_cnn


def read(ctx):
    span = ctx["span"]
    if ctx["loop"] != "extract" or span is None or ctx["device_type"] != "cuda":
        return None
    op = "conv3x3_bn_relu"
    calls, seconds = span.kernel_stats(harness.kernel(op)["symbols"])
    if not calls or calls != ctx["launches"].get(op):
        return None
    cfg = ctx["cfg"]
    bound = sum(w.bound_s(cfg["dtype"]) for w in yardstick_cnn.vgg16_conv_works(
        ctx["frames"], cfg["dtype"], cfg["input_size"]))
    return 100.0 * bound * ctx["span_units"] / seconds
