"""The whole extraction request's share (%) of the card's peak: the
matrix-product operations of VGG16's 13 convs, fc6 and fc7 for every frame
the window extracted (counted from the shapes by
``benchmark/yardstick_cnn.py``) over the window's seconds, over the peak of
the configuration's dtype."""

from benchmark import yardstick, yardstick_cnn


def read(ctx):
    if ctx["loop"] != "extract" or ctx["device_type"] != "cuda" or not ctx["window_units"]:
        return None
    cfg = ctx["cfg"]
    flops = yardstick_cnn.vgg16_frame_flops(cfg["input_size"]) * ctx["frames"] \
        * ctx["window_units"]
    return 100.0 * flops / ctx["window_s"] / yardstick.PEAK_FLOPS[cfg["dtype"]]
