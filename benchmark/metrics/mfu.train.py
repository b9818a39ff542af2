"""The whole train step's share (%) of the card's peak: the matrix-product
operations of the window's steps (forward and backward, counted from the
configuration's shapes by ``benchmark/yardstick.py``) over the window's
seconds, over the peak of the configuration's dtype."""

from benchmark import yardstick


def read(ctx):
    if ctx["loop"] != "train" or ctx["device_type"] != "cuda" or not ctx["window_units"]:
        return None
    cfg = ctx["cfg"]
    flops = yardstick.s2vt_train_step_flops(cfg, ctx["batch"]) * ctx["window_units"]
    return 100.0 * flops / ctx["window_s"] / yardstick.PEAK_FLOPS[cfg["dtype"]]
