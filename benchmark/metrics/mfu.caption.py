"""The whole caption request's share (%) of the card's peak: the
matrix-product operations of the window's greedy requests (encode, the
decoding steps and the out-projection, counted from the configuration's
shapes by ``benchmark/yardstick.py``) over the window's seconds, over the
peak of the configuration's dtype."""

from benchmark import yardstick


def read(ctx):
    if ctx["loop"] != "caption" or ctx["device_type"] != "cuda" or not ctx["window_units"]:
        return None
    cfg = ctx["cfg"]
    flops = yardstick.s2vt_greedy_flops(cfg, ctx["batch"]) * ctx["window_units"]
    return 100.0 * flops / ctx["window_s"] / yardstick.PEAK_FLOPS[cfg["dtype"]]
