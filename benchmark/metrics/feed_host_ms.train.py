"""The train loop's feed on the host: milliseconds a step of the traced span
inside the union of the main thread's ``s2vt.feed.*`` spans (the host
batch, its copies started, the copy's wait and the bank gather;
``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "train", spans.is_feed)
