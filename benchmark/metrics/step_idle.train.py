"""The share (%) of the card's idle time in the train loop's traced span
(the span less the union of its device intervals) during which the host
had an ``s2vt.step`` or ``s2vt.step.*`` span open (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "train", spans.is_step)
