"""The train step on the host: milliseconds a step of the traced span inside
the union of the ``s2vt.step`` and ``s2vt.step.*`` spans (the dropout
generator, forward, loss, backward, AdamW; ``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "train", spans.is_step)
