"""The share (%) of the extract loop's untraced window in which the card had
nothing to do: one less its busy time a request in the traced span over the
window's seconds a request (``harness.device_idle``)."""

from benchmark import harness


def read(ctx):
    return harness.device_idle(ctx, "extract")
