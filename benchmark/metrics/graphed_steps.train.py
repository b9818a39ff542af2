"""The share (%) of the traced span's train steps (the main thread's
``s2vt.step`` spans) that replayed a captured CUDA graph: that hold an
``s2vt.step.replay`` span (``s2vt_tpu_torch/training/step_graph.py``, which
runs each step inside a span of its mode: ``s2vt.step.eager``, ``.capture``
or ``.replay``). A program that graphs none of its steps reads 0. None
where the program names no step's mode (as before the graph), or with no
traced span on the card."""

MODE_SPANS = ("s2vt.step.eager", "s2vt.step.capture", "s2vt.step.replay")


def read(ctx):
    span = ctx["span"]
    if ctx["loop"] != "train" or span is None or ctx["device_type"] != "cuda":
        return None
    if not any(name in MODE_SPANS for _, _, name in span.host):
        return None
    steps = [(a, b) for a, b, name in span.host if name == "s2vt.step"]
    if not steps:
        return None
    replays = [(a, b) for a, b, name in span.host if name == "s2vt.step.replay"]
    graphed = sum(any(a <= r0 and r1 <= b for r0, r1 in replays) for a, b in steps)
    return 100.0 * graphed / len(steps)
