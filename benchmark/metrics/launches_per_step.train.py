"""Device kernels per step in the traced span (profiler records), the
train loop's launch count: what a change that merges or captures launches
(CUDA graphs, fused kernels) cuts."""


def read(ctx):
    span = ctx["span"]
    if ctx["loop"] != "train" or span is None or not ctx["span_units"] or not span.kernel_count:
        return None
    return span.kernel_count / ctx["span_units"]
