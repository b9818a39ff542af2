"""Device kernels per request in the traced span (profiler records), the
caption loop's launch count: what a change that merges or captures launches
(CUDA graphs, fused kernels) cuts."""


def read(ctx):
    span = ctx["span"]
    if ctx["loop"] != "caption" or span is None or not ctx["span_units"] or not span.kernel_count:
        return None
    return span.kernel_count / ctx["span_units"]
