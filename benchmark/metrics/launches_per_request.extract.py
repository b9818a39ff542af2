"""Device kernels per request in the traced span (profiler records), the
extract loop's launch count: what a change that merges or captures launches
(fused preprocessing, CUDA graphs) cuts."""


def read(ctx):
    span = ctx["span"]
    if ctx["loop"] != "extract" or span is None or not ctx["span_units"] or not span.kernel_count:
        return None
    return span.kernel_count / ctx["span_units"]
