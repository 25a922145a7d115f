"""95th percentile of the host time of ``svc.read`` until its device
result is ready, over the traced window's steps (the benchmark's own
span): the tail that the host part of the read puts into a step."""

from benchmark.metrics._common import span_percentile


def read(ctx):
    return span_percentile(ctx, "read_ms", 95)
