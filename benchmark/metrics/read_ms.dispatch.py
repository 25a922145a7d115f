"""Median host time of ``svc.read`` until its device result is ready,
over the traced window's steps (the benchmark's own span)."""

from benchmark.metrics._common import span_median


def read(ctx):
    return span_median(ctx, "read_ms")
