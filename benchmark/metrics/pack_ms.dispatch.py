"""Median ``ExchangeReport.pack_ms`` (the host pack into staging) of the
traced window's reads."""

from benchmark.metrics._common import span_median


def read(ctx):
    return span_median(ctx, "pack_ms")
