"""The share of the traced window in which the card ran nothing."""

from benchmark.metrics._common import idle


def read(ctx):
    return idle(ctx)
