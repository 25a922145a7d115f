"""The whole step's model FLOPs over the traced window against the TF32
peak."""

from benchmark.metrics._common import mfu


def read(ctx):
    return mfu(ctx)
