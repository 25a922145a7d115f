"""The flash forward kernel against the larger of its bytes and its
causal products over the TF32 peak."""

from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, "flash_fwd")
