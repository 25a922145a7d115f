"""The flash backward kernels (dq and dk/dv together) against the larger
of their bytes and their causal products over the TF32 peak."""

from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, "flash_bwd")
