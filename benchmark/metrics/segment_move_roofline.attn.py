"""The segment-move kernel (``csrc/ragged_a2a.cu``) against its memory
bound: each moved payload byte read once and written once."""

from benchmark.metrics._common import roofline


def read(ctx):
    return roofline(ctx, "segment_move")
