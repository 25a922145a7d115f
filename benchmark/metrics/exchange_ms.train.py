"""Device ms per training step of the differentiable exchange: every
``moe.exchange`` span (the expert dispatch and combine, forward, remat's
re-forward and backward), from the spans' CUDA events, over the
window's ``train.step`` spans."""

from benchmark.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(("moe.exchange",), "train.step")
