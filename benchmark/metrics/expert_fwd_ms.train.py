"""Device ms per training step of the one-hot expert products' forward
(``moe.experts``: from the one-hot mask to the summed expert outputs, in
the forward and remat's re-forward; not their backward), from the spans'
CUDA events, over the window's ``train.step`` spans."""

from benchmark.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(("moe.experts",), "train.step")
