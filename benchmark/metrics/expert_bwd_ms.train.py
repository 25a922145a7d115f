"""Device ms per training step of the grouped expert products' backward
(``moe.experts.backward``: the four grouped products of the expert FFN's
backward, the weight transposes beside them), from the spans' CUDA
events, over the window's ``train.step`` spans; None on a program that
opens no such span."""

from benchmark.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(("moe.experts.backward",), "train.step")
