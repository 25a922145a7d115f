"""Device ms per read of the ordered device sink's densify and keysort
(the ``shuffle.keysort`` spans, stages densify and sort), from the
spans' CUDA events, over the window's reads (``shuffle.exchange``)."""

from benchmark.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(("shuffle.keysort",), "shuffle.exchange")
