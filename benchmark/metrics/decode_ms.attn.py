"""Device ms per read of the Ulysses consumer's layout work: the decode
of the delivered rows into q, k, v (``ulysses.decode``) and the head and
sequence trades around the flash call (``ulysses.heads``), from the
spans' CUDA events, over the window's decodes (one a read)."""

from benchmark.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(("ulysses.decode", "ulysses.heads"),
                         "ulysses.decode")
