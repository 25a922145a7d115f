"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric. Each has ``read(ctx)``, which returns
the metric's value or None where the traced window holds nothing to read
(the harness then leaves the metric out). ``ctx``: ``trace`` (``busy_s``,
``window_s``, ``kernels`` {device op name: [seconds per launch]}),
``peaks`` (the card's row of ``peaks.py`` or None) and ``facts`` (the
driver's ``model_flops``, ``kernel_work`` and host ``spans``)."""
