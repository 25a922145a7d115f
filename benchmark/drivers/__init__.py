"""The general generators: one module for each kind of work a traffic mix
can name (``"driver"``). Each has a ``Driver(config, traffic, seed,
device, kernel_cache)`` with ``setup()``, ``step(trace) -> dict`` (one
timed unit of work, ending when its result is ready), ``facts(steps)``
(what the per-layer readers need), ``release()`` and ``check() ->
[{"name", "value", "limit"}]``."""
