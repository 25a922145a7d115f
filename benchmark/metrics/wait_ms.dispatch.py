"""Median over the traced window's reads of the host's completion wait
(the exchange ledger's ``transfer.ici`` phase: the port's
``shuffle.exchange.wait`` span, the host blocked on the read's H2D and
segment move), in ms."""

from benchmark.metrics._spans import phase_median


def read(ctx):
    return phase_median("transfer.ici")
