"""Median over the traced window's reads of the staged integrity
verify (the exchange ledger's ``verify`` phase: the port's
``shuffle.verify`` span, the fold of every map output against its
commit's record and the verdict), in ms."""

from benchmark.metrics._spans import phase_median


def read(ctx):
    return phase_median("verify")
