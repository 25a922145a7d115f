"""Typed failures of the ported planes.

Only :class:`TruncatedBlockError` is ported: the spill files raise it
(``shuffle/writer.SpillFiles.load``). The JAX package files it under its
transient block-corruption errors, which its replay policy retries; the
port has no replay policy yet, so here it is a plain ``RuntimeError``."""

from __future__ import annotations


class TruncatedBlockError(RuntimeError):
    """A spill file is shorter than its sealed sidecar declares — a torn
    write or an external truncation. Raised before the file is mapped,
    naming the file, so a reader never gets a short or garbage view."""
