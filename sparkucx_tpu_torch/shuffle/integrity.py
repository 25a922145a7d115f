"""Order-free row digests — the part of the JAX package's block-integrity
plane that the workloads need.

Only the splitmix64 finalizer :func:`_mix64`, the per-row digests
:func:`row_digests` and their sum :func:`digest_sum` are ported: they back
``workloads.sampled_key_digest`` and ``workloads.terasort.keystream``. A
row digest binds the key and the value row's bytes and never the row's
position, so the sum over any set of rows is invariant under the
destination sort and every other reorder the exchange performs. Sums wrap
mod 2**64. The rest of the reference module (integrity records, the
``integrity.verify`` levels, manifests, file checksums) is not ported yet.

Everything here is host-side numpy, bit for bit the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_U64 = np.uint64
_FOLD_LEN_SALT = _U64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (in-place temps on one copy)."""
    x = x.astype(_U64, copy=True)
    x += _U64(0x9E3779B97F4A7C15)
    x ^= x >> _U64(30)
    x *= _U64(0xBF58476D1CE4E5B9)
    x ^= x >> _U64(27)
    x *= _U64(0x94D049BB133111EB)
    x ^= x >> _U64(31)
    return x


def row_digests(keys: np.ndarray,
                values: Optional[np.ndarray]) -> np.ndarray:
    """[N] uint64 per-row digests of (key, value-row bytes): the mixed key
    plus the sum of the mixed value words, each salted by its position in
    the row. Row identity only, never row order."""
    n = keys.shape[0]
    h = _mix64(np.ascontiguousarray(keys, dtype=np.int64).view(_U64))
    if values is not None and n:
        v = np.ascontiguousarray(values)
        row_bytes = v.dtype.itemsize * int(
            np.prod(v.shape[1:], dtype=np.int64) or 1)
        raw = v.view(np.uint8).reshape(n, row_bytes)
        pad = (-row_bytes) % 8
        if pad:
            raw = np.concatenate(
                [raw, np.zeros((n, pad), np.uint8)], axis=1)
        words = raw.view(_U64)                      # [N, K]
        salts = _FOLD_LEN_SALT * (
            np.arange(1, words.shape[1] + 1, dtype=_U64))
        h = h + _mix64(words ^ salts[None, :]).sum(axis=1, dtype=_U64)
    return h


def digest_sum(keys: np.ndarray, values: Optional[np.ndarray]) -> int:
    """Sum (mod 2**64) of one row set's digests."""
    if keys.shape[0] == 0:
        return 0
    return int(row_digests(keys, values).sum(dtype=_U64))
