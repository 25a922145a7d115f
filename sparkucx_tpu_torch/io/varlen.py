"""Variable-length / opaque-byte payloads over the fixed-width transport.

The exchange moves fixed-width int32 rows, so opaque bytes (string keys,
serialized records) ride as length-prefixed, padded byte rows:

    [ len : int32 LE | payload bytes | zero pad to a fixed width ]

packed little-endian into the int32 value lanes of the normal transport
row. The pad ceiling is per shuffle (the declared record-size bound);
skew in record length costs pad bytes on the wire, not correctness. The
length prefix — not a sentinel — delimits, so NUL bytes and empty
payloads round-trip exactly.

Keys stay int64 (the transport's routing type). For string keys
(WordCount over text, varchar joins), :func:`hash_bytes64` derives a
deterministic 64-bit key from the bytes (FNV-1a, bit for bit the JAX
package's, since the routing of string keys depends on it); the bytes
themselves ride as (part of) the value payload so the reduce side can
recover the exact key. A 64-bit collision merges two distinct keys —
probability ~n^2/2^65. On a plain read the collision is detectable after
the fact (the colliding rows carry their differing bytes); under device
combine the merge is silent: the combiner keeps one representative's
carried bytes and sums the counts.

The layouts are byte-equal to the JAX package's ``io/varlen``. Only its
numpy paths are ported: the reference's optional host C++ library for
these loops is not. Zero items pack and unpack here as well (the
reference's views refuse them).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

Item = Union[bytes, bytearray, str]


def _as_bytes_list(items: Sequence[Item]) -> List[bytes]:
    out = []
    for x in items:
        if isinstance(x, str):
            out.append(x.encode("utf-8"))
        elif isinstance(x, (bytes, bytearray, np.bytes_)):
            out.append(bytes(x))
        else:
            raise TypeError(
                f"varbytes items must be bytes/str, got {type(x).__name__}")
    return out


def varbytes_width(max_bytes: int) -> int:
    """Total uint8 row width for a payload ceiling: 4-byte length prefix
    plus the payload padded up to a multiple of 4 (whole transport
    words)."""
    if max_bytes < 0:
        raise ValueError("max_bytes must be >= 0")
    return 4 + ((int(max_bytes) + 3) // 4) * 4


def varbytes_words(max_bytes: int) -> int:
    """Value width in int32 transport words for a payload ceiling."""
    return varbytes_width(max_bytes) // 4


def _blob_starts(data: List[bytes]) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """(blob uint8 [total], starts int64 [n+1], lens int64 [n]) — the
    Arrow-style layout the scatter and gather below consume. The
    ``b"".join`` runs at C speed; no per-item numpy work."""
    n = len(data)
    lens = np.fromiter(map(len, data), dtype=np.int64, count=n)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    blob = (np.frombuffer(b"".join(data), dtype=np.uint8)
            if starts[-1] else np.zeros(0, np.uint8))
    return blob, starts, lens


def _gather_indices(starts: np.ndarray,
                    lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row_ix, col_ix) mapping blob byte k to its row and in-row column
    — the one copy of the index math the pack and the unpack use."""
    n = lens.shape[0]
    total = int(starts[-1])
    row_ix = np.repeat(np.arange(n, dtype=np.int64), lens)
    col_ix = np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], lens)
    return row_ix, col_ix


def _scatter_to_rows(blob: np.ndarray, starts: np.ndarray,
                     lens: np.ndarray, out: np.ndarray,
                     col_base: int) -> None:
    """One fancy-indexed scatter: blob byte k lands at
    ``out[row(k), col_base + (k - starts[row])]``."""
    if not int(starts[-1]):
        return
    row_ix, col_ix = _gather_indices(starts, lens)
    out[row_ix, col_base + col_ix] = blob


def pack_varbytes(items: Sequence[Item], max_bytes: int) -> np.ndarray:
    """Encode items as [n, varbytes_width(max_bytes)] uint8 rows.

    Raises when any item exceeds ``max_bytes``: silent truncation would
    corrupt records. One blob + prefix offsets, then one fancy-indexed
    scatter (``np.repeat`` maps blob byte k to its (row, col) slot)."""
    data = _as_bytes_list(items)
    if not data:
        return np.zeros((0, varbytes_width(max_bytes)), dtype=np.uint8)
    blob, starts, lens = _blob_starts(data)
    return pack_varbytes_blob(blob, starts, lens, max_bytes)


def pack_varbytes_blob(blob: np.ndarray, starts: np.ndarray,
                       lens: np.ndarray, max_bytes: int) -> np.ndarray:
    """Core of :func:`pack_varbytes` over the (blob, starts, lens) layout
    directly (Arrow string/binary columns store exactly these buffers).
    Contract: ``starts[0] == 0``, ``len(blob) == starts[-1]``,
    ``lens == np.diff(starts)``."""
    width = varbytes_width(max_bytes)
    n = lens.shape[0]
    if n == 0:
        return np.zeros((0, width), dtype=np.uint8)
    if lens.max(initial=0) > max_bytes:
        i = int(np.argmax(lens))
        raise ValueError(
            f"item {i} is {int(lens[i])} B > declared "
            f"max_bytes={max_bytes}; raise the ceiling (records are "
            f"never truncated)")
    blob = np.ascontiguousarray(blob)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.zeros((n, width), dtype=np.uint8)
    out[:, :4] = lens.astype("<i4").view(np.uint8).reshape(n, 4)
    _scatter_to_rows(blob, starts, lens, out, col_base=4)
    return out


def unpack_varbytes(rows: np.ndarray) -> List[bytes]:
    """Decode [n, width] uint8 (or int32-viewed) varbytes rows."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype != np.uint8 and rows.ndim == 2:
        # explicit row width: a view of zero rows has none to infer
        rows = rows.view(np.uint8).reshape(rows.shape[0],
                                           rows.shape[1] * rows.itemsize)
    if rows.dtype != np.uint8 or rows.ndim != 2 or rows.shape[1] < 4:
        raise ValueError(f"varbytes rows must be [n, >=4], got {rows.shape}")
    # explicit LE read — the wire contract
    lens = rows[:, :4].copy().view(np.dtype("<i4")).reshape(-1) \
        .astype(np.int64)
    limit = rows.shape[1] - 4
    bad = (lens < 0) | (lens > limit)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"row {i}: corrupt varbytes length {int(lens[i])} "
            f"(row width {limit})")
    # gather every row's live bytes into one blob with one fancy index,
    # then per-item bytes() slicing off it
    n = rows.shape[0]
    total = int(lens.sum())
    if n == 0 or total == 0:
        return [b""] * n if n else []
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    row_ix, col_ix = _gather_indices(starts, lens)
    blob = rows[row_ix, 4 + col_ix].tobytes()
    return [blob[int(s):int(e)] for s, e in zip(starts[:-1], starts[1:])]


_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def hash_bytes64(items: Sequence[Item]) -> np.ndarray:
    """Deterministic FNV-1a 64-bit hash per item -> int64 keys.

    Vectorized across rows (one masked update per byte position), so
    hashing a million short words is a handful of numpy passes. Identical
    across hosts and bit-equal to the JAX package's, as the routing hash
    must be."""
    data = _as_bytes_list(items)
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    blob, starts, lens = _blob_starts(data)
    width = max(1, int(lens.max(initial=0)))
    mat = np.zeros((n, width), dtype=np.uint8)
    _scatter_to_rows(blob, starts, lens, mat, col_base=0)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(width):
            active = j < lens
            hj = (h ^ mat[:, j].astype(np.uint64)) * _FNV_PRIME
            h = np.where(active, hj, h)
    return h.view(np.int64)


def pack_counted_varbytes(items: Sequence[Item], counts: np.ndarray,
                          max_bytes: int) -> Tuple[np.ndarray, int]:
    """WordCount-shaped value rows: [count : int32 | varbytes(item)] as an
    [n, 1 + varbytes_words] INT32 matrix (one combine-capable dtype). The
    count lane is summed by the device combiner; the byte lanes are
    carried (all rows of one key hold the same bytes, so any
    representative survives — ``combine_sum_words=1``).

    Returns (values int32 [n, w], sum_words=1)."""
    counts = np.asarray(counts, dtype=np.int32)
    vb = pack_varbytes(items, max_bytes)
    if counts.shape != (vb.shape[0],):
        raise ValueError(
            f"counts shape {counts.shape} != items {vb.shape[0]}")
    words = vb.view(np.int32).reshape(vb.shape[0], vb.shape[1] // 4)
    return np.concatenate([counts.reshape(-1, 1), words], axis=1), 1


def unpack_counted_varbytes(values: np.ndarray
                            ) -> Tuple[np.ndarray, List[bytes]]:
    """Inverse of pack_counted_varbytes: (counts int64, items)."""
    values = np.ascontiguousarray(values)
    if values.dtype != np.int32:
        raise ValueError(f"expected int32 value rows, got {values.dtype}")
    counts = values[:, 0].astype(np.int64)
    return counts, unpack_varbytes(values[:, 1:])


def unpack_counted_rows(n_rows: int, values: np.ndarray
                        ) -> Tuple[np.ndarray, List[bytes]]:
    """:func:`unpack_counted_varbytes` for values as they come back from a
    shuffle read: reinterprets the [n, ...] value block as int32 rows
    first."""
    if n_rows == 0:
        return np.zeros(0, dtype=np.int64), []
    rows = np.ascontiguousarray(values).reshape(n_rows, -1).view(np.int32)
    return unpack_counted_varbytes(rows)
