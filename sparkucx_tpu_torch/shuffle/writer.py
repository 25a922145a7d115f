"""Map-side writer — stage records, publish the size row.

``write`` copies each key/value batch into host staging owned by the
writer; ``commit`` computes the per-reduce-partition size row with the
host twin of the device partitioner and publishes it to the shuffle's
registry entry. An empty output publishes an all-zero row. Spill to disk
is not part of this port yet: staging is host memory only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sparkucx_tpu_torch.meta.registry import ShuffleEntry
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import Timer

log = get_logger("shuffle.writer")


def hash32_np(keys: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`sparkucx_tpu_torch.ops.partition.hash32` —
    bit-for-bit, so the host-published size row agrees with device
    routing."""
    x = keys.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


class MapOutputWriter:
    """Writer for one map task's output (one row of the segment table)."""

    def __init__(self, entry: ShuffleEntry, map_id: int,
                 partitioner: str = "hash", bounds=None):
        self.entry = entry
        self.map_id = map_id
        self.partitioner = partitioner
        self.bounds = bounds
        self._keys: List[np.ndarray] = []
        self._values: List[np.ndarray] = []
        self._val_tail: Optional[Tuple[int, ...]] = None
        self._val_dtype = None
        self._committed = False
        self._released = False

    def write(self, keys: np.ndarray,
              values: Optional[np.ndarray] = None) -> None:
        """Append a batch: ``keys`` [N] integers, ``values`` [N, ...]
        optional payload rows of one fixed schema per writer."""
        if self._committed:
            raise RuntimeError("writer already committed")
        if self._released:
            raise RuntimeError(
                f"map {self.map_id}: writer was released; obtain a fresh "
                f"writer")
        keys = np.asarray(keys)
        if keys.ndim != 1:
            raise ValueError("keys must be 1-D")
        if not np.issubdtype(keys.dtype, np.integer):
            raise ValueError(
                f"keys must be integers, got {keys.dtype}; put non-integer "
                f"sort keys in the value payload")
        if values is not None:
            values = np.asarray(values)
            if values.shape[0] != keys.shape[0]:
                raise ValueError(
                    f"values rows {values.shape[0]} != keys {keys.shape[0]}")
            if self._val_dtype is None:
                if self.num_rows:
                    raise ValueError("mixed batches with and without values")
                self._val_tail, self._val_dtype = \
                    values.shape[1:], values.dtype
            elif (values.shape[1:], values.dtype) != (self._val_tail,
                                                      self._val_dtype):
                raise ValueError(
                    f"mixed value schema within one writer: "
                    f"{values.dtype}{values.shape[1:]} after "
                    f"{self._val_dtype}{self._val_tail}")
            self._values.append(np.array(values, copy=True, order="C"))
        elif self._val_dtype is not None:
            raise ValueError("mixed batches with and without values")
        # staged copies: the caller may reuse its arrays after write()
        self._keys.append(np.array(keys, dtype=np.int64, copy=True))

    @property
    def num_rows(self) -> int:
        return sum(k.shape[0] for k in self._keys)

    @property
    def committed(self) -> bool:
        return self._committed

    def commit(self, num_partitions: int) -> np.ndarray:
        """Compute and publish this map output's size row; returns it."""
        if self._committed:
            raise RuntimeError("writer already committed")
        if self._released:
            raise RuntimeError(
                f"map {self.map_id}: writer was released — its staged rows "
                f"are gone and it may not publish; first commit wins")
        with Timer() as t:
            keys, _ = self.materialize()
            if keys.shape[0]:
                sizes = np.bincount(self.partition_of(keys, num_partitions),
                                    minlength=num_partitions)
            else:
                sizes = np.zeros(num_partitions, dtype=np.int64)
            self.entry.publish(self.map_id, sizes)
        self._committed = True
        log.debug("map %d publish: %.2f ms (%d rows)", self.map_id, t.ms,
                  keys.shape[0])
        return sizes

    def partition_of(self, keys: np.ndarray,
                     num_partitions: int) -> np.ndarray:
        """Host partition ids for ``keys`` — bit-for-bit with the device
        routing (``reader._make_part_fn``)."""
        if self.partitioner == "direct":
            if (keys < 0).any() or (keys >= num_partitions).any():
                bad = keys[(keys < 0) | (keys >= num_partitions)][:4]
                raise ValueError(
                    f"direct partitioner: keys must be partition ids in "
                    f"[0, {num_partitions}); got e.g. {bad.tolist()}")
            return keys.astype(np.int64)
        if self.partitioner == "range":
            # host twin of ops/partition.range_partition_words
            return np.searchsorted(np.asarray(self.bounds, dtype=np.int64),
                                   keys, side="right").astype(np.int64)
        return (hash32_np(keys) % np.uint32(num_partitions)).astype(np.int64)

    def materialize(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Concatenated (keys, values) staged by this writer."""
        if not self._keys:
            return np.zeros(0, dtype=np.int64), None
        keys = self._keys[0] if len(self._keys) == 1 \
            else np.concatenate(self._keys)
        if not self._values:
            return keys, None
        values = self._values[0] if len(self._values) == 1 \
            else np.concatenate(self._values)
        return keys, values

    def release(self) -> None:
        """Drop the staged rows; the writer is dead afterwards."""
        self._released = True
        self._keys.clear()
        self._values.clear()
