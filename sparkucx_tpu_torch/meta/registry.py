"""Shuffle registry — the per-shuffle metadata table, host side.

One slot per map output holding its packed size record
(:mod:`sparkucx_tpu_torch.meta.segments`), and beside it the map's
integrity record (``shuffle/integrity.IntegrityRecord``, stored as it
is); mappers publish at commit, readers wait until every slot is present
and snapshot the table in one read."""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from sparkucx_tpu_torch.meta.segments import (SegmentTable, pack_record,
                                              record_size, unpack_record)


class ShuffleEntry:
    """One shuffle's metadata table: num_maps fixed-size slots plus
    arrival tracking."""

    def __init__(self, shuffle_id: int, num_maps: int, num_partitions: int,
                 partitioner: str = "hash", bounds=None):
        self.shuffle_id = shuffle_id
        self.num_maps = num_maps
        self.num_partitions = num_partitions
        self.partitioner = partitioner
        # range split points: the durable ledger's manifest records them
        self.bounds = tuple(bounds) if bounds is not None else None
        self.slot = record_size(num_partitions)
        self.table = bytearray(self.slot * num_maps)
        self._present = np.zeros(num_maps, dtype=bool)
        self._integrity: Dict[int, object] = {}
        self._cv = threading.Condition()

    def publish(self, map_id: int, sizes: np.ndarray,
                integrity=None) -> None:
        """Mapper commit: write slot ``map_id``, with the optional
        ``integrity`` record beside it. A slot is written once (first
        commit wins)."""
        if not (0 <= map_id < self.num_maps):
            raise IndexError(
                f"mapId {map_id} out of range [0,{self.num_maps})")
        if len(sizes) != self.num_partitions:
            raise ValueError(
                f"sizes row has {len(sizes)} partitions, expected "
                f"{self.num_partitions}")
        rec = pack_record(map_id, np.asarray(sizes, dtype=np.uint64))
        with self._cv:
            if self._present[map_id]:
                raise RuntimeError(
                    f"shuffle {self.shuffle_id}: map {map_id} already "
                    f"published; its size row is immutable (first commit "
                    f"wins)")
            self.table[map_id * self.slot:(map_id + 1) * self.slot] = rec
            if integrity is not None:
                self._integrity[map_id] = integrity
            self._present[map_id] = True
            self._cv.notify_all()

    def fetch_integrity(self, map_id: int):
        """The integrity record published beside map ``map_id``'s size
        row, or None (published without one, or
        ``integrity.verify=off``)."""
        with self._cv:
            return self._integrity.get(map_id)

    def present(self, map_id: int) -> bool:
        """Whether map ``map_id``'s size row is published: after a
        restart, the maps to re-stage are those it is False for."""
        with self._cv:
            return bool(self._present[map_id])

    def wait_complete(self, timeout: Optional[float] = None) -> bool:
        """Block until every map output is published."""
        with self._cv:
            return self._cv.wait_for(self._present.all, timeout=timeout)

    @property
    def num_present(self) -> int:
        with self._cv:
            return int(self._present.sum())

    def fetch_table(self) -> SegmentTable:
        """Snapshot the whole table (every slot must be present)."""
        with self._cv:
            if not self._present.all():
                missing = np.flatnonzero(~self._present)[:8].tolist()
                raise RuntimeError(
                    f"shuffle {self.shuffle_id}: map outputs missing "
                    f"(e.g. {missing}); wait_complete() first")
            return SegmentTable.unpack(
                bytes(self.table), self.num_maps, self.num_partitions)

    def fetch_record(self, map_id: int) -> np.ndarray:
        with self._cv:
            if not self._present[map_id]:
                raise RuntimeError(f"mapId {map_id} not yet published")
            _, sizes = unpack_record(
                bytes(self.table[map_id * self.slot:
                                 (map_id + 1) * self.slot]))
            return sizes


class ShuffleRegistry:
    """All live shuffles of one node."""

    def __init__(self) -> None:
        self._entries: Dict[int, ShuffleEntry] = {}
        self._lock = threading.Lock()

    def register(self, shuffle_id: int, num_maps: int, num_partitions: int,
                 partitioner: str = "hash", bounds=None) -> ShuffleEntry:
        with self._lock:
            if shuffle_id in self._entries:
                raise ValueError(f"shuffle {shuffle_id} already registered")
            e = ShuffleEntry(shuffle_id, num_maps, num_partitions,
                             partitioner, bounds)
            self._entries[shuffle_id] = e
            return e

    def get(self, shuffle_id: int) -> ShuffleEntry:
        with self._lock:
            try:
                return self._entries[shuffle_id]
            except KeyError:
                raise KeyError(
                    f"shuffle {shuffle_id} not registered") from None

    def unregister(self, shuffle_id: int) -> None:
        with self._lock:
            self._entries.pop(shuffle_id, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
