"""Map-side writer — stage records, publish the size row.

``write`` copies each key/value batch into buffers of the node's staging
pool (page-locked on a CUDA node, so the later pack reads pinned memory
and the pool's byte count sees what map tasks hold); ``commit`` computes
the per-reduce-partition size row with the host twin of the device
partitioner and publishes it to the shuffle's registry entry, with the
output's integrity record beside it (``shuffle/integrity.
IntegrityRecord``: fold64 checksums at ``integrity.verify=staged``, also
per-partition digest rows at ``full``, none at ``off``). An empty output
publishes an all-zero row.

Durable commit (``failure.ledgerDir``, ``shuffle/durable.py``): the
writer's spill directory is the shuffle's ledger directory, ``commit``
seals the whole output there before it publishes (so a published map
survives the process), adds crc32 checksums to the record and rewrites
the shuffle's manifest. A durable writer's ``release`` keeps its files;
:meth:`MapOutputWriter.recovered` adopts a sealed file set after a
restart.

Spill: past ``spill.threshold`` staged bytes, a writer appends its
batches to a ``.keys``/``.vals`` file pair (:class:`SpillFiles`) and
returns the staging buffers to the pool; at commit the files are sealed
(fsync + atomic rename + an atomic ``.index`` sidecar) and mapped back,
and the read path packs straight from the mapped views.
:meth:`MapOutputWriter.spill` is the same move on demand — the budget
valve of the external-memory pipelines
(``workloads.MemoryBudget``).

Fault sites (the node's ``FaultInjector``, ``fault.<site>.*``):
``publish`` before a commit publishes, ``spill`` before a move to disk.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from sparkucx_tpu_torch.meta.registry import ShuffleEntry
from sparkucx_tpu_torch.runtime.failures import TruncatedBlockError
from sparkucx_tpu_torch.runtime.node import HostStagingPool, MappedFile
from sparkucx_tpu_torch.shuffle.integrity import compute_record
from sparkucx_tpu_torch.utils.atomicio import atomic_write_text, fsync_dir
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
from sparkucx_tpu_torch.utils.metrics import (C_SPILL_BYTES, C_SPILL_COUNT,
                                              Timer)

log = get_logger("shuffle.writer")


class SpillFiles:
    """Disk-backed map-output staging: append-only ``.keys``/``.vals``
    files plus a small ``.index`` sidecar (schema and row count), mapped
    back as zero-copy numpy views.

    Appends land in ``*.tmp`` files; :meth:`finish` seals them (flush,
    fsync, atomic rename to the final names, the sidecar written the
    same way, the directory fsynced), so a process killed mid-spill
    leaves only ``.tmp`` files, never a short file under a final name.
    :meth:`load` checks the sealed files' lengths against the sidecar
    before it maps them: a short file raises
    :class:`~sparkucx_tpu_torch.runtime.failures.TruncatedBlockError`
    naming the file."""

    def __init__(self, directory: str, shuffle_id: int, map_id: int):
        os.makedirs(directory, exist_ok=True)
        stem = os.path.join(directory,
                            f"shuffle_{shuffle_id}_map_{map_id}")
        self.keys_path = stem + ".keys"
        self.vals_path = stem + ".vals"
        self.index_path = stem + ".index"
        # "wb": the stem is this writer's alone (first commit wins), so
        # bytes a crashed predecessor left under it are truncated
        self._kf = open(self.keys_path + ".tmp", "wb")
        self._vf = open(self.vals_path + ".tmp", "wb")
        self.rows = 0
        self.sealed = False
        self._maps: List[MappedFile] = []

    @classmethod
    def open_sealed(cls, directory: str, shuffle_id: int,
                    map_id: int) -> "SpillFiles":
        """Adopt an already sealed file set (the durable ledger's restart
        recovery): no open files, the rows from the sealed sidecar;
        :meth:`load` maps the columns."""
        obj = cls.__new__(cls)
        stem = os.path.join(directory,
                            f"shuffle_{shuffle_id}_map_{map_id}")
        obj.keys_path = stem + ".keys"
        obj.vals_path = stem + ".vals"
        obj.index_path = stem + ".index"
        obj._kf = obj._vf = None
        obj.sealed = True
        obj._maps = []
        with open(obj.index_path) as f:
            obj.rows = int(json.load(f)["rows"])
        return obj

    def append(self, keys: np.ndarray, values: Optional[np.ndarray]) -> None:
        if self.sealed:
            raise RuntimeError(
                f"{self.keys_path}: sealed spill files are immutable "
                f"(append after finish)")
        self._kf.write(np.ascontiguousarray(keys).data)
        if values is not None:
            self._vf.write(np.ascontiguousarray(values).data)
        self.rows += keys.shape[0]

    def finish(self, val_tail, val_dtype) -> None:
        """Seal: flush + fsync + atomic rename of each ``.tmp`` file, then
        the ``.index`` sidecar (schema + rows) written atomically.
        Idempotent."""
        if self.sealed:
            return
        for f in (self._kf, self._vf):
            f.flush()
            os.fsync(f.fileno())
            f.close()
        self._kf = self._vf = None
        os.replace(self.keys_path + ".tmp", self.keys_path)
        os.replace(self.vals_path + ".tmp", self.vals_path)
        atomic_write_text(self.index_path, json.dumps({
            "rows": self.rows,
            "val_dtype": (np.dtype(val_dtype).str
                          if val_dtype is not None else None),
            "val_tail": list(val_tail) if val_tail is not None else None,
        }))
        fsync_dir(os.path.dirname(self.keys_path))
        self.sealed = True

    def load(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Map the sealed files back as read-only arrays (page-cache
        backed). Each file's length is checked against the sidecar
        first."""
        with open(self.index_path) as f:
            idx = json.load(f)
        n = idx["rows"]
        keys = np.zeros(0, dtype=np.int64)
        values = None
        if n:
            need = n * 8
            got = os.path.getsize(self.keys_path)
            if got != need:
                raise TruncatedBlockError(
                    f"{self.keys_path}: {got} B on disk but the sealed "
                    f"sidecar declares {n} rows = {need} B — torn write "
                    f"or external truncation")
            km = MappedFile(self.keys_path)
            self._maps.append(km)
            keys = km.data[:need].view(np.int64)
        if idx["val_dtype"] is not None:
            vdt = np.dtype(idx["val_dtype"])
            tail = tuple(idx["val_tail"])
            if n:
                nbytes = n * int(np.prod(tail, dtype=np.int64) or 1) \
                    * vdt.itemsize
                got = os.path.getsize(self.vals_path)
                if got != nbytes:
                    raise TruncatedBlockError(
                        f"{self.vals_path}: {got} B on disk but the "
                        f"sealed sidecar declares {n} x {vdt.str}{tail} "
                        f"= {nbytes} B — torn write or external "
                        f"truncation")
                vm = MappedFile(self.vals_path)
                self._maps.append(vm)
                values = vm.data[:nbytes].view(vdt).reshape((n,) + tail)
            else:
                values = np.zeros((0,) + tail, dtype=vdt)
        return keys, values

    def drop_views(self) -> None:
        """Drop the mappings only, keeping the files (a later
        :meth:`load` maps them again)."""
        for m in self._maps:
            m.close()
        self._maps.clear()

    def close(self, delete: bool = True) -> None:
        """Close the files and drop the mappings; with ``delete`` (the
        default) delete the files too (sealed, index and ``*.tmp``). A
        durable writer keeps them: deleting them is the ledger's job."""
        for f in (self._kf, self._vf):
            if f is not None:
                f.close()
        self._kf = self._vf = None
        self.drop_views()
        if not delete:
            return
        for p in (self.keys_path, self.vals_path, self.index_path,
                  self.keys_path + ".tmp", self.vals_path + ".tmp"):
            try:
                os.unlink(p)
            except OSError:
                pass


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
                 pool: HostStagingPool, partitioner: str = "hash",
                 bounds=None, spill_dir: Optional[str] = None,
                 spill_threshold: int = 0, metrics=None, faults=None,
                 integrity_level: str = "off", ledger=None):
        self.entry = entry
        self.faults = faults      # runtime.failures.FaultInjector
        self.map_id = map_id
        self.pool = pool
        self.partitioner = partitioner
        self.bounds = bounds
        self._keys: List[np.ndarray] = []
        self._values: List[np.ndarray] = []
        self._staged = []            # the pool buffers behind the views
        self._val_tail: Optional[Tuple[int, ...]] = None
        self._val_dtype = None
        self._committed = False
        self._released = False
        # spill (threshold 0 = staging only)
        self._spill_dir = spill_dir
        self._spill_threshold = spill_threshold if spill_dir else 0
        self._spill: Optional[SpillFiles] = None
        self._spill_views = None     # cached mapped (keys, values)
        self._staged_bytes = 0
        self._metrics = metrics
        # integrity.verify at commit: "off" publishes no record
        self._integrity_level = integrity_level
        self.integrity = None        # the published record
        # the durable ledger (shuffle/durable.ShuffleLedger): commit seals
        # into spill_dir (the ledger's shuffle directory) and records the
        # manifest row; release() keeps a durable writer's files
        self._ledger = ledger
        self._durable = ledger is not None

    def _stage(self, arr: np.ndarray) -> np.ndarray:
        """Copy ``arr`` into a pool buffer; returns the view over it."""
        buf = self.pool.get(arr.nbytes)
        self._staged.append(buf)
        view = buf.numpy()[:arr.nbytes]
        view[:] = arr.reshape(-1).view(np.uint8)
        return view.view(arr.dtype).reshape(arr.shape)

    def write(self, keys: np.ndarray,
              values: Optional[np.ndarray] = None) -> None:
        """Append a batch: ``keys`` [N] integers, ``values`` [N, ...]
        optional payload rows of one fixed schema per writer. Past
        ``spill.threshold`` staged bytes the staged batches move to the
        spill files."""
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
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        if values is not None:
            values = np.ascontiguousarray(values)
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
        elif self._val_dtype is not None:
            raise ValueError("mixed batches with and without values")
        # staged copies: the caller may reuse its arrays after write()
        self._keys.append(self._stage(keys))
        if values is not None:
            self._values.append(self._stage(values))
        self._staged_bytes += keys.nbytes + (values.nbytes
                                             if values is not None else 0)
        if self._spill_threshold and \
                self._staged_bytes >= self._spill_threshold:
            self._flush_to_disk()

    def _flush_to_disk(self) -> None:
        """Append the staged batches to the spill files and return their
        buffers to the pool; counts ``shuffle.spill.bytes`` / ``.count``
        (every spill, threshold or forced, passes here)."""
        if self.faults is not None:
            self.faults.check("spill")
        if self._spill is None:
            self._spill = SpillFiles(self._spill_dir, self.entry.shuffle_id,
                                     self.map_id)
            log.info("map %d spilling to %s (threshold %d B)", self.map_id,
                     self._spill.keys_path, self._spill_threshold)
        with GLOBAL_TRACER.span("shuffle.spill", map_id=self.map_id,
                                shuffle_id=self.entry.shuffle_id):
            for i, keys in enumerate(self._keys):
                self._spill.append(keys, self._values[i] if self._values
                                   else None)
            self._keys.clear()
            self._values.clear()
            self._return_staged()
        moved, self._staged_bytes = self._staged_bytes, 0
        if moved and self._metrics is not None:
            self._metrics.inc(C_SPILL_BYTES, float(moved))
            self._metrics.inc(C_SPILL_COUNT, 1.0)

    def _return_staged(self) -> None:
        for b in self._staged:
            self.pool.put(b)
        self._staged.clear()

    def spill(self) -> int:
        """Move the staged batches to the spill files now; returns the
        bytes moved (0 when nothing is staged or the writer has no spill
        directory). The pipelines' budget valve calls it when the pool's
        bytes in use cross their budget: ``spill.threshold`` bounds one
        writer, this bounds their sum."""
        if self._committed or self._released:
            raise RuntimeError(
                f"map {self.map_id}: spill() on a "
                f"{'committed' if self._committed else 'released'} writer")
        if self._spill_dir is None or not self._keys:
            return 0
        moved = self._staged_bytes
        self._flush_to_disk()
        return moved

    @property
    def num_rows(self) -> int:
        spilled = self._spill.rows if self._spill is not None else 0
        return spilled + sum(k.shape[0] for k in self._keys)

    @property
    def committed(self) -> bool:
        return self._committed

    @property
    def released(self) -> bool:
        return self._released

    def commit(self, num_partitions: int) -> np.ndarray:
        """Compute and publish this map output's size row and integrity
        record; returns the size row. With a ledger the output is sealed
        on disk before anything is published."""
        if self._committed:
            raise RuntimeError("writer already committed")
        if self._released:
            raise RuntimeError(
                f"map {self.map_id}: writer was released — its staged rows "
                f"are gone and it may not publish; first commit wins")
        if self.faults is not None:
            self.faults.check("publish")
        with Timer() as t, GLOBAL_TRACER.span(
                "shuffle.publish", map_id=self.map_id, rows=self.num_rows):
            keys = values = parts = None
            if self.num_rows:
                if self._ledger is not None and self._spill is None:
                    # a published durable map must survive a restart:
                    # materialize() below seals the files
                    self._flush_to_disk()
                keys, values = self.materialize()
                parts = self.partition_of(keys, num_partitions)
                sizes = np.bincount(parts, minlength=num_partitions)
            else:
                sizes = np.zeros(num_partitions, dtype=np.int64)
            rec = None
            if self._integrity_level != "off" or self._ledger is not None:
                rec = compute_record(
                    keys, values, parts, num_partitions,
                    with_digests=self._integrity_level == "full",
                    with_crc=self._ledger is not None)
            self.entry.publish(self.map_id, sizes, integrity=rec)
            self.integrity = rec
            if self._ledger is not None:
                self._ledger.record_commit(self.entry, self.map_id, sizes,
                                           rec)
        self._committed = True
        log.debug("map %d publish: %.2f ms (%d rows)", self.map_id, t.ms,
                  0 if keys is None else keys.shape[0])
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

    @classmethod
    def recovered(cls, entry: ShuffleEntry, map_id: int,
                  pool: HostStagingPool, directory: str, rec,
                  partitioner: str = "hash", bounds=None,
                  integrity_level: str = "staged",
                  metrics=None) -> "MapOutputWriter":
        """A committed writer over one map output the durable ledger's
        restart scan validated: its staged state is the sealed file set
        in ``directory``, which reads pack from through the mapped views
        (no recompute). ``rec`` is the manifest's record."""
        w = cls(entry, map_id, pool, partitioner, bounds,
                spill_dir=directory, metrics=metrics,
                integrity_level=integrity_level)
        w._durable = True                # release() keeps the files
        if rec.rows:
            w._spill = SpillFiles.open_sealed(directory, entry.shuffle_id,
                                              map_id)
        if rec.val_dtype is not None:
            w._val_tail = tuple(rec.val_tail or ())
            w._val_dtype = np.dtype(rec.val_dtype)
        w.integrity = rec
        w._committed = True
        return w

    def materialize(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Concatenated (keys, values) staged by this writer. Once it
        spilled, what is still staged moves to the files, the files are
        sealed, and the result is the read-only mapped views (cached):
        the pack reads them without a copy of the whole output first."""
        if self._spill is not None:
            if self._keys or self._spill_views is None:
                if self._keys:
                    self._flush_to_disk()
                self._spill.finish(self._val_tail, self._val_dtype)
                self._spill_views = self._spill.load()
            return self._spill_views
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
        """Return the staging buffers to the pool and delete the spill
        files; the writer is dead afterwards. Idempotent. A durable
        writer's files stay on disk (only its mappings close): deleting
        them is ``ShuffleLedger.forget``'s job."""
        self._released = True
        self._keys.clear()
        self._values.clear()
        self._return_staged()
        self._staged_bytes = 0
        if self._spill is not None:
            self._spill_views = None
            self._spill.close(delete=not self._durable)
            self._spill = None
