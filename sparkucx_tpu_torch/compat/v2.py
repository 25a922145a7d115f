"""The v2 host-engine adapter — a drifted facade contract over the same
stack (see ``compat/__init__``), the JAX package's ``compat/v2.py`` with
the port's node and manager underneath.

Contract differences from v1 (``service.ShuffleService``):

- ``register(dep)``: one :class:`ShuffleDependency` descriptor instead of
  positional arguments; the shuffle id lives in the descriptor.
- ``writer(handle, map_id, attempt_id)``: attempts are explicit. A retry
  attempt for a committed map output raises (first-commit-wins, the
  manager's rule); a retry of an uncommitted attempt supersedes it.
- ``reader(handle, start, end)``: reads return a :class:`PartitionReader`
  scoped to [start, end); every reader of a shuffle shares its one
  exchange.

No data-plane logic here: the facade wraps a v1 ``ShuffleService`` built
from the same arguments, which owns the node, the manager, the async
plane, the telemetry and the teardown; v2 adds only the dependencies, the
attempts and the shared per-shuffle result.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.runtime.node import DEFAULT_SHARDS
from sparkucx_tpu_torch.service import ShuffleService
from sparkucx_tpu_torch.shuffle.manager import ShuffleHandle, ShuffleManager
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import H_FETCH_WAIT

log = get_logger("compat.v2")


@dataclass(frozen=True)
class ShuffleDependency:
    """Registration descriptor of the v2 contract: the shape, the
    partitioner and the read options travel with the shuffle."""
    shuffle_id: int
    num_maps: int
    num_partitions: int
    partitioner: str = "hash"
    bounds: Optional[Tuple[int, ...]] = None
    # read-side defaults carried WITH the shuffle: the dependency declares
    # its aggregator, reads just execute it
    combine: Optional[str] = None
    combine_sum_words: int = 0
    ordered: bool = False
    # the tenant the shuffle registers under (None = the conf's tenant.id)
    tenant: Optional[str] = None


class MapWriterV2:
    """One (map_id, attempt_id) writer lease: ``write`` stages batches,
    ``commit`` publishes."""

    def __init__(self, mgr: ShuffleManager, handle: ShuffleHandle,
                 map_id: int, attempt_id: int):
        self._mgr = mgr
        self._handle = handle
        self.map_id = map_id
        self.attempt_id = attempt_id
        self._w = mgr.get_writer(handle, map_id)

    def write(self, keys, values: Optional[np.ndarray] = None) -> None:
        self._w.write(np.asarray(keys), values)

    def commit(self) -> None:
        self._w.commit(self._handle.num_partitions)

    @property
    def committed(self) -> bool:
        return self._w.committed


class PartitionReader:
    """Reader scoped to partitions [start, end) of one shuffle. The whole
    reduce side is still ONE exchange underneath, shared by every reader
    of the shuffle through the service's per-shuffle result cache: N
    range readers run one exchange, not N."""

    def __init__(self, svc: "ShuffleServiceV2", handle: ShuffleHandle,
                 start: int, end: int, dep: ShuffleDependency,
                 timeout: Optional[float]):
        self._svc = svc
        self._handle = handle
        self.start, self.end = start, end
        self._dep = dep
        self._timeout = timeout

    def _result(self):
        return self._svc._shared_result(self._handle, self._dep,
                                        self._timeout)

    def __iter__(self) -> Iterator[Tuple[int, tuple]]:
        res = self._result()
        for r in range(self.start, self.end):
            if res.is_local(r):
                yield r, res.partition(r)

    def batch(self) -> dict:
        """All partitions in range as {r: (keys, values)}."""
        return dict(iter(self))


class ShuffleServiceV2:
    """The v2 facade. Same constructor as v1, so ``connect()`` selects
    either class from the conf alone (``compat/__init__``)."""

    def __init__(self, conf: ShuffleConf, device=None,
                 num_shards: int = DEFAULT_SHARDS, distributed: bool = False,
                 process_id: int = 0, metrics_reporter=None):
        self.conf = conf
        # the v2 contract carries raw int rows; a configured codec the
        # adapter would silently drop is refused at connect time
        self.io_format = (conf.get("spark.shuffle.tpu.io.format") or "raw") \
            .strip().lower()
        if self.io_format != "raw":
            raise ValueError(
                f"compat v2 adapter supports io.format=raw only, got "
                f"{self.io_format!r}; use compat.version=v1 for arrow")
        self._v1 = ShuffleService(conf, device=device,
                                  num_shards=num_shards,
                                  distributed=distributed,
                                  process_id=process_id,
                                  metrics_reporter=metrics_reporter)
        self.node = self._v1.node
        self.manager = self._v1.manager
        self._deps: dict = {}
        self._attempts: dict = {}      # (sid, map_id) -> attempt_id
        # shuffle_id -> result, shared by every PartitionReader of that
        # shuffle (one exchange per shuffle); dropped by unregister. The
        # read lock is PER SHUFFLE (minted under _results_guard): racing
        # readers of one shuffle serialize on it, other shuffles do not
        self._results: dict = {}
        self._read_locks: dict = {}
        self._results_guard = threading.Lock()
        # serializes writer()'s check-and-lease
        self._lease_lock = threading.Lock()
        # v1's telemetry, doctor, SLO, report and teardown serve v2 as is
        self.stats = self._v1.stats
        self.doctor = self._v1.doctor
        self.slo = self._v1.slo
        self.report = self._v1.report
        self.stop = self.close = self._v1.stop
        log.info("ShuffleServiceV2 up: %d shards on %s",
                 self.node.num_shards, self.node.device)

    @property
    def device(self):
        return self.node.device

    # -- lifecycle ---------------------------------------------------------
    def register(self, dep: ShuffleDependency) -> ShuffleHandle:
        h = self.manager.register_shuffle(
            dep.shuffle_id, dep.num_maps, dep.num_partitions,
            dep.partitioner, bounds=dep.bounds, tenant=dep.tenant)
        with self._results_guard:
            self._deps[dep.shuffle_id] = dep
        return h

    def recovered_shuffles(self):
        """The shuffles the durable ledger recovered at connect that
        await adoption by :meth:`register`: writers are re-leased only
        for the quarantined map ids; a lease for an intact map is
        rejected first-commit-wins."""
        return self.manager.recovered_shuffles()

    def unregister(self, shuffle_id: int) -> None:
        self.manager.unregister_shuffle(shuffle_id)
        # deps and read state drop under ONE guard, so a racing
        # _shared_result never sees the dep live and then mints a lock
        # after this pop
        with self._results_guard:
            self._deps.pop(shuffle_id, None)
            self._results.pop(shuffle_id, None)
            self._read_locks.pop(shuffle_id, None)
        # under the lease lock: a concurrent writer()'s watermark must
        # not be dropped by this rebuild
        with self._lease_lock:
            for k in [k for k in self._attempts if k[0] == shuffle_id]:
                del self._attempts[k]

    def _shared_result(self, handle: ShuffleHandle,
                       dep: ShuffleDependency,
                       timeout: Optional[float]):
        """ONE exchange per shuffle, shared by all its PartitionReaders.
        The per-shuffle lock covers the read: a second reader of the
        same shuffle arriving mid-exchange waits and reuses the cached
        result. Read options come from the dependency, so every reader
        runs the same read. The reader that dispatches applies its
        timeout; later readers inherit that outcome.

        A cached reader records its own wait (the lock wait plus the
        lookup) in ``shuffle.read.wait_ms``, as every port read does: the
        port compiles nothing per shape, so no wait lands in the
        reference's compile-bearing ``first_wait_ms``."""
        sid = handle.shuffle_id
        t0 = time.perf_counter()
        with self._results_guard:
            if sid not in self._deps:
                raise KeyError(
                    f"shuffle {sid} is no longer registered through "
                    f"this adapter")
            lock = self._read_locks.setdefault(sid, threading.Lock())
        with lock:
            with self._results_guard:
                res = self._results.get(sid)
            if res is None:
                # host sink: N range readers consume the result through
                # the numpy partition contract (read_device is the
                # zero-D2H path)
                res = self.manager.read(
                    handle, timeout=timeout,
                    combine=dep.combine, ordered=dep.ordered,
                    combine_sum_words=dep.combine_sum_words,
                    sink="host")
                with self._results_guard:
                    # cache only if OUR lock still maps this sid: an
                    # unregister that raced this read popped it
                    if self._read_locks.get(sid) is lock:
                        self._results[sid] = res
            else:
                self.node.metrics.observe(
                    H_FETCH_WAIT, (time.perf_counter() - t0) * 1e3)
                self.node.metrics.inc("shuffle.read.cached.count", 1)
            return res

    def __enter__(self) -> "ShuffleServiceV2":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- map side ----------------------------------------------------------
    def writer(self, handle: ShuffleHandle, map_id: int,
               attempt_id: int = 0) -> MapWriterV2:
        """Writer lease for one map ATTEMPT. First-commit-wins across
        attempts (the manager enforces it); an attempt id lower than one
        already seen is rejected up front, and so is a second lease of
        the live attempt (its supersede would drop the first lease's
        staged rows). The check-and-lease is atomic under
        ``_lease_lock``."""
        key = (handle.shuffle_id, map_id)
        with self._lease_lock:
            seen = self._attempts.get(key)
            if seen is not None and attempt_id < seen:
                raise RuntimeError(
                    f"stale attempt {attempt_id} for shuffle "
                    f"{handle.shuffle_id} map {map_id}: attempt {seen} "
                    f"already ran")
            if seen is not None and attempt_id == seen and \
                    self.manager.has_live_writer(handle.shuffle_id, map_id):
                raise RuntimeError(
                    f"attempt {attempt_id} for shuffle "
                    f"{handle.shuffle_id} map {map_id} already holds the "
                    f"live writer lease; use attempt {seen + 1} to "
                    f"supersede it")
            # lease FIRST: a rejected lease (committed map, bad map_id)
            # must not advance the watermark
            w = MapWriterV2(self.manager, handle, map_id, attempt_id)
            self._attempts[key] = attempt_id
            return w

    # -- reduce side -------------------------------------------------------
    def _dep(self, handle: ShuffleHandle) -> ShuffleDependency:
        dep = self._deps.get(handle.shuffle_id)
        if dep is None:
            raise KeyError(f"shuffle {handle.shuffle_id} not registered "
                           f"through this adapter")
        return dep

    def read_device(self, handle: ShuffleHandle,
                    timeout: Optional[float] = None):
        """Device-resident read (``read.sink=device``): a
        ``DeviceShuffleReaderResult`` whose ``consume()`` hands the device
        tensors to a consumer with no D2H. Single-consumer, so not
        cached or shared like :meth:`reader`. The dependency's combine /
        ordered options run on the device."""
        dep = self._dep(handle)
        # the demotions that are manager facts fail before the exchange
        reason = None
        if self.manager.conf.read_sink == "host":
            reason = "conf read.sink=host pins the drain"
        elif self.manager.node.is_distributed:
            reason = "distributed reads force-materialize host-side"
        if reason is not None:
            raise RuntimeError(
                f"read_device on shuffle {handle.shuffle_id}: this "
                f"read would resolve to the host sink ({reason}) — "
                f"use reader() here, or lift the conf pin")
        res = self.manager.read(handle, timeout=timeout,
                                combine=dep.combine, ordered=dep.ordered,
                                combine_sum_words=dep.combine_sum_words,
                                sink="device")
        if getattr(res, "sink", "host") != "device":
            raise RuntimeError(
                f"read_device on shuffle {handle.shuffle_id}: the "
                f"manager resolved this read to the host sink (conf "
                f"read.sink=host pin, distributed, or waved "
                f"hierarchical read — see the warn-once log) — use "
                f"reader() here, or lift the conf pin")
        return res

    # -- async shuffle lifecycle (shuffle/tenancy.py) ----------------------
    def read_async(self, handle: ShuffleHandle, start: int = 0,
                   end: Optional[int] = None,
                   timeout: Optional[float] = None):
        """:meth:`reader` resolved on the async plane: a ``ShuffleFuture``
        of the range's ``batch()`` dict once the shuffle's one shared
        exchange is done. Per-tenant in-flight caps apply at submit."""
        rd = self.reader(handle, start, end, timeout=timeout)
        return self._v1._async.submit(rd.batch, handle.tenant,
                                      handle.shuffle_id, timeout=timeout)

    def submit_async(self, handle: ShuffleHandle,
                     timeout: Optional[float] = None):
        """Whole-shuffle async read: a future of the shared result."""
        dep = self._dep(handle)

        def run():
            return self._shared_result(handle, dep, timeout)
        return self._v1._async.submit(run, handle.tenant,
                                      handle.shuffle_id, timeout=timeout)

    def reader(self, handle: ShuffleHandle, start: int = 0,
               end: Optional[int] = None,
               timeout: Optional[float] = None) -> PartitionReader:
        end = handle.num_partitions if end is None else end
        if not (0 <= start <= end <= handle.num_partitions):
            raise IndexError(
                f"partition range [{start}, {end}) out of "
                f"[0, {handle.num_partitions}]")
        return PartitionReader(self, handle, start, end, self._dep(handle),
                               timeout)
