"""The per-process runtime: device, metrics, shuffle registry, the host
staging pool and the failure plane.

A :class:`Node` is an object the caller creates and passes (no process
singleton). It owns the device every shuffle of its manager runs on, the
number of logical shards ``P`` the exchange splits that device into and
their grid (``parallel/mesh.SliceGrid``: ``[S, P/S]`` when
``mesh.numSlices`` = S > 1) — the role the JAX package's mesh plays.

Distributed (``Node.start(..., distributed=True, process_id=i)`` with
``numProcesses`` = N > 1, :attr:`Node.is_distributed`): the node joins
the rendezvous at ``coordinator.address`` (``torch.distributed`` over
gloo; a failure raises the classified ``RENDEZVOUS FAILED`` error), owns
the contiguous block :attr:`Node.local_shard_ids` of the P global shards,
and runs its collectives on a gloo group whose own timeout is the fence
(``failure.collectiveTimeoutMs`` and the tier deadlines), installed for
``shuffle/distributed.py``, and, under ``failure.policy=replay``, a
second group of its own for the distributed replay's ``replay.enter``
rounds (:attr:`Node.replay_group`; None under ``failfast``).
Every node carries the failure plane
(``runtime/failures.py``), built in this order: the flight recorder
(:attr:`Node.flight`; the null recorder unless ``flightRecorder.enabled``,
else it records every metric of the node and dumps on an unhandled
exception until :meth:`Node.close`), the fault injector
(:attr:`Node.faults`, armed from ``fault.*``), the retry policy
(:attr:`Node.retry_policy`), the
:class:`~sparkucx_tpu_torch.runtime.failures.HealthMonitor` probe of its
device, the process-global watchdog (``runtime/watchdog.py``) and the
:class:`~sparkucx_tpu_torch.runtime.failures.EpochManager` whose bump
resets the agreement sequence and lands in the recorder's ring;
:meth:`Node.remesh` bumps it.

The telemetry plane rides the node too: the process tracer
(:attr:`Node.tracer`, ``utils/trace.py``, set from ``trace.*``; the
flight recorder turns it on), the windowed history
(:attr:`Node.history`, ``utils/history.py``: ``history.*``, rolled by
the service's dumper), the decision ledger (:attr:`Node.decisions`,
``shuffle/decisions.py``: ``decisions.*``, installed for ``agree``; its
JSONL beside the history log under ``history.dir``), the device-memory
sampler (:attr:`Node.devmon`, ``runtime/devmon.py``: ``devmon.*``), and
the clock anchors of every process (:attr:`Node.cluster_anchors`,
gathered at start on a distributed node). :meth:`Node.
telemetry_snapshot` is the one snapshot document every consumer reads
(``service.stats``, the dumps)."""

from __future__ import annotations

import datetime
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from sparkucx_tpu_torch.backend import resolve_device
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.meta.registry import ShuffleRegistry
from sparkucx_tpu_torch.parallel.mesh import (local_shard_ids,
                                              make_shuffle_grid)
from sparkucx_tpu_torch.runtime.failures import (NULL_FLIGHT_RECORDER,
                                                 DeviceUnhealthy,
                                                 EpochManager, FaultInjector,
                                                 FlightRecorder,
                                                 HealthMonitor, RetryPolicy)
from sparkucx_tpu_torch.runtime.watchdog import (configure_from_conf,
                                                 current_watchdog,
                                                 set_global_watchdog)
from sparkucx_tpu_torch.runtime.devmon import NULL_DEVMON, DeviceMonitor
from sparkucx_tpu_torch.shuffle import agreement, distributed
from sparkucx_tpu_torch.shuffle.decisions import (NULL_DECISION_LEDGER,
                                                  DecisionLedger,
                                                  current_ledger, set_ledger)
from sparkucx_tpu_torch.utils.export import collect_snapshot
from sparkucx_tpu_torch.utils.history import TelemetryHistory
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import Metrics
from sparkucx_tpu_torch.utils.trace import configure_from_conf \
    as configure_tracer

log = get_logger("runtime.node")

# the reference read runs on an 8-device mesh; the port's default shard
# count matches so one conf and one dataset drive both packages alike
DEFAULT_SHARDS = 8


def _empty_host_cache() -> None:
    """Hand torch's cached page-locked blocks that nothing uses back to
    the CUDA runtime (torch keeps every freed pinned block for reuse)."""
    fn = getattr(torch.accelerator, "empty_host_cache", None) \
        or torch._C._host_emptyCache
    fn()


def _round_pow2(v: int) -> int:
    r = 1
    while r < v:
        r <<= 1
    return r


class HostStagingPool:
    """Reusable host byte buffers for map-side staging and the pack
    stage. On a CUDA node the buffers are page-locked
    (``pin_memory=True``; ``memory.pinned=false`` turns that off), so the
    staged rows reach the device in one DMA with no pageable bounce;
    pinning is slow to allocate, so freed buffers are kept and handed out
    again, up to ``max_free_bytes``: a ``put`` past it drops the
    longest-free buffers and, on a CUDA node, empties torch's cache of
    unused pinned blocks, so a process keeps no more than that of an
    earlier, larger job's staging.

    Sizes (the JAX package's ``runtime/memory.HostMemoryPool`` keys,
    without its size-class arena): a request below ``memory.
    minBufferSize`` (rounded up to a power of two, :attr:`min_block`)
    gets that much; :meth:`preallocate` takes ``count`` buffers of a
    size up front (the node does it at start for each entry of
    ``memory.preAllocateBuffers``), carving buffers smaller than
    ``memory.minAllocationSize`` (:attr:`slab_size`) out of shared slabs
    of that size, so small buffers share one pinned allocation.

    Byte accounting at the ``get``/``put`` seam, as the JAX package's
    pool keeps it: ``stats()["in_use_bytes"]`` is the summed ``numel()``
    of the buffers checked out now (a reused buffer may be up to twice
    the request, and counts whole), ``peak_bytes`` its high-water mark
    since the last :meth:`reset_peak_bytes`; ``requests``,
    ``allocated`` (fresh buffers, preallocated ones included) and
    ``preallocated`` count buffers. A second ``put`` of one buffer
    raises and moves no count."""

    # a 1 GB shuffle's staging plus its pack buffer come to about 2.4 GB:
    # jobs of that size one after another keep reusing their blocks
    max_free_bytes = 4 << 30

    def __init__(self, pinned: bool, conf: Optional[ShuffleConf] = None):
        conf = conf or ShuffleConf(use_env=False)
        self.pinned = pinned and conf.pinned_memory
        self.min_block = _round_pow2(conf.min_buffer_size)
        self.slab_size = conf.min_allocation_size
        self._free: List[torch.Tensor] = []     # longest free first
        self._free_bytes = 0
        self._out: Dict[int, torch.Tensor] = {}   # id -> checked-out buffer
        self._in_use_bytes = 0
        self._peak_bytes = 0
        self._counts = {"requests": 0, "allocated": 0, "preallocated": 0}
        self._lock = threading.Lock()

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pinned)

    def get(self, nbytes: int) -> torch.Tensor:
        """A uint8 buffer of at least ``max(nbytes, min_block)`` (at most
        twice that when a free one is reused)."""
        nbytes = max(int(nbytes), self.min_block)
        with self._lock:
            self._counts["requests"] += 1
            fits = [i for i, b in enumerate(self._free)
                    if nbytes <= b.numel() <= 2 * nbytes]
            buf = self._free.pop(min(
                fits, key=lambda i: self._free[i].numel())) if fits else None
            if buf is not None:
                self._free_bytes -= buf.numel()
        if buf is None:
            buf = self._alloc(nbytes)
            with self._lock:
                self._counts["allocated"] += 1
        with self._lock:
            self._out[id(buf)] = buf
            self._in_use_bytes += buf.numel()
            self._peak_bytes = max(self._peak_bytes, self._in_use_bytes)
        return buf

    def preallocate(self, size: int, count: int) -> None:
        """Take ``count`` free buffers of ``max(size, min_block)`` bytes
        now, so the first ``get`` calls of that size pin nothing."""
        size = max(int(size), self.min_block)
        per_slab = self.slab_size // size if size < self.slab_size else 1
        bufs: List[torch.Tensor] = []
        while len(bufs) < count:
            n = min(per_slab, count - len(bufs))
            if n > 1:
                slab = self._alloc(n * size)
                bufs.extend(slab[i * size:(i + 1) * size] for i in range(n))
            else:
                bufs.append(self._alloc(size))
        with self._lock:
            self._free.extend(bufs)
            self._free_bytes += size * len(bufs)
            self._counts["allocated"] += len(bufs)
            self._counts["preallocated"] += len(bufs)

    def put(self, buf: torch.Tensor) -> None:
        with self._lock:
            if self._out.pop(id(buf), None) is None:
                raise ValueError("pool.put of a buffer that is not checked "
                                 "out (a second put of one buffer?)")
            self._in_use_bytes -= buf.numel()
            self._free.append(buf)
            self._free_bytes += buf.numel()
            dropped = 0
            while self._free_bytes > self.max_free_bytes:
                self._free_bytes -= self._free.pop(0).numel()
                dropped += 1
        if dropped and self.pinned:
            _empty_host_cache()

    def stats(self) -> Dict[str, int]:
        """{'requests', 'allocated', 'preallocated', 'in_use',
        'in_use_bytes', 'peak_bytes', 'free', 'free_bytes'}: buffer
        counts, buffers and bytes checked out, the high-water mark of the
        bytes, and the buffers and bytes kept for reuse."""
        with self._lock:
            return {**self._counts,
                    "in_use": len(self._out),
                    "in_use_bytes": self._in_use_bytes,
                    "peak_bytes": self._peak_bytes,
                    "free": len(self._free),
                    "free_bytes": self._free_bytes}

    def reset_peak_bytes(self) -> int:
        """Reset the high-water mark to the bytes in use now; returns the
        prior peak (one measurement window per call)."""
        with self._lock:
            prior = self._peak_bytes
            self._peak_bytes = self._in_use_bytes
        return prior

    def close(self) -> None:
        with self._lock:
            if self._out:
                log.warning("closing the staging pool with %d buffers "
                            "(%d B) checked out", len(self._out),
                            self._in_use_bytes)
            self._free.clear()
            self._free_bytes = 0


class MappedFile:
    """A read-only ``np.memmap`` of a file as uint8 (``.data``); the
    spill files map their sealed columns back through it. (The JAX
    package maps through its native library when it is built; the port
    keeps numpy's mapping only.)"""

    def __init__(self, path: str):
        self.path = path
        self.data = np.memmap(path, dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return self.data.size

    def close(self) -> None:
        """Drop this mapping; it unmaps once no view of it is left."""
        self.data = None


class Node:
    """Device + metrics + registry + staging pool + failure plane for one
    process (and, distributed, its place in the cluster)."""

    def __init__(self, conf: Optional[ShuffleConf] = None, device=None,
                 num_shards: int = DEFAULT_SHARDS, distributed: bool = False,
                 process_id: int = 0):
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        self.conf = conf or ShuffleConf()
        self.device = resolve_device(device)
        self.num_shards = int(num_shards)
        self.process_id = int(process_id)
        self.is_distributed = bool(distributed) \
            and self.conf.num_processes > 1
        self.group = None
        self.replay_group = None
        self._owns_world = False
        self._prev_group = None
        if self.is_distributed:
            # a shard count the processes cannot split fails before the
            # rendezvous, on every process alike
            local_shard_ids(self.num_shards, self.conf.num_processes,
                            self.process_id)
            self._rendezvous()
        self.grid = make_shuffle_grid(self.num_shards, self.conf)
        self.metrics = Metrics()
        self.registry = ShuffleRegistry()
        self.pool = HostStagingPool(pinned=self.device.type == "cuda",
                                    conf=self.conf)
        for size, count in self.conf.pre_allocate_buffers.items():
            self.pool.preallocate(size, count)
        self.tracer = configure_tracer(self.conf)
        # the recorder first: the failure plane below records into it
        if self.conf.get_bool("flightRecorder.enabled", False):
            self.flight = FlightRecorder(self.conf)
            self.flight.metrics_sources.append(self.metrics)
            self.metrics.add_reporter(self.flight.metrics_reporter)
            # a postmortem without a timeline answers nothing
            self.tracer.enabled = True
            self.flight.install_abort_hook()
        else:
            self.flight = NULL_FLIGHT_RECORDER
        self.faults = FaultInjector(self.conf, flight=self.flight)
        self.retry_policy = RetryPolicy.from_conf(
            self.conf, metrics=self.metrics, flight=self.flight)
        self.health = HealthMonitor(self.device,
                                    timeout_ms=self.conf.connection_timeout_ms,
                                    flight=self.flight)
        self.watchdog = configure_from_conf(self.conf, health=self.health,
                                            metrics=self.metrics)
        self.epochs = EpochManager()
        # a process that missed a remesh diverges typed in the next
        # agreement round's header
        agreement.reset_epoch(self.epochs.current)
        self.epochs.on_bump(agreement.reset_epoch)
        self.epochs.on_bump(self.flight.on_epoch_bump)
        # every process's clock anchor (a collective on a distributed
        # node: every process builds its node in lockstep)
        self.cluster_anchors = self._gather_anchors()
        c = self.conf
        self.history = TelemetryHistory(
            self._history_collect, window_secs=c.history_window_secs,
            retain_windows=c.history_retain_windows, out_dir=c.history_dir,
            process_id=self.process_id)
        if c.decisions_enabled:
            self.decisions = DecisionLedger(retain=c.decisions_retain,
                                            out_dir=c.history_dir,
                                            process_id=self.process_id)
        else:
            self.decisions = NULL_DECISION_LEDGER
        set_ledger(self.decisions)
        self.flight.add_context_provider(self.decision_ledger)
        self.devmon = DeviceMonitor(
            self, interval_s=c.devmon_interval_ms / 1e3).start() \
            if c.devmon_enabled else NULL_DEVMON
        self._closed = False

    def _rendezvous(self) -> None:
        """Join the world at ``coordinator.address`` (or the world this
        process already joined) and make this node's collective group,
        whose timeout is the fence so gloo never waits past it."""
        import torch.distributed as dist
        c = self.conf
        t0 = time.monotonic()
        try:
            if dist.is_initialized():
                if (dist.get_world_size(), dist.get_rank()) != \
                        (c.num_processes, self.process_id):
                    raise RuntimeError(
                        f"this process already joined a world of "
                        f"{dist.get_world_size()} as rank "
                        f"{dist.get_rank()}")
            else:
                dist.init_process_group(
                    "gloo", init_method=f"tcp://{c.coordinator_address}",
                    world_size=c.num_processes, rank=self.process_id,
                    timeout=datetime.timedelta(
                        milliseconds=c.connection_timeout_ms))
                self._owns_world = True
            fence = max(c.collective_timeout_ms, c.ici_timeout_ms,
                        c.dcn_timeout_ms)
            self.group = dist.new_group(
                backend="gloo",
                timeout=datetime.timedelta(milliseconds=fence)
                if fence > 0 else None)
            # replay.enter rounds ride a group of their own: a peer that
            # never enters one (its read did not fail) may be inside a
            # collective of the first group, and the two must not match
            # each other's messages; only a node under the replay policy
            # makes it
            if c.failure_policy == "replay":
                enter = c.replay_agree_timeout_ms or fence
                self.replay_group = dist.new_group(
                    backend="gloo",
                    timeout=datetime.timedelta(milliseconds=enter)
                    if enter > 0 else None)
        except Exception as e:
            # classified, so a launcher retries this failure alone
            log.error("RENDEZVOUS FAILED after %.1fs: coordinator=%s "
                      "process %d/%d: %r", time.monotonic() - t0,
                      c.coordinator_address, self.process_id,
                      c.num_processes, e)
            raise RuntimeError(
                f"RENDEZVOUS FAILED after {time.monotonic() - t0:.1f}s "
                f"(coordinator {c.coordinator_address}, process "
                f"{self.process_id}/{c.num_processes}): {e!r}") from e
        self._prev_group = distributed.set_group(self.group)
        log.info("distributed up: process %d/%d via %s in %.2fs",
                 self.process_id, c.num_processes, c.coordinator_address,
                 time.monotonic() - t0)

    @classmethod
    def start(cls, conf: Optional[ShuffleConf] = None, device=None,
              num_shards: int = DEFAULT_SHARDS, distributed: bool = False,
              process_id: int = 0) -> "Node":
        """Bring up a node on ``device`` (default: the CUDA device; raises
        without one unless ``device="cpu"``); ``distributed=True`` joins
        the cluster as process ``process_id`` when ``numProcesses`` > 1."""
        return cls(conf, device=device, num_shards=num_shards,
                   distributed=distributed, process_id=process_id)

    @property
    def num_processes(self) -> int:
        return self.conf.num_processes if self.is_distributed else 1

    @property
    def local_shard_ids(self) -> List[int]:
        """Global ids of the shards this process owns (all of them on a
        single-process node), in grid order."""
        if not self.is_distributed:
            return list(range(self.num_shards))
        return local_shard_ids(self.num_shards, self.conf.num_processes,
                               self.process_id)

    def remesh(self, shards: Union[None, int, Sequence[int]] = None,
               reason: str = "") -> int:
        """Rebuild the shard grid over ``shards`` (a count or the agreed
        surviving shard ids; default: all, after a device probe) and bump
        the epoch: the registry is dropped, and every handle pinned to the
        old epoch raises ``StaleEpochError`` instead of entering a
        collective. Distributed, the survivor list must be given: probe
        verdicts are process-local and can diverge. The process group is
        not rebuilt; recovery re-runs on a fresh world. Returns the new
        epoch."""
        if shards is None:
            if self.is_distributed:
                raise RuntimeError(
                    "distributed remesh requires an explicitly agreed "
                    "device list; probe verdicts are process-local and can "
                    "diverge. Re-bootstrap with the surviving processes "
                    "and pass shards=.")
            bad = [d for d, ok in self.health.probe().items() if not ok]
            if bad:
                raise DeviceUnhealthy(
                    f"remesh: devices failed liveness probe: {bad}")
            shards = self.num_shards
        n = int(shards) if isinstance(shards, int) else len(list(shards))
        if n <= 0:
            raise RuntimeError("remesh with zero surviving devices")
        self.grid = make_shuffle_grid(n, self.conf)
        self.num_shards = n
        self.health = HealthMonitor(self.device,
                                    timeout_ms=self.conf.connection_timeout_ms,
                                    flight=self.flight)
        # the watchdog probes through the current monitor
        self.watchdog.health = self.health
        self.registry.clear()
        epoch = self.epochs.bump(reason or "remesh")
        log.warning("remesh: %d shards, epoch %d (%s)", n, epoch,
                    reason or "requested")
        return epoch

    def _gather_anchors(self) -> list:
        if self.is_distributed:
            return distributed.gather_clock_anchors(self.tracer,
                                                    self.process_id)
        a = self.tracer.anchor()
        a["process_id"] = self.process_id
        return [a]

    def telemetry_snapshot(self, reports: Optional[list] = None,
                           include_history: bool = True) -> dict:
        """The snapshot document of this process (``utils/export.
        collect_snapshot``): counters, gauges (the pool's watermarks
        among them) and histograms of the node's metrics, the tracer's
        span summary, events and fresh clock anchor, plus ``pool``,
        ``process_id``, ``cluster_anchors``, ``anchors`` (this process's
        start anchor) and ``anchor_skew_s`` (the wall clock's drift
        since), the retained ``history_frames`` (``include_history``)
        and the decision ledger's tail (``decisions``). ``reports``: the
        manager's exchange reports, when the caller has a manager."""
        pool_stats = self.pool.stats()
        self.publish_pool_gauges(pool_stats)
        extra = {"pool": pool_stats, "process_id": self.process_id,
                 "cluster_anchors": self.cluster_anchors}
        boot = next((a for a in self.cluster_anchors
                     if a.get("process_id") == self.process_id
                     and "wall_epoch" in a), None)
        if boot is not None:
            extra["anchors"] = [dict(boot)]
            extra["anchor_skew_s"] = round(
                self.tracer.anchor()["wall_epoch"]
                - float(boot["wall_epoch"]), 6)
        if include_history:
            frames = self.history.frames()
            if frames:
                extra["history_frames"] = frames
        recs = self.decisions.tail()
        if recs:
            extra["decisions"] = recs
        return collect_snapshot(self.metrics, tracer=self.tracer,
                                reports=reports, extra=extra)

    def _history_collect(self) -> dict:
        """The history plane's lean snapshot: counters, populated
        histograms, gauges and the anchor (no span summary or events:
        a window delta reads neither)."""
        self.publish_pool_gauges()
        return collect_snapshot(self.metrics, populated_only=True,
                                extra={"process_id": self.process_id})

    def decision_ledger(self) -> dict:
        """The decision plane's postmortem face (a flight context
        provider, keyed ``decision_ledger``): the last-decision position
        and the retained tail."""
        led = self.decisions
        return {"enabled": bool(led.enabled), "total": int(led.total),
                "path": led.path, "position": led.position(),
                "decisions": led.tail()}

    def publish_pool_gauges(self, stats: Optional[dict] = None) -> None:
        """The staging pool's watermarks as ``pool.*`` gauges (they go
        down, so they are gauges, not counters)."""
        st = stats if stats is not None else self.pool.stats()
        for key in ("in_use", "in_use_bytes", "peak_bytes", "allocated",
                    "preallocated"):
            if key in st:
                self.metrics.set_gauge(f"pool.{key}", st[key])

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # the sampler first: it reads the pool and metrics dropped below
        self.devmon.stop()
        self.flight.remove_context_provider(self.decision_ledger)
        if current_ledger() is self.decisions:
            set_ledger(NULL_DECISION_LEDGER)
        self.decisions.close()
        self.epochs.remove_listener(agreement.reset_epoch)
        self.epochs.remove_listener(self.flight.on_epoch_bump)
        self.flight.uninstall_abort_hook()
        if current_watchdog() is self.watchdog:
            set_global_watchdog(None)
        self.registry.clear()
        self.pool.close()
        if self.group is not None:
            import torch.distributed as dist
            distributed.set_group(self._prev_group)
            try:
                if self._owns_world:
                    dist.destroy_process_group()
                else:
                    dist.destroy_process_group(self.group)
                    if self.replay_group is not None:
                        dist.destroy_process_group(self.replay_group)
            except Exception as e:     # a world with a dead member
                log.info("process group teardown: %s", e)
            self.group = self.replay_group = None
