"""The shuffle manager — register / write / read / report for one node.

Single-process reads (plain, ``combine="sum"``, ``ordered=True``):
committed map outputs are assigned to the P
logical shards round-robin by map id (``map_id % P``), packed into one
page-locked ``[P, cap_in, W]`` int32 buffer, copied to the device in one
transfer and exchanged by :mod:`sparkucx_tpu_torch.shuffle.reader`. A
receive-capacity overflow regrows the plan inside ``result()``; the
manager remembers the skew factor that worked per shuffle shape
(:meth:`ShuffleManager._apply_cap_hint`), so the next same-shape read
starts there.

Waved reads (``a2a.waveRows`` > 0, more than one wave, not under the
segment-move kernel): :class:`PendingWaveShuffle` packs wave i+1 while
wave i's exchange runs and wave i-1 drains, with every wave on one plan
(``plan.wave_step_plan``); an overflow regrows and re-runs only that
wave.

Sinks (``read.sink`` / ``read(sink=)``, :meth:`ShuffleManager.
_resolve_sink`): the host sink serves numpy partition views; the device
sink keeps the partitions in device tensors
(``reader.DeviceShuffleReaderResult``), and folds the waves of an ordered
or combine waved read on the device (``reader.device_merge_fold``).

Wire tiers (``a2a.wire``, :meth:`ShuffleManager._resolve_wire`): int8
quantizes float32 value lanes around the exchange, with noise seeded by
the manager's exchange sequence number (each wave and each overflow retry
draws its own); lossless compresses the drained blocks of a waved host
read. The report's ``wire`` names the tier that ran.

Admission (``a2a.maxBytesInFlight``, :meth:`ShuffleManager.
_make_admitter`): each exchange reserves an estimate of the pinned and
device bytes it holds; a submit over the cap is deferred and dispatches
in ``result()`` once earlier exchanges release. A host-sink read
releases when its result settles (waved: when the last wave drained); a
device-sink read holds its reservation until the result is consumed,
closed or drained by ``host_view()``.

Tenancy (``tenant.*``, ``shuffle/tenancy.py``): every shuffle is
registered under a tenant (``register_shuffle(tenant=)``, default
``tenant.id``). Deferred reservations queue in the deficit-round-robin
``FairShareQueue`` across tenants, weighted by priority (FIFO within a
tenant; ``tenant.fairShare=false``: one FIFO), under each tenant's
``maxBytesInFlight`` quota; the tenant's ``replayBudget``,
``integrity.verify`` and ``waveDepth`` override the global keys;
concurrent packs of several tenants split the pack executor by weight
(:meth:`ShuffleManager._pack_share`); the report ring evicts the oldest
report of the tenant that holds the most; reports, read counters,
replay counters and volume counters carry the tenant.

Topology (``a2a.topology``, resolved when the manager binds to its node,
``shuffle/topology.resolve_topology``): on a node with ``mesh.numSlices``
> 1 a read runs the two-tier exchange (``topology.
PendingTieredShuffle``; waved reads one per wave) and its report carries
one entry per tier (``ExchangeReport.tiers``) with the headline wire
bytes the two-hop sum. An explicit ``a2a.impl=pallas`` runs the flat
exchange over all P shards instead (``report.hierarchical`` False), as
the JAX package does; ``auto`` never resolves to it on such a node.

Distributed (a node with ``is_distributed``, ``shuffle/distributed.py``):
``read`` and ``submit`` are collectives. :meth:`ShuffleManager.
_submit_distributed` runs the completeness barrier over the distinct-map
presence bitmap (its timeout bit rides the allgather, so every process
raises together), stages this process's committed maps round-robin over
its LOCAL shards, agrees the value schema and the size row, the wave
count (every read) and the per-wave sizes, and dispatches the flat or
tiered distributed exchange; each process's result is the partial view
of its own shards. An explicit ``a2a.impl=pallas`` raises before any
collective. Handles are pinned to the node's epoch: after a remesh a
stale handle raises ``StaleEpochError`` before any collective.

Failures (``failure.policy``, the node's ``FaultInjector`` and
``RetryPolicy``): the metadata fetch runs under the retry policy (fault
site ``fetch``); fault site ``exchange`` comes before every dispatch
(single-shot, waved, distributed) and ``wave`` before each wave; a fault
there gives the pinned pack buffer and the admission reservation back.
Under ``failfast`` (default) a failure reaches the caller typed. Under
``replay`` the read loop (:meth:`ShuffleManager.read`) re-runs the whole
exchange after a ``TransientError``, up to ``failure.replayBudget`` times
a shuffle (``ExchangeReport.replays`` / ``replay_ms``); on a distributed
node every process must agree to re-enter (a ``replay.enter`` round on
the node's replay group under ``failure.replayAgreeTimeoutMs``), and a
distributed ``PeerLostError`` never replays in place. An epoch bump keeps
the shuffles whose maps are all committed and staged (the recovery
ledger) and re-pins their stale handles on the next read, one budget unit
each; everything else is dropped. Dropped writers' buffers go back to the
pool only once no read that could still copy from them is in flight
(:meth:`ShuffleManager._read_started`, the graveyard).

Integrity (``integrity.verify``, ``shuffle/integrity.py``): at
``staged`` (the default) and ``full`` every map output is re-verified
against the record its commit published before its bytes enter the
exchange (:meth:`ShuffleManager._verified_materialize`, home of the
``corrupt.staged`` / ``corrupt.spill`` fault sites); at ``full`` the
result is verified after the exchange too (:meth:`ShuffleManager.
_verify_full_result`, run inside the pending handle's ``result()``). A
mismatch raises ``BlockCorruptionError`` (a ``TransientError``: under
``replay`` one budget unit re-verifies and re-runs). The report's
``integrity`` names the level that ran and ``integrity_bytes`` what it
verified.

Durability (``failure.ledgerDir``, ``shuffle/durable.py``): commits seal
into the ledger; a manager started on the same directory re-registers
the intact shuffles it finds (:meth:`ShuffleManager.recovered_shuffles`),
and ``register_shuffle`` with the same shape adopts one with zero
recompute (a quarantined map is the only one to stage again).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from sparkucx_tpu_torch.config import (PARTITIONERS, ShuffleConf,
                                       validate_sink)
from sparkucx_tpu_torch.runtime.failures import (BlockCorruptionError,
                                                 PeerLostError,
                                                 StaleEpochError,
                                                 TransientError)
from sparkucx_tpu_torch.meta.registry import ShuffleEntry
from sparkucx_tpu_torch.meta.segments import validate_row_sizes
from sparkucx_tpu_torch.ops.aggregate import check_combinable
from sparkucx_tpu_torch.ops.partition import blocked_partition_map
from sparkucx_tpu_torch.ops.segmented import resolve_kernel_impl
from sparkucx_tpu_torch.runtime.node import Node
from sparkucx_tpu_torch.shuffle.agreement import agree
from sparkucx_tpu_torch.shuffle import integrity as integ
from sparkucx_tpu_torch.shuffle.distributed import (
    agree_wave_count, agree_wave_sizes, allgather_blob, allgather_json,
    allgather_sizes, submit_shuffle_distributed,
    submit_shuffle_tiered_distributed)
from sparkucx_tpu_torch.shuffle.durable import ShuffleLedger
from sparkucx_tpu_torch.shuffle.plan import (ShufflePlan, bucket_cap_conf,
                                             check_bounds, make_plan,
                                             plan_takes_seed, ragged_layout,
                                             wave_count, wave_payload_rows,
                                             wave_step_plan)
from sparkucx_tpu_torch.shuffle.topology import (resolve_topology,
                                                 settle_tier_walls,
                                                 submit_shuffle_tiered,
                                                 tier_layouts, tier_timeouts)
from sparkucx_tpu_torch.shuffle.tenancy import (FairShareQueue,
                                                FifoAdmitQueue,
                                                TenantRegistry)
from sparkucx_tpu_torch.shuffle.reader import (KEY_WORDS,
                                               DeviceShuffleReaderResult,
                                               LazyShuffleReaderResult,
                                               WavedShuffleReaderResult,
                                               device_merge_fold,
                                               drain_wave_result, pack_rows,
                                               submit_shuffle, value_words)
from sparkucx_tpu_torch.shuffle.wire import estimate_dequant_error
from sparkucx_tpu_torch.shuffle.writer import MapOutputWriter
from sparkucx_tpu_torch.shuffle.decisions import current_ledger
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import (
    C_ADMIT_BYTES, C_INTEGRITY_CORRUPT, C_INTEGRITY_CORRUPT_BLOCKS,
    C_INTEGRITY_QUARANTINED, C_INTEGRITY_RECOVERED, C_INTEGRITY_VERIFIED,
    C_KERNEL_FALLBACK, C_PAYLOAD_BYTES, C_REPLAY_MS, C_REPLAYS,
    C_SINK_FALLBACK, C_TIER_BYTES, C_WIRE_BYTES, G_TENANT_INFLIGHT,
    H_ADMIT_CROSS, H_ADMIT_WAIT, H_BW, H_FETCH_WAIT, H_PEER_BYTES,
    H_PEER_ROWS, H_WAVE_GAP, labeled)
from sparkucx_tpu_torch.utils.trace import format_trace_id

log = get_logger("shuffle.manager")


@dataclass
class ExchangeReport:
    """Postmortem of one read: resolved impl, phase times, volume and the
    real-bytes accounting (``payload_bytes`` the real staged bytes,
    ``wire_bytes`` what the transport moved for them, ``pad_ratio`` their
    quotient), refreshed from the final plan after an overflow retry.
    ``rows_local`` / ``bytes_local`` are this process's staged rows and
    bytes (the global figures on one process), ``peer_bytes`` each
    shard's staged bytes. On completion ``bw_gbps`` is the payload over
    ``group_ms`` and ``effective_bw_gbps`` that rate times the int8
    tier's raw/wire row-width gain (equal off that tier)."""

    shuffle_id: int
    num_maps: int
    num_partitions: int
    partitioner: str
    # the cluster-correlation key s<sid>.e<epoch>.x<seq>
    # (utils/trace.format_trace_id): the same exchange in every
    # process's spans, reports and flight events
    trace_id: str = ""
    device: str = ""
    impl: str = ""
    # read.mergeImpl as resolved for a combine or ordered read
    # (plan.kernel_impl), as the JAX package reports it: "pallas" = the
    # CUDA segment-reduce kernel (its plain version on a CPU device),
    # "jnp" = the torch-op formulation. Only a combine read runs a
    # reduce; plain reads say jnp. A pallas ask that reports jnp was
    # gated (the C_KERNEL_FALLBACK counter carries the reason).
    kernel: str = "jnp"
    plan_ms: float = 0.0
    pack_ms: float = 0.0
    dispatch_ms: float = 0.0
    group_ms: float = 0.0
    rows_global: int = 0
    rows_local: int = 0
    bytes_local: int = 0
    payload_bytes: int = 0
    wire_bytes: int = 0
    pad_ratio: float = 0.0
    peer_rows: List[int] = field(default_factory=list)
    peer_bytes: List[int] = field(default_factory=list)
    skew_ratio: float = 0.0
    retries: int = 0
    plan_bucket: List[int] = field(default_factory=list)
    # waved reads (a2a.waveRows): the wave count and size, the real rows
    # each wave moved, and one timeline entry per wave: {wave, rows,
    # pack_start_ms, pack_ms, dispatch_ms, hidden, forced_ms, wait_ms,
    # retries}, times from the read's start. ``hidden`` is measured: the
    # pack finished while the previous wave's exchange was still running
    # on the device (its event not yet reached). 0 / empty = single-shot.
    waves: int = 0
    wave_rows: int = 0
    wave_payload_rows: List[int] = field(default_factory=list)
    wave_pack_hidden_ms: float = 0.0
    wave_timeline: List[Dict] = field(default_factory=list)
    # the RESOLVED sink ("host" | "device"), and the payload bytes this
    # read's result pulled device-to-host so far (a lazy result drains on
    # first touch, so the figure grows after the read; 0 on the device
    # sink until host_view())
    sink: str = "host"
    d2h_bytes: int = 0
    # waved ordered/combine device reads: wall of the device merge fold
    # (reader.device_merge_fold, synchronised); 0.0 otherwise
    merge_ms: float = 0.0
    # the wire tier that RAN ("raw" | "int8" | "lossless"; an int8 ask the
    # read cannot honour runs raw). int8: ``wire_bytes`` above counts the
    # narrowed rows and ``wire_dequant_error`` is the sampled relative
    # RMS error of a round-to-nearest int8 pass over staged values
    # (a2a.wireErrorSampleRows; 0.0 when off). lossless: the compressed
    # bytes of the drained waves (0 on a single-shot or device read), and
    # their ratio to the payload.
    wire: str = "raw"
    wire_dequant_error: float = 0.0
    lossless_bytes: int = 0
    lossless_ratio: float = 0.0
    bw_gbps: float = 0.0
    effective_bw_gbps: float = 0.0
    # a2a.maxBytesInFlight: the wall this read's reservation waited in
    # the deferral queue (0 for an immediate grant or no cap); group_ms
    # includes it when the dispatch was deferred
    admit_wait_ms: float = 0.0
    # the tenant the shuffle was registered under, and the async plane's
    # worker count when this read ran (0: no async plane attached; 1 on a
    # distributed node clamped by tenant.asyncAgreedOrder=false)
    tenant: str = ""
    async_workers: int = 0
    # the read ran the two-tier exchange (shuffle/topology.py); ``tiers``
    # holds one entry per tier ("ici", "dcn": payload/wire pairs, exact
    # cross rows, the emulated wall ``ms`` and its rates) and then the
    # headline ``wire_bytes``/``pad_ratio`` above are the two-hop sum.
    # Empty on flat reads.
    hierarchical: bool = False
    tiers: List[Dict] = field(default_factory=list)
    # a collective read of a distributed node, and the process that
    # reported it (its view holds this process's shards only)
    distributed: bool = False
    process_id: int = 0
    # failure.policy=replay: the replays this read spent (stale-handle
    # re-pins and re-runs) and the wall of its failed attempts (ms)
    replays: int = 0
    replay_ms: float = 0.0
    # the integrity verify level this read ran ("staged": the staged and
    # spilled bytes re-checked before the exchange; "full": the result
    # checked after it too; "" = off, or no map published a record) and
    # the bytes it verified
    integrity: str = ""
    integrity_bytes: int = 0
    # the agreement rounds this process closed during the read (the
    # decision ledger's records since the read started): {rounds,
    # agree_ms, slowest_topic, divergent}; {} when none ran or the plane
    # is off
    agreement: Dict = field(default_factory=dict)
    completed: bool = False
    error: Optional[str] = None
    # the read's start (the wall span shuffle.exchange starts here) and
    # the decision ledger's append count then
    _t_start: float = field(default=0.0, repr=False)
    _agree_mark: int = field(default=-1, repr=False)
    _t_dispatched: float = field(default=0.0, repr=False)
    # the manager's exchange sequence number: the int8 noise base
    _seq: int = field(default=0, repr=False)
    # the [P, P] device matrix the tier entries' exact cross rows came
    # from (re-stamped after a regrow)
    _tier_matrix: Optional[np.ndarray] = field(default=None, repr=False)
    # the int8 tier's raw/wire row-width gain (1.0 elsewhere): the
    # multiplier of effective_bw_gbps
    _wire_gain: float = field(default=1.0, repr=False)

    def to_dict(self) -> Dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if not f.name.startswith("_")}


@dataclass
class ShuffleHandle:
    """Shuffle descriptor returned by ``register_shuffle``."""

    shuffle_id: int
    num_maps: int
    num_partitions: int
    entry: ShuffleEntry = field(repr=False)
    partitioner: str = "hash"
    bounds: Optional[tuple] = None
    # the node epoch the shuffle was registered in: a read of a handle
    # from an older epoch raises StaleEpochError
    epoch: int = 0
    # the tenant every read of it is admitted, accounted and
    # policy-resolved as (shuffle/tenancy.py)
    tenant: str = "default"

    def __post_init__(self):
        if self.num_maps <= 0 or self.num_partitions <= 0:
            raise ValueError("num_maps and num_partitions must be positive")
        if self.partitioner not in PARTITIONERS:
            raise ValueError(f"unknown partitioner {self.partitioner!r}; "
                             f"want one of {PARTITIONERS}")


class _ReadGuard:
    """One read's window over writer-owned memory (staged buffers,
    mapped spill views), from the writers snapshot through the end of its
    pack: a batch of writers dropped meanwhile stays in the manager's
    graveyard until every such window opened before the drop has closed.
    :meth:`close` is idempotent."""

    __slots__ = ("_mgr", "_gen")

    def __init__(self, mgr: "ShuffleManager"):
        self._mgr = mgr
        self._gen = mgr._read_started()

    def close(self) -> None:
        mgr, self._mgr = self._mgr, None
        if mgr is not None:
            mgr._read_finished(self._gen)


class ShuffleManager:
    """Per-process shuffle service bound to a :class:`Node`."""

    def __init__(self, node: Node, conf: Optional[ShuffleConf] = None):
        self.node = node
        self.conf = conf or node.conf
        self._writers: Dict[int, Dict[int, MapOutputWriter]] = {}
        # learned skew factors keyed by shuffle shape (see _learn_cap)
        self._cap_hints: Dict[tuple, float] = {}
        # waved reads: the wave cap_out that worked, keyed by (shape,
        # wave cap_in)
        self._wave_cap_hints: Dict[tuple, int] = {}
        self._reports: "OrderedDict[int, ExchangeReport]" = OrderedDict()
        self._report_capacity = self.conf.report_capacity
        self._pack_pool: Optional[ThreadPoolExecutor] = None
        self._warned: set = set()
        self._lock = threading.Lock()
        # one number per read: the seq third of the trace id and the int8
        # wire's noise base
        self._exchange_seq = 0
        # -- tenancy (shuffle/tenancy.py): per-tenant policy from conf --
        self._tenants = TenantRegistry(self.conf)
        # a2a.maxBytesInFlight: bytes reserved by exchanges in flight (in
        # all and per tenant) and the queue of deferred reservations'
        # tickets (DRR across tenants, or FIFO); every grant ever and per
        # tenant (the cross-grants count of a deferred ticket)
        self._inflight_cv = threading.Condition()
        self._inflight_bytes = 0
        self._inflight_by_tenant: Dict[str, int] = {}
        self._grant_seq = 0
        self._grant_count_by_tenant: Dict[str, int] = {}
        self._admit_queue = FairShareQueue(self._tenants) \
            if self._tenants.fair_share else FifoAdmitQueue()
        self._admit_ticket = 0
        # tenant -> packs running now (the pack executor's fair share)
        self._packing: Dict[str, int] = {}
        # the async plane's worker count, stamped by the service
        self._async_workers = 0
        # dropped writers wait here, tagged with the generation of their
        # drop, until no read that could still copy from them is in flight
        # (_collect_free_graveyard_locked); reads in flight by the
        # generation they started under
        self._graveyard: list = []          # [(dropped_at_gen, [writers])]
        self._gen = 0
        self._active_reads: Dict[int, int] = {}
        # -- the recovery ledger (failure.policy=replay) --------------------
        # registration shapes (a re-registration after a bump needs them:
        # the remesh cleared the registry first), the shuffles the last
        # bump carried over (sid -> {entry, epoch}) and the replays each
        # shuffle spent
        self._shapes: Dict[int, Dict] = {}
        self._replayed: Dict[int, Dict] = {}
        self._replay_counts: Dict[int, int] = {}
        self._policy = self.conf.failure_policy
        if self._policy == "replay" and self.node.is_distributed \
                and self.node.replay_group is None:
            raise ValueError(
                "failure.policy=replay on a distributed node needs the node "
                "started under it: its replay.enter rounds ride a gloo "
                "group that only such a node makes")
        self._replay_budget = self.conf.replay_budget
        # -- the integrity plane (shuffle/integrity.py) ---------------------
        self._integrity_level = self.conf.integrity_verify
        # distributed full verify: each shuffle's agreed expected digest
        # tables, gathered at submit and read after the exchange
        self._full_expect: Dict[int, Dict] = {}
        # -- the durable ledger (failure.ledgerDir, shuffle/durable.py) -----
        # a manager started on a ledger directory re-registers the intact
        # shuffles it finds there; register_shuffle adopts them
        self._ledger: Optional[ShuffleLedger] = None
        self._recovered: Dict[int, Dict] = {}
        if self.conf.ledger_dir:
            self._ledger = ShuffleLedger(self.conf.ledger_dir)
            self._ledger.epoch = self.node.epochs.current
            self._recover_from_ledger()
        # the exchange topology of this binding (a2a.topology against the
        # node's shard grid; rebound at every epoch bump)
        self._bind_grid()
        # a remesh drops (or, under replay, carries) this binding's
        # shuffle state; the recorder's postmortem carries the reports
        self.node.epochs.on_bump(self._on_epoch_bump)
        self.node.flight.add_context_provider(self.exchange_reports)

    def _bind_grid(self) -> None:
        self.topology = resolve_topology(self.node.grid, self.conf)
        self.hierarchical = self.topology.hierarchical

    # -- lifecycle --------------------------------------------------------
    def register_shuffle(self, shuffle_id: int, num_maps: int,
                         num_partitions: int, partitioner: str = "hash",
                         bounds=None,
                         tenant: Optional[str] = None) -> ShuffleHandle:
        """Allocate the metadata table for a shuffle. ``partitioner``:
        'hash' groups by key hash, 'direct' treats keys as partition
        ids, 'range' routes the int64 key through the sorted split points
        ``bounds`` (``num_partitions - 1`` of them; Spark's
        RangePartitioner). Bounds are validated here, before any map
        publishes a size row computed from them. ``tenant`` (default:
        conf ``tenant.id``) is the tenant every read of the shuffle runs
        as; its ``tenant.<id>.*`` keys are validated here too.

        A shuffle the durable ledger recovered at construction is adopted
        instead (:meth:`_adopt_recovered`): its intact maps are committed
        already. A different shape drops the recovery and registers
        fresh."""
        if partitioner not in PARTITIONERS:
            raise ValueError(f"unknown partitioner {partitioner!r}; want "
                             f"one of {PARTITIONERS}")
        if bounds is not None:
            bounds = check_bounds(bounds, num_partitions)
        # every handle invariant holds BEFORE the registry is touched: a
        # later failure would leave a dead entry that blocks the retry
        if (partitioner == "range") != (bounds is not None):
            raise ValueError(
                "partitioner='range' requires bounds (and only it)")
        tid = self._tenants.resolve(tenant)
        self._tenants.spec(tid)
        with self._lock:
            rec = self._recovered.pop(shuffle_id, None)
        if rec is not None:
            h = self._adopt_recovered(rec, shuffle_id, num_maps,
                                      num_partitions, partitioner, bounds,
                                      tenant=tid)
            if h is not None:
                return h
        entry = self.node.registry.register(shuffle_id, num_maps,
                                            num_partitions, partitioner,
                                            bounds)
        with self._lock:
            self._writers[shuffle_id] = {}
            self._shapes[shuffle_id] = {
                "num_maps": num_maps, "num_partitions": num_partitions,
                "partitioner": partitioner, "bounds": bounds,
                "tenant": tid}
            self._replayed.pop(shuffle_id, None)
            self._replay_counts.pop(shuffle_id, None)
        return ShuffleHandle(shuffle_id, num_maps, num_partitions, entry,
                             partitioner, bounds,
                             epoch=self.node.epochs.current, tenant=tid)

    def get_writer(self, handle: ShuffleHandle,
                   map_id: int) -> MapOutputWriter:
        """Writer for one map task. A committed map output is immutable
        (first commit wins); an uncommitted earlier writer is released."""
        if not (0 <= map_id < handle.num_maps):
            raise IndexError(
                f"mapId {map_id} out of range [0,{handle.num_maps})")
        # with the ledger on, the writer spills into (and commit seals
        # into) the shuffle's ledger directory
        spill_dir = self._ledger.shuffle_dir(handle.shuffle_id) \
            if self._ledger is not None else self.conf.spill_dir
        w = MapOutputWriter(handle.entry, map_id, self.node.pool,
                            handle.partitioner, handle.bounds,
                            spill_dir=spill_dir,
                            spill_threshold=self.conf.spill_threshold,
                            metrics=self.node.metrics,
                            faults=self.node.faults,
                            integrity_level=self._integrity_for(
                                handle.tenant),
                            ledger=self._ledger)
        with self._lock:
            ws = self._writers.get(handle.shuffle_id)
            if ws is None:
                raise RuntimeError(
                    f"shuffle {handle.shuffle_id} is not registered")
            prev = ws.get(map_id)
            if prev is not None and prev.committed:
                raise RuntimeError(
                    f"shuffle {handle.shuffle_id} map {map_id} is already "
                    f"committed; its output is immutable (first commit "
                    f"wins)")
            if prev is not None:
                prev.release()
            ws[map_id] = w
        return w

    def has_live_writer(self, shuffle_id: int, map_id: int) -> bool:
        """Whether (shuffle, map) holds an uncommitted writer now."""
        with self._lock:
            w = self._writers.get(shuffle_id, {}).get(map_id)
        return w is not None and not w.committed

    def live_shuffles(self) -> List[int]:
        """The registered shuffle ids, sorted."""
        with self._lock:
            return sorted(self._writers)

    def export_shuffle(self, shuffle_id: int) -> Dict[int, tuple]:
        """``{map_id: (keys, values, committed)}``: copies of the staged
        state of every writer of a shuffle (a spilled writer's mapped
        views are copied, so the export owns its bytes), read under the
        in-flight guard so a concurrent remesh defers their release."""
        guard = _ReadGuard(self)
        try:
            with self._lock:
                if shuffle_id not in self._writers:
                    raise KeyError(f"shuffle {shuffle_id} not registered")
                writers = dict(self._writers[shuffle_id])
            staged = {}
            for map_id, w in writers.items():
                keys, values = w.materialize()
                staged[map_id] = (np.array(keys, copy=True),
                                  None if values is None
                                  else np.array(values, copy=True),
                                  w.committed)
            return staged
        finally:
            guard.close()

    def unregister_shuffle(self, shuffle_id: int,
                           keep_durable: bool = False) -> None:
        """Drop a shuffle: its table, and its writers' buffers and spill
        files (through the graveyard, so a read still packing from them
        finishes first), and its part of the durable ledger unless
        ``keep_durable`` (``stop()``'s path: a shutdown keeps what the
        ledger exists to carry across a restart)."""
        with self._lock:
            writers = self._writers.pop(shuffle_id, {})
            self._shapes.pop(shuffle_id, None)
            self._replayed.pop(shuffle_id, None)
            self._replay_counts.pop(shuffle_id, None)
            self._recovered.pop(shuffle_id, None)
            self._full_expect.pop(shuffle_id, None)
            to_free = self._bury_locked([writers] if writers else [])
        self._release_writer_batches(to_free)
        self.node.registry.unregister(shuffle_id)
        if self._ledger is not None and not keep_durable:
            self._ledger.forget(shuffle_id)

    def stop(self) -> None:
        """Unregister every shuffle, keeping the durable ledger, and shut
        the pack executor down."""
        self.node.epochs.remove_listener(self._on_epoch_bump)
        self.node.flight.remove_context_provider(self.exchange_reports)
        with self._lock:
            # recovered shuffles never adopted hold registry entries too
            sids = sorted(set(self._writers) | set(self._recovered))
            pool, self._pack_pool = self._pack_pool, None
        for sid in sids:
            self.unregister_shuffle(sid, keep_durable=True)
        # a read still in flight at shutdown loses its writers anyway:
        # shutdown must end
        with self._lock:
            leftover, self._graveyard = self._graveyard, []
        self._release_writer_batches([ws for _, ws in leftover])
        if pool is not None:
            pool.shutdown(wait=True)

    def _on_epoch_bump(self, epoch: int) -> None:
        """A remesh: the binding follows the node's new grid. Under
        ``failure.policy=replay`` the shuffles whose maps are all
        committed and staged here re-register under the new epoch (the
        recovery ledger); every other shuffle's writers are dropped,
        through the graveyard. With the durable ledger on, later manifests
        record the new epoch and the recovered shuffles not adopted yet
        are registered again (the remesh cleared the registry)."""
        self._bind_grid()
        if self._ledger is not None:
            self._ledger.epoch = epoch
            self._refresh_recovered_registrations()
        survivors = self._ledger_candidates() \
            if self._policy == "replay" else {}
        with self._lock:
            dropped = [ws for sid, ws in self._writers.items()
                       if sid not in survivors]
            self._writers = {sid: ws for sid, ws in self._writers.items()
                             if sid in survivors}
            to_free = self._bury_locked(dropped)
        self._release_writer_batches(to_free)
        carried = [sid for sid in sorted(survivors)
                   if self._reregister_shuffle(sid, epoch)]
        if carried:
            log.warning("manager rebound to epoch %d: %d shuffle(s) "
                        "re-registered from the recovery ledger (%s); %d "
                        "dropped", epoch, len(carried), carried,
                        len(dropped))
        else:
            log.warning("manager rebound to epoch %d: shuffle state "
                        "dropped — re-register and re-run live shuffles",
                        epoch)

    # -- the in-flight guard and the graveyard ----------------------------
    def _bury_locked(self, batch: list) -> list:
        """Park one drop (a list of ``{map_id: writer}``) in the
        graveyard under a new generation; returns the batches no read in
        flight can reach, for the caller to release outside the lock."""
        self._gen += 1
        if batch:
            self._graveyard.append((self._gen, batch))
        return self._collect_free_graveyard_locked()

    def _collect_free_graveyard_locked(self) -> list:
        """Split off the graveyard batches no read in flight can reach (a
        read that started at generation G snapshotted the writers at G or
        later, so only reads with G below a batch's drop generation can
        hold views into it). Caller holds the lock."""
        oldest = min(self._active_reads, default=None)
        free, keep = [], []
        for dropped_at, ws in self._graveyard:
            if oldest is None or oldest >= dropped_at:
                free.append(ws)
            else:
                keep.append((dropped_at, ws))
        self._graveyard = keep
        return free

    @staticmethod
    def _release_writer_batches(batches: list) -> None:
        """Each batch is one drop: a list of ``{map_id: writer}``."""
        for batch in batches:
            for ws in batch:
                for w in ws.values():
                    w.release()

    def _read_started(self) -> int:
        with self._lock:
            g = self._gen
            self._active_reads[g] = self._active_reads.get(g, 0) + 1
        return g

    def _read_finished(self, start_gen: int) -> None:
        with self._lock:
            n = self._active_reads.get(start_gen, 0) - 1
            if n > 0:
                self._active_reads[start_gen] = n
            else:
                self._active_reads.pop(start_gen, None)
            to_free = self._collect_free_graveyard_locked()
        self._release_writer_batches(to_free)

    # -- the recovery ledger (failure.policy=replay) -----------------------
    def _ledger_candidates(self) -> Dict[int, Dict]:
        """Shuffles whose writers here are whole: every map committed and
        none released. A partly staged shuffle is dropped: an
        uncommitted map's rows cannot be recovered without re-running its
        task."""
        with self._lock:
            snap = {sid: dict(ws) for sid, ws in self._writers.items()}
            shapes = dict(self._shapes)
        out: Dict[int, Dict] = {}
        for sid, ws in snap.items():
            shape = shapes.get(sid)
            if not shape or not ws:
                continue
            committed = {m for m, w in ws.items()
                         if w.committed and not w.released}
            if committed == set(range(shape["num_maps"])):
                out[sid] = ws
        return out

    def _reregister_shuffle(self, sid: int, epoch: int) -> bool:
        """Re-register one ledger survivor under the new epoch: a fresh
        registry entry with the committed size rows and integrity records
        copied from the old entry, the writers pointed at it. On any
        failure the shuffle is dropped, through the graveyard."""
        try:
            shape = self._shapes[sid]
            with self._lock:
                ws = dict(self._writers.get(sid, {}))
            old_entry = next(iter(ws.values())).entry
            reg = self.node.registry
            reg.unregister(sid)     # a no-op when the remesh cleared it
            entry = reg.register(sid, shape["num_maps"],
                                 shape["num_partitions"],
                                 shape["partitioner"], shape["bounds"])
            for m in sorted(ws):
                # a replayed read verifies like any other
                entry.publish(m, old_entry.fetch_record(m),
                              integrity=old_entry.fetch_integrity(m))
                ws[m].entry = entry
            with self._lock:
                self._replayed[sid] = {"entry": entry, "epoch": epoch}
            return True
        except Exception as e:
            log.error("recovery ledger could not re-register shuffle %d "
                      "(%s) — dropping it", sid, e)
            with self._lock:
                ws = self._writers.pop(sid, None)
                to_free = self._bury_locked([ws] if ws else [])
            self._release_writer_batches(to_free)
            return False

    def _tenant_of(self, sid: int) -> str:
        """The tenant a shuffle was registered under (the conf default
        for one with no registration record)."""
        with self._lock:
            shape = self._shapes.get(sid)
        return (shape or {}).get("tenant") or self._tenants.default_id

    def _replay_budget_for(self, sid: int):
        """(budget, conf key) of one shuffle's replays: its tenant's
        ``tenant.<id>.replayBudget`` when set, else the global."""
        tid = self._tenant_of(sid)
        spec = self._tenants.spec(tid)
        if spec.replay_budget is not None:
            return spec.replay_budget, \
                f"spark.shuffle.tpu.tenant.{tid}.replayBudget"
        return self._replay_budget, "spark.shuffle.tpu.failure.replayBudget"

    def _spend_replay(self, sid: int) -> bool:
        """Spend one unit of the shuffle's replay budget; False once it
        is spent (the caller fails fast)."""
        budget, conf_key = self._replay_budget_for(sid)
        with self._lock:
            spent = self._replay_counts.get(sid, 0)
            if spent >= budget:
                log.error("shuffle %d replay budget exhausted (%d/%d, %s) "
                          "— failing fast", sid, spent, budget, conf_key)
                return False
            self._replay_counts[sid] = spent + 1
        return True

    def _resolve_handle(self, handle: ShuffleHandle) -> int:
        """Pin a handle to the current epoch: 0 when it is current, 1
        when it was re-pinned through the recovery ledger (one replay);
        else ``StaleEpochError`` (always under failfast)."""
        cur = self.node.epochs.current
        if handle.epoch == cur:
            return 0
        sid = handle.shuffle_id
        with self._lock:
            rec = self._replayed.get(sid)
        if self._policy != "replay" or rec is None \
                or rec["epoch"] != cur:
            self.node.epochs.validate(handle.epoch, f"shuffle {sid}")
            return 0              # not reached: validate raises
        if not self._spend_replay(sid):
            budget, conf_key = self._replay_budget_for(sid)
            raise StaleEpochError(
                f"shuffle {sid} pinned to epoch {handle.epoch}, mesh is "
                f"at {cur}, and its replay budget ({budget}) is spent — "
                f"re-register and re-run, or raise {conf_key}")
        handle.entry = rec["entry"]
        handle.epoch = cur
        log.warning("shuffle %d re-pinned to epoch %d through the recovery "
                    "ledger — replaying on the new grid", sid, cur)
        return 1

    def _replay_after_failure(self, handle: ShuffleHandle, err) -> bool:
        """Whether :meth:`read` may re-run the exchange after the
        transient failure ``err`` (one budget unit).

        On a distributed node the decision is collective: every process
        whose read failed proposes (shuffle id, budget left) in a
        ``replay.enter`` agreement round on the node's replay group,
        bounded by ``failure.replayAgreeTimeoutMs`` (a peer whose read
        did not fail never enters it); a divergence or a failed round
        vetoes the replay with no unit spent, and a ``PeerLostError``
        never replays in place (its channel is gone). On one process a
        ``PeerLostError`` remeshes over the probe's survivors first, and
        the unit spent here also covers the handle's re-pin."""
        if self._policy != "replay":
            return False
        sid = handle.shuffle_id
        if self.node.is_distributed:
            if isinstance(err, PeerLostError):
                return False
            budget, conf_key = self._replay_budget_for(sid)
            with self._lock:
                left = budget - self._replay_counts.get(sid, 0)
            enter_ms = self.conf.replay_agree_timeout_ms
            try:
                agree("replay.enter", np.array([sid, left], dtype=np.int64),
                      conf_key=conf_key,
                      timeout_ms=enter_ms if enter_ms > 0 else None,
                      metrics=self.node.metrics,
                      group=self.node.replay_group)
            except Exception as e:
                log.error("distributed replay of shuffle %d vetoed (%r); "
                          "failing fast", sid, e)
                return False
            if not self._spend_replay(sid):
                return False
            self.node.flight.record("replay", shuffle_id=sid,
                                    error=repr(err)[:200], distributed=True)
            log.warning("replaying shuffle %d group-wide after a transient "
                        "failure: %r", sid, err)
            return True
        if not self._spend_replay(sid):
            return False
        if isinstance(err, PeerLostError):
            try:
                self.node.remesh(reason=f"replay shuffle {sid} after "
                                        f"{type(err).__name__}")
            except Exception as e:
                log.error("replay remesh failed (%s); failing fast", e)
                return False
            cur = self.node.epochs.current
            with self._lock:
                rec = self._replayed.get(sid)
            if rec is None or rec["epoch"] != cur:
                log.error("staged state of shuffle %d did not survive the "
                          "replay remesh; failing fast", sid)
                return False
            handle.entry = rec["entry"]
            handle.epoch = cur
        self.node.flight.record("replay", shuffle_id=sid,
                                error=repr(err)[:200])
        log.warning("replaying shuffle %d after a transient failure: %r",
                    sid, err)
        return True

    def _account_replays(self, handle: ShuffleHandle, replays: int,
                         replay_ms: float) -> None:
        rep = self.report(handle.shuffle_id)
        if rep is not None:
            rep.replays = int(replays)
            rep.replay_ms = round(replay_ms, 3)
        m = self.node.metrics
        m.inc(C_REPLAYS, float(replays))
        m.inc(labeled(C_REPLAYS, tenant=handle.tenant), float(replays))
        if replay_ms:
            m.inc(C_REPLAY_MS, float(replay_ms))
            m.inc(labeled(C_REPLAY_MS, tenant=handle.tenant),
                  float(replay_ms))

    # -- restart recovery (failure.ledgerDir, shuffle/durable.py) ----------
    def _register_recovered(self, rs) -> ShuffleEntry:
        """A registry entry for a recovered shuffle with every intact
        map's size row and integrity record published."""
        entry = self.node.registry.register(rs.shuffle_id, rs.num_maps,
                                            rs.num_partitions,
                                            rs.partitioner, rs.bounds)
        for mid in sorted(rs.intact):
            rec, sizes = rs.intact[mid]
            entry.publish(mid, sizes, integrity=rec)
        return entry

    def _recover_from_ledger(self) -> None:
        """Scan the durable ledger at construction: each shuffle whose
        manifest validates is registered under the current epoch with its
        intact maps published (the scan quarantined the rest), and
        :meth:`register_shuffle` with the same shape adopts it."""
        reg = self.node.registry
        for rs in self._ledger.scan():
            sid = rs.shuffle_id
            try:
                reg.get(sid)
                continue        # a live manager of this node owns it
            except KeyError:
                pass
            try:
                entry = self._register_recovered(rs)
            except Exception as e:
                log.error("restart recovery: shuffle %d could not "
                          "re-register (%s) — it will recompute", sid, e)
                reg.unregister(sid)
                continue
            self._recovered[sid] = {"rs": rs, "entry": entry}
            self.node.metrics.inc(C_INTEGRITY_RECOVERED,
                                  float(len(rs.intact)))
            if rs.quarantined:
                self.node.metrics.inc(C_INTEGRITY_QUARANTINED,
                                      float(len(rs.quarantined)))
                self.node.flight.record("block_quarantine", shuffle_id=sid,
                                        maps=list(rs.quarantined))
            log.warning(
                "restart recovery: shuffle %d re-registered from the "
                "ledger (%d/%d maps intact, served without recompute%s)",
                sid, len(rs.intact), rs.num_maps,
                f"; maps {rs.quarantined} quarantined — re-stage only "
                f"those" if rs.quarantined else "")

    def _refresh_recovered_registrations(self) -> None:
        """Register again the recovered shuffles not adopted yet whose
        entries a remesh cleared; a failure drops the recovery (the
        shuffle recomputes, as with no ledger)."""
        reg = self.node.registry
        with self._lock:
            pending = list(self._recovered.items())
        for sid, rec in pending:
            try:
                reg.get(sid)
                continue                      # the entry survived
            except KeyError:
                pass
            try:
                rec["entry"] = self._register_recovered(rec["rs"])
            except Exception as e:
                log.error("recovered shuffle %d could not re-register "
                          "after the remesh (%s) — it will recompute",
                          sid, e)
                with self._lock:
                    self._recovered.pop(sid, None)

    def recovered_shuffles(self) -> Dict[int, Dict]:
        """``{shuffle_id: {"intact": [...], "quarantined": [...]}}`` of
        the shuffles the ledger recovered that :meth:`register_shuffle`
        has not adopted yet."""
        with self._lock:
            return {sid: {"intact": sorted(rec["rs"].intact),
                          "quarantined": list(rec["rs"].quarantined)}
                    for sid, rec in self._recovered.items()}

    def _adopt_recovered(self, rec: Dict, shuffle_id: int, num_maps: int,
                         num_partitions: int, partitioner: str,
                         bounds, tenant: str) -> Optional[ShuffleHandle]:
        """Install a recovered shuffle as live state: a committed writer
        over the sealed files of each intact map (reads pack from their
        mapped views), none for a quarantined map (``entry.present(m)``
        is False; only it stages again). Returns None on a shape
        mismatch, after dropping the recovery and its ledger state: a
        shuffle id reused with another shape is another shuffle."""
        rs = rec["rs"]
        if (num_maps, num_partitions, partitioner, bounds) != \
                (rs.num_maps, rs.num_partitions, rs.partitioner,
                 rs.bounds):
            log.warning(
                "register_shuffle(%d): shape differs from the ledger's "
                "(%dx%d %s vs %dx%d %s) — dropping the recovered state "
                "and registering fresh", shuffle_id, num_maps,
                num_partitions, partitioner, rs.num_maps,
                rs.num_partitions, rs.partitioner)
            self.node.registry.unregister(shuffle_id)
            self._ledger.forget(shuffle_id)
            return None
        entry = rec["entry"]
        ws = {mid: MapOutputWriter.recovered(
                  entry, mid, self.node.pool, rs.directory, irec,
                  partitioner=partitioner, bounds=bounds,
                  integrity_level=self._integrity_for(tenant),
                  metrics=self.node.metrics)
              for mid, (irec, _sizes) in rs.intact.items()}
        with self._lock:
            self._writers[shuffle_id] = ws
            self._shapes[shuffle_id] = {
                "num_maps": num_maps, "num_partitions": num_partitions,
                "partitioner": partitioner, "bounds": bounds,
                "tenant": tenant}
            self._replayed.pop(shuffle_id, None)
            self._replay_counts.pop(shuffle_id, None)
        log.info("shuffle %d adopted from the durable ledger: %d/%d maps "
                 "served from sealed files, %d to re-stage", shuffle_id,
                 len(ws), num_maps, num_maps - len(ws))
        return ShuffleHandle(shuffle_id, num_maps, num_partitions, entry,
                             partitioner, bounds,
                             epoch=self.node.epochs.current, tenant=tenant)

    # -- integrity verification (shuffle/integrity.py) ---------------------
    def _integrity_for(self, tenant: Optional[str]) -> str:
        """The integrity level of a tenant's shuffles: its
        ``tenant.<id>.integrity.verify`` when set, else the global
        ``integrity.verify``. Commit and read resolve it from the same
        tenant, so records and checks cannot disagree."""
        spec = self._tenants.spec(tenant)
        return spec.integrity_verify or self._integrity_level

    def _note_corruption(self, shuffle_id: int, block: str, nbytes: int,
                         detail: str) -> str:
        """Count one detected corruption (``C_INTEGRITY_CORRUPT_BLOCKS``,
        ``C_INTEGRITY_CORRUPT``), record a ``block_corruption`` ring event
        naming the block, and return the typed raise's message."""
        self.node.metrics.inc(C_INTEGRITY_CORRUPT_BLOCKS, 1.0)
        self.node.metrics.inc(C_INTEGRITY_CORRUPT, float(max(nbytes, 0)))
        self.node.flight.record("block_corruption", shuffle_id=shuffle_id,
                                block=block, bytes=int(nbytes),
                                detail=detail[:200])
        msg = (f"shuffle {shuffle_id}: block corruption detected in "
               f"{block}: {detail} — staged bytes no longer match the "
               f"checksums published at commit "
               f"(spark.shuffle.tpu.integrity.verify="
               f"{self._integrity_level}); failure.policy=replay spends "
               f"one budget unit re-verifying and re-running")
        log.error(msg)
        return msg

    def _verified_materialize(self, entry: ShuffleEntry, writers):
        """``[(map_id, keys, values, verified_bytes)]`` of the committed
        map outputs ``writers``, in map-id order, each checked against the
        record its commit published before any byte can enter the
        exchange; ``verified_bytes`` is -1 for a map that published no
        record (it does not count as verified). The folds run on the pack
        executor (``a2a.packThreads``); the verdict is the serial loop's:
        a mismatch raises ``BlockCorruptionError`` naming the lowest
        failing map.

        The ``corrupt.staged`` / ``corrupt.spill`` fault sites live here,
        consulted in map-id order until one fires, as the serial loop
        consults them until its raise: a firing flips one bit of that
        map's staged buffer / sealed spill file at the armed offset, the
        verify must detect it, and the ``finally`` undoes the flip before
        any pack reads the bytes (a one-batch writer hands back its
        staged buffer itself), so a replay finds them intact."""
        faults = self.node.faults
        tokens, staged = [], []
        try:
            for map_id, w in sorted(writers.items()):
                spilled = w._spill is not None
                if not tokens and not spilled and w._keys:
                    # only a flippable target consumes the firing
                    off = faults.fire("corrupt.staged")
                    if off is not None:
                        tokens.append(integ.flip_array_byte(w._keys[0], off))
                keys, values = w.materialize()
                if not tokens and spilled:
                    off = faults.fire("corrupt.spill")
                    if off is not None:
                        # the shared read-only mappings see the file's flip
                        tokens.append(integ.flip_file_byte(
                            w._spill.keys_path, off))
                block = (os.path.basename(w._spill.keys_path) if spilled
                         else f"map {map_id} staged arena")
                staged.append((map_id, keys, values,
                               entry.fetch_integrity(map_id), block))

            def check(item):
                _, keys, values, rec, _ = item
                if rec is None:
                    return -1
                try:
                    return integ.verify_staged(keys, values, rec)
                except integ._StagedMismatch as e:
                    return e

            nbytes = sum(int(k.nbytes) + (0 if v is None else int(v.nbytes))
                         for _, k, v, _, _ in staged)
            verdicts = list(self._executor().map(check, staged)) \
                if len(staged) > 1 and nbytes >= (1 << 20) \
                else [check(item) for item in staged]
            out = []
            for (map_id, keys, values, _, block), got in zip(staged,
                                                             verdicts):
                if isinstance(got, integ._StagedMismatch):
                    raise BlockCorruptionError(self._note_corruption(
                        entry.shuffle_id, f"map {map_id} ({block})",
                        int(keys.nbytes) + (int(values.nbytes)
                                            if values is not None else 0),
                        str(got))) from None
                out.append((map_id, keys, values, got))
            return out
        finally:
            for token in tokens:
                token.restore()

    def _verify_full_result(self, handle: ShuffleHandle, res,
                            combine: Optional[str]) -> None:
        """``integrity.verify=full`` after the exchange: every local reduce
        partition of a host result is digested again (order-free row
        digest sums) and must equal the senders' published digest rows
        (key lanes only under the int8 wire); a device result has its
        sampled key lanes routed again (:meth:`_verify_full_device`). A
        combined host read keeps the staged verdict: the combine rewrites
        rows. Host-side only: no kernel launch changes."""
        if self._integrity_for(handle.tenant) != "full":
            return
        rep = self.report(handle.shuffle_id)
        if rep is None:
            return
        # the verify's wall, on both verdicts
        t0 = time.perf_counter()
        try:
            self._verify_full_inner(handle, res, combine, rep)
        finally:
            self.node.tracer.record_span(
                "shuffle.verify", t0, level="full",
                shuffle_id=handle.shuffle_id, trace=rep.trace_id)

    def _verify_full_inner(self, handle: ShuffleHandle, res,
                           combine: Optional[str],
                           rep: ExchangeReport) -> None:
        if getattr(res, "sink", "host") == "device":
            self._verify_full_device(handle, res, rep)
            return
        if combine:
            self._warn_once(
                "full_combine", "integrity.verify=full: combined reads "
                "verify at the staged level only — the combine rewrites "
                "rows, so per-row digests cannot survive it")
            return
        key_only = rep.wire == "int8"
        if self.node.is_distributed:
            st = self._full_expect.pop(handle.shuffle_id, None)
            if st is None:
                self._warn_once(
                    "full_dist", "integrity.verify=full: no agreed digest "
                    "table for this distributed read (a process committed "
                    "below the full level?) — staged verify only")
                return
            expected = st["key" if key_only else "full"]
        else:
            expected = integ.aggregate_digests(handle.entry, handle.num_maps,
                                               key_only)
            if expected is None:
                self._warn_once(
                    "full_missing", "integrity.verify=full: commit "
                    "published no digest rows (maps committed below the "
                    "full level) — staged verify only for this shuffle")
                return
        verified = 0
        for r in range(handle.num_partitions):
            if not res.is_local(r):
                continue
            k, v = res.partition(r)
            nbytes = int(k.nbytes) + (int(v.nbytes) if v is not None
                                      and not key_only else 0)
            got = integ.digest_sum(k, None if key_only else v)
            if got != int(expected[r]):
                raise BlockCorruptionError(self._note_corruption(
                    handle.shuffle_id,
                    f"reduce partition {r} (post-collective"
                    f"{', key lanes' if key_only else ''})", nbytes,
                    f"drained digest {got:#x} != published "
                    f"{int(expected[r]):#x}"))
            verified += nbytes
        self.node.metrics.inc(C_INTEGRITY_VERIFIED, float(verified))
        rep.integrity = "full"
        rep.integrity_bytes += verified

    def _verify_full_device(self, handle: ShuffleHandle, res,
                            rep: ExchangeReport) -> None:
        """``integrity.verify=full`` over a device result: a host copy of
        the first wave's key lanes (a single-shot read is one wave; an
        ordered or combine waved read is one merged view; a plain waved
        read is sampled at wave 0), every valid key routed again through
        the host twin of the device partitioner
        (``integrity.verify_key_routing``). It covers combine reads and
        every wire tier (key lanes are exact), and the copy is real D2H,
        charged to the read's ``d2h_bytes``. A plain read under the
        segment move keeps the staged verdict, as the JAX package's does:
        its receive layout there is chunk-aligned (valid rows are not a
        prefix; the port compacts them for the device consumer, but keeps
        the reference's verdict)."""
        plan = res._plan
        if plan.impl == "pallas" and not (plan.combine or plan.ordered):
            self._warn_once(
                "full_device_aligned", "integrity.verify=full: device-sink "
                "reads on a chunk-aligned receive layout (a2a.impl=pallas, "
                "plain) verify at the staged level only")
            return
        views = res.wave_views()
        got = views[0].key_lanes_to_host() if views else None
        if got is None:
            return        # already consumed: nothing to sample
        keys, totals = got
        try:
            # a distributed view holds this process's shards only
            verified = integ.verify_key_routing(
                keys.reshape(-1, 2), totals, handle.num_partitions,
                self.node.num_shards, partitioner=handle.partitioner,
                bounds=handle.bounds, shard_ids=views[0].shard_ids)
        except integ._StagedMismatch as e:
            raise BlockCorruptionError(self._note_corruption(
                handle.shuffle_id, "device receive buffer (post-collective, "
                "key lanes, sampled wave 0)", int(keys.nbytes),
                str(e))) from None
        self.node.metrics.inc(C_INTEGRITY_VERIFIED, float(verified))
        rep.integrity = "full"
        rep.integrity_bytes += verified

    def _stash_full_expect(self, handle: ShuffleHandle, writers) -> None:
        """COLLECTIVE (distributed, full level, non-combine reads): every
        process's summed digest rows all-gathered, so each holds the
        global expected tables for its partitions. The uint64 words travel
        as their int64 views (a round trip keeps every bit). One process
        lacking digest rows makes every process skip together."""
        R = handle.num_partitions
        full = np.zeros(R, dtype=np.uint64)
        key = np.zeros(R, dtype=np.uint64)
        have = 1
        for mid in writers:
            rec = handle.entry.fetch_integrity(mid)
            if rec is None or rec.digests is None:
                have = 0
                break
            full += np.asarray(rec.digests, dtype=np.uint64)
            key += np.asarray(rec.key_digests, dtype=np.uint64)
        blob = np.concatenate([np.array([have], dtype=np.int64),
                               full.view(np.int64), key.view(np.int64)])
        gathered = allgather_blob(blob, what="full-verify digest table")
        if not int(gathered[:, 0].min()):
            return
        words = np.ascontiguousarray(gathered[:, 1:]).view(np.uint64)
        self._full_expect[handle.shuffle_id] = {
            "full": words[:, :R].sum(axis=0, dtype=np.uint64),
            "key": words[:, R:].sum(axis=0, dtype=np.uint64)}

    # -- reports ----------------------------------------------------------
    def report(self, shuffle_id: int) -> Optional[ExchangeReport]:
        """Latest ExchangeReport of a shuffle (None if never read)."""
        with self._lock:
            return self._reports.get(shuffle_id)

    def reports(self) -> List[ExchangeReport]:
        """Every retained report, oldest first (``metrics.
        reportCapacity`` of them at most)."""
        with self._lock:
            return list(self._reports.values())

    def exchange_reports(self) -> List[Dict]:
        """The retained reports as dicts: the flight recorder's context
        provider (its dump key is this method's name)."""
        return [r.to_dict() for r in self.reports()]

    def _new_report(self, handle: ShuffleHandle,
                    distributed: bool = False) -> ExchangeReport:
        rep = ExchangeReport(handle.shuffle_id, handle.num_maps,
                             handle.num_partitions, handle.partitioner,
                             device=str(self.node.device),
                             hierarchical=self.hierarchical,
                             distributed=distributed,
                             process_id=self.node.process_id,
                             tenant=handle.tenant,
                             async_workers=int(self._async_workers))
        rep._t_start = time.perf_counter()
        rep._agree_mark = int(current_ledger().total)
        with self._lock:
            # reads run in the same order on every process, so the
            # sequence (and the trace id) agrees cluster-wide
            self._exchange_seq += 1
            rep._seq = self._exchange_seq
            rep.trace_id = format_trace_id(handle.shuffle_id,
                                           self.node.epochs.current,
                                           self._exchange_seq)
            self._reports[handle.shuffle_id] = rep
            self._reports.move_to_end(handle.shuffle_id)
            while len(self._reports) > self._report_capacity:
                self._evict_report_locked()
        # ring events recorded while the read is in flight carry its id
        self.node.flight.begin_trace(rep.trace_id)
        return rep

    def _settle_report(self, rep: ExchangeReport, completed: bool) -> None:
        """The read's settlement, on every exit: the ``agreement``
        summary, the ``shuffle.exchange`` wall span (report start to
        now), the tracer's drops as a counter, and the end of the read's
        flight trace. Never raises."""
        try:
            self._settle_agreement(rep)
            tracer = self.node.tracer
            if tracer.enabled and rep._t_start:
                tracer.record_span(
                    "shuffle.exchange", rep._t_start,
                    shuffle_id=rep.shuffle_id, trace=rep.trace_id,
                    tenant=rep.tenant or self._tenants.default_id,
                    completed=completed)
                tracer.publish_dropped(self.node.metrics)
        except Exception:
            log.debug("settlement of %s failed", rep.trace_id,
                      exc_info=True)
        self.node.flight.end_trace(rep.trace_id)

    @staticmethod
    def _settle_agreement(rep: ExchangeReport) -> None:
        """The decision ledger's records since the read started, as the
        report's ``agreement`` summary: rounds, their summed wall, the
        topic that took longest in all, and the divergent rounds."""
        if rep._agree_mark < 0:
            return
        recs = current_ledger().since(rep._agree_mark)
        if not recs:
            return
        by_topic: Dict[str, float] = {}
        for r in recs:
            t = r.get("topic", "?")
            by_topic[t] = by_topic.get(t, 0.0) + float(r.get("round_ms",
                                                             0.0))
        rep.agreement = {
            "rounds": len(recs),
            "agree_ms": round(sum(by_topic.values()), 3),
            "slowest_topic": max(by_topic.items(), key=lambda kv: kv[1])[0],
            "divergent": sum(1 for r in recs if not r.get("ok", True))}

    def gather_reports(self, shuffle_id: int) -> List[Dict]:
        """COLLECTIVE on a distributed node: every process's report of a
        shuffle, as dicts in process order ({} from a process that never
        read it); on one process the local report alone."""
        rep = self.report(shuffle_id)
        local = rep.to_dict() if rep is not None else {}
        if not self.node.is_distributed:
            return [local] if local else []
        return allgather_json(local)

    def gather_spans(self) -> List[Dict]:
        """COLLECTIVE on a distributed node: every process's span buffer
        as chrome trace events with its clock anchor, in process order:
        the input of ``utils/export.merge_timeline``. One process: the
        local capture alone."""
        tracer = self.node.tracer
        local = {"process_id": self.node.process_id, "pid": os.getpid(),
                 "anchor": tracer.anchor(),
                 "events": tracer.chrome_events(),
                 "dropped_spans": tracer.dropped}
        if not self.node.is_distributed:
            return [local]
        return allgather_json(local)

    def _evict_report_locked(self) -> None:
        """Evict one report: the oldest of the tenant holding the most
        ring entries (ties: the tenant of the oldest entry), so a chatty
        tenant churns its own history. With one tenant this is the
        oldest report."""
        counts: Dict[str, int] = {}
        for r in self._reports.values():
            counts[r.tenant] = counts.get(r.tenant, 0) + 1
        if len(counts) <= 1:
            self._reports.popitem(last=False)
            return
        top = max(counts.values())
        for sid, r in self._reports.items():
            if counts[r.tenant] == top:
                self._reports.pop(sid)
                return

    # -- reads ------------------------------------------------------------
    def read(self, handle: ShuffleHandle, timeout: Optional[float] = None,
             combine: Optional[str] = None, ordered: bool = False,
             combine_sum_words: int = 0, sink: Optional[str] = None):
        """Run the whole exchange and return the partition view. Blocks
        until every map output is published (``network.timeoutMs``).

        ``combine="sum"`` combines by key on both sides of the exchange:
        each partition holds ONE row per distinct key, key-sorted, its
        leading ``combine_sum_words`` value words summed (0 = all) and
        the rest carried. ``ordered=True`` serves every partition
        key-sorted (with a range partitioner, the concatenated partitions
        are globally sorted). combine implies ordered output.

        ``sink="device"`` keeps the partitions in device tensors and
        returns a ``DeviceShuffleReaderResult`` (``consume`` /
        ``host_view``); ``"host"`` or ``None`` under the default conf
        returns the numpy partition view (see :meth:`_resolve_sink`).

        Under ``failure.policy=replay`` a ``TransientError`` of an
        attempt (an injected fault, a lost peer on one process) re-runs
        the whole exchange, and a stale handle whose staged state
        survived the remesh re-pins, each spending one unit of
        ``failure.replayBudget``; the report carries ``replays`` and the
        failed attempts' ``replay_ms``. A stale handle that cannot
        re-pin raises ``StaleEpochError`` before the read's metrics
        window opens.

        On a distributed node this is a collective: every process calls
        it with the same arguments and gets the partial view of its own
        shards."""
        metrics = self.node.metrics
        replays = self._resolve_handle(handle)
        t0 = time.perf_counter()
        replay_ms = 0.0
        try:
            while True:
                t_attempt = time.perf_counter()
                try:
                    replays += self._resolve_handle(handle)
                    res = self._submit(handle, timeout, combine, ordered,
                                       combine_sum_words, sink).result()
                    break
                except TransientError as e:
                    replay_ms += (time.perf_counter() - t_attempt) * 1e3
                    if not self._replay_after_failure(handle, e):
                        raise
                    replays += 1
            if replays:
                self._account_replays(handle, replays, replay_ms)
            return res
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            metrics.inc("shuffle.read.ms", ms)
            metrics.inc("shuffle.read.count", 1)
            metrics.observe(H_FETCH_WAIT, ms)
            metrics.observe(labeled(H_FETCH_WAIT, tenant=handle.tenant), ms)
            metrics.inc(labeled("shuffle.read.count", tenant=handle.tenant),
                        1)

    def read_partitions(self, handle: ShuffleHandle, start: int, end: int,
                        timeout: Optional[float] = None,
                        combine: Optional[str] = None,
                        ordered: bool = False):
        """Iterator of ``(r, (keys, values))`` over the reduce partitions
        ``[start, end)`` — the partition-range reader. The range is
        checked and the read (one whole exchange, on the host sink) runs
        before this returns; on a distributed node the partitions other
        processes own are skipped."""
        if not (0 <= start <= end <= handle.num_partitions):
            raise IndexError(
                f"partition range [{start}, {end}) out of "
                f"[0, {handle.num_partitions}]")
        res = self.read(handle, timeout=timeout, combine=combine,
                        ordered=ordered, sink="host")
        return ((r, res.partition(r)) for r in range(start, end)
                if res.is_local(r))

    def submit(self, handle: ShuffleHandle,
               timeout: Optional[float] = None,
               combine: Optional[str] = None, ordered: bool = False,
               combine_sum_words: int = 0, sink: Optional[str] = None):
        """Plan + pack on the host and dispatch the exchange without
        waiting for it; ``result()`` on the returned handle blocks. The
        read options are :meth:`read`'s. A waved read packs and
        dispatches its waves inside ``result()``. Collective on a
        distributed node (every process submits, then calls
        ``result()``, in the same order). A stale handle re-pins as in
        :meth:`read`; a failure of the exchange itself reaches the
        caller (the asynchronous handle does not replay)."""
        replayed = self._resolve_handle(handle)
        pending = self._submit(handle, timeout, combine, ordered,
                               combine_sum_words, sink)
        if replayed:
            self._account_replays(handle, replayed, 0.0)
        return pending

    def _submit(self, handle: ShuffleHandle, timeout: Optional[float],
                combine: Optional[str], ordered: bool,
                combine_sum_words: int, sink: Optional[str]):
        """One attempt's submit on a pinned handle."""
        timeout = timeout if timeout is not None \
            else self.conf.connection_timeout_ms / 1e3
        if self.node.is_distributed:
            return self._submit_distributed(handle, timeout, combine,
                                            ordered, combine_sum_words, sink)
        return self._submit_local(handle, timeout, combine, ordered,
                                  combine_sum_words, sink)

    def _submit_local(self, handle: ShuffleHandle, timeout: float,
                      combine: Optional[str], ordered: bool,
                      combine_sum_words: int, sink: Optional[str]):
        sink = self._resolve_sink(sink, combine, ordered)
        rep = self._new_report(handle)
        rep.sink = sink
        try:
            with self.node.tracer.span("shuffle.submit",
                                       shuffle_id=handle.shuffle_id,
                                       trace=rep.trace_id):
                return self._submit_local_staged(
                    handle, timeout, rep, combine, ordered,
                    combine_sum_words, sink)
        except BaseException as e:
            rep.error = rep.error or repr(e)[:300]
            # a read that dies before its exchange is armed never settles
            self.node.flight.end_trace(rep.trace_id)
            raise

    def _submit_local_staged(self, handle: ShuffleHandle, timeout: float,
                             rep: ExchangeReport, combine: Optional[str],
                             ordered: bool, combine_sum_words: int,
                             sink: str = "host"):
        tracer = self.node.tracer
        with tracer.span("shuffle.barrier", kind="map_outputs",
                         shuffle_id=handle.shuffle_id, trace=rep.trace_id):
            complete = handle.entry.wait_complete(timeout)
        if not complete:
            raise TimeoutError(
                f"shuffle {handle.shuffle_id}: only "
                f"{handle.entry.num_present}/{handle.num_maps} map outputs "
                f"published within {timeout}s")
        # the metadata fetch is a retried control-plane step
        table = self.node.retry_policy.run(
            lambda: (self.node.faults.check("fetch"),
                     handle.entry.fetch_table())[1])
        Pn = self.node.num_shards
        # from the writers snapshot to the end of the pack this read
        # copies from writer-owned memory
        guard = _ReadGuard(self)
        try:
            with self._lock:
                if handle.shuffle_id not in self._writers:
                    raise RuntimeError(
                        f"shuffle {handle.shuffle_id} is not registered "
                        f"with this manager (already unregistered?)")
                writers = {m: w for m, w in
                           self._writers[handle.shuffle_id].items()
                           if w.committed}
            missing = sorted(set(range(handle.num_maps)) - set(writers))
            if missing:
                raise RuntimeError(
                    f"shuffle {handle.shuffle_id}: metadata table is "
                    f"complete but maps {missing[:8]} have no committed "
                    f"staged rows in this manager")
            shard_outputs, has_vals, val_tail, val_dtype = \
                self._materialize_outputs(writers, Pn, handle.entry, rep)
            map_to_dev = np.arange(handle.num_maps) % Pn
            red_to_dev = blocked_partition_map(handle.num_partitions, Pn)
            dev_matrix = table.device_matrix(map_to_dev, red_to_dev, Pn)
            validate_row_sizes(dev_matrix)
            nvalid = np.array([sum(k.shape[0] for k, _ in outs)
                               for outs in shard_outputs], dtype=np.int64)

            t_plan = time.perf_counter()
            with tracer.span("shuffle.plan", shuffle_id=handle.shuffle_id,
                             trace=rep.trace_id):
                plan = make_plan(nvalid, Pn, handle.num_partitions,
                                 self.conf, self.node.device,
                                 partitioner=handle.partitioner,
                                 bounds=handle.bounds, sink=sink,
                                 hierarchical=self.hierarchical)
                plan = self._apply_cap_hint(plan, handle, int(nvalid.sum()))
            with tracer.span("shuffle.plan", shuffle_id=handle.shuffle_id,
                             decorate=True, trace=rep.trace_id):
                plan = self._decorated_plan(plan, combine, ordered,
                                            has_vals, val_tail, val_dtype,
                                            combine_sum_words, sink=sink)
            rep.plan_ms = (time.perf_counter() - t_plan) * 1e3

            width = KEY_WORDS + (value_words(val_tail, val_dtype)
                                 if has_vals else 0)
            return self._submit_planned(
                handle, rep, plan, shard_outputs, nvalid, width, has_vals,
                val_tail, val_dtype, combine, ordered, timeout,
                part_rows=table.sizes.sum(axis=0),
                dev_matrix=lambda: dev_matrix, guard=guard)
        except BaseException:
            guard.close()
            raise

    def _submit_planned(self, handle: ShuffleHandle, rep: ExchangeReport,
                        plan: ShufflePlan, shard_outputs, nvalid: np.ndarray,
                        width: int, has_vals: bool, val_tail, val_dtype,
                        combine: Optional[str], ordered: bool,
                        timeout: Optional[float], part_rows: np.ndarray,
                        dev_matrix, guard: "_ReadGuard", local=None):
        """The submit both paths share once the plan is made: the report's
        volume and tiers, the wave decision, the pack, admission and the
        dispatch. ``guard`` is the read's in-flight window over the
        writers' memory, closed once the pack (a waved read's last) has
        copied from it. ``nvalid`` is the global ``[P]`` row count,
        ``part_rows`` the rows the skew is read from, ``dev_matrix()`` the
        ``[P, P]`` source x destination row matrix (called only on a
        hierarchical read). ``local`` is None on one process; distributed
        it is (this process's shard ids, their ``[L]`` row counts) and
        ``timeout`` is None (a local clock must not fail one process while
        its peers enter the next collective)."""
        node = self.node
        distributed = local is not None
        self._report_volume(rep, plan, nvalid, width, part_rows=part_rows,
                            local_rows=int(np.sum(local[1]))
                            if distributed else None)
        self._estimate_wire_error(rep, plan, shard_outputs)
        hier = self.hierarchical and plan.impl != "pallas"
        if hier:
            # per-tier accounting with the exact cross rows; the tiered
            # stages combine through combine_rows, never the
            # segment-reduce kernel
            self._stamp_tiers(rep, plan, nvalid, width,
                              dev_matrix=dev_matrix())
            rep.kernel = "jnp"
        elif self.hierarchical:
            # the segment move is flat-only: the read runs over all P
            # shards, and the report says so
            log.info("a2a.impl=pallas on a multi-slice grid: using the "
                     "flat exchange over %d shards", node.num_shards)
            rep.hierarchical = False
        eligible = self.conf.wave_rows > 0 and self._waves_eligible(plan)
        W = wave_count(nvalid, self.conf.wave_rows) if eligible else 1
        if distributed:
            # every distributed read agrees its wave count (waves off: 1),
            # so a process with another a2a.waveRows fails typed instead
            # of entering another number of collectives
            W = agree_wave_count(W, node.metrics)
        vt = val_tail if has_vals else None
        if W > 1:
            if hier and plan.sink == "device":
                # waved hierarchical reads drain to the host (no per-wave
                # device fold over the tiers); single-shot hierarchical
                # reads keep the device sink
                self._warn_once(
                    "hier_waved", "read.sink=device on a WAVED "
                    "hierarchical read resolves to host (single-shot "
                    "hierarchical reads keep the device sink)")
                self._note_sink_fallback(
                    "combine" if combine else
                    ("ordered" if ordered else "plain"),
                    "hierarchical_waved")
                plan = dataclasses.replace(plan, sink="host")
                rep.sink = "host"
            return self._submit_waved(handle, shard_outputs, nvalid, plan,
                                      width, has_vals, vt, val_dtype, rep,
                                      W, timeout, guard,
                                      distributed=distributed)
        self._note_inert_lossless(plan)
        t_pack = time.perf_counter()
        with node.tracer.span("shuffle.pack",
                              rows=int(np.sum(local[1] if distributed
                                              else nvalid)),
                              trace=rep.trace_id):
            rows, stage_buf = self._pack_shards(shard_outputs, plan.cap_in,
                                                width, has_vals,
                                                tenant=handle.tenant)
        rep.pack_ms = (time.perf_counter() - t_pack) * 1e3
        guard.close()
        if distributed:
            shard_ids, nvalid_local = local
            # admission from global facts only (the worst process's
            # pinned block), so every process defers alike
            stage_bytes = -(-node.num_shards // node.num_processes) \
                * plan.cap_in * width * 4
        else:
            stage_bytes = rows.numel() * 4
        # a non-blocking reservation at dispatch; over the cap the
        # exchange is deferred and dispatches inside result()
        admit, release_admitted = self._make_admitter(
            plan, width, stage_bytes, timeout, tenant=handle.tenant,
            report=rep)

        def dispatch(on_done):
            kw = dict(on_done=on_done, admit=admit, wire_seed=rep._seq,
                      metrics=node.metrics)
            if hier and distributed:
                return submit_shuffle_tiered_distributed(
                    self.topology, plan, rows, nvalid_local, shard_ids, vt,
                    val_dtype, node.device, node.pool,
                    **self._tier_hooks(rep.trace_id), **kw)
            if hier:
                return submit_shuffle_tiered(
                    self.topology, plan, rows, nvalid, vt, val_dtype,
                    node.device, **self._tier_hooks(rep.trace_id), **kw)
            if distributed:
                return submit_shuffle_distributed(
                    plan, rows, nvalid_local, shard_ids, vt, val_dtype,
                    node.device, node.pool, **kw)
            return submit_shuffle(plan, rows, nvalid, vt, val_dtype,
                                  node.device, **kw)

        local_rows = np.sum(local[1] if distributed else nvalid)
        pending = self._dispatch_read(handle, rep, dispatch, stage_buf,
                                      release_admitted, nvalid, width,
                                      int(local_rows))
        if self._integrity_for(handle.tenant) == "full":
            # the post-exchange check runs inside result() itself
            pending._post_result = lambda res: self._verify_full_result(
                handle, res, combine)
        return pending

    def _tier_hooks(self, trace_id: str) -> Dict:
        """The tiered exchange's per-tier deadlines, fault sites, flight
        recorder and the read's trace id."""
        return dict(timeouts=tier_timeouts(self.conf),
                    faults=self.node.faults, flight=self.node.flight,
                    trace_id=trace_id)

    def _dispatch_read(self, handle: ShuffleHandle, rep: ExchangeReport,
                       dispatch, stage_buf, release_admitted,
                       nvalid: np.ndarray, width: int,
                       local_rows: int):
        """``dispatch(on_done)`` of a single-shot read with the
        settlement every read shares: the pack buffer and the admission
        released (a device result holds its reservation until consumed),
        the report's retries, regrown wire, tier walls and D2H, the
        capacity hint (from the global rows ``nvalid``) and the row
        counters (``local_rows``: this process's). The ``exchange`` fault
        site comes first: until the pending handle exists, a failure here
        hands the pack buffer and the admission back; after, its
        ``on_done`` does."""
        pending_box = {}
        total_rows = int(np.sum(nvalid))

        def on_done(result):
            t_settle = time.perf_counter()
            try:
                settle(result)
            finally:
                if self.node.tracer.enabled:
                    self.node.tracer.record_span(
                        "shuffle.settle", t_settle, trace=rep.trace_id)
                self._settle_report(rep, completed=result is not None)

        def settle(result):
            self.node.pool.put(stage_buf)
            if isinstance(result, DeviceShuffleReaderResult):
                # the receive buffers stay on the device until the
                # consumer takes them
                result._release_hbm = release_admitted
            else:
                release_admitted()
            ref = pending_box.get("pending")
            pend = ref() if ref is not None else None
            retries = pend._attempt if pend is not None else 0
            rep.group_ms = (time.perf_counter() - rep._t_dispatched) * 1e3
            rep.retries = int(retries)
            if retries and pend is not None:
                # the regrown plan padded to other capacities
                if rep.tiers:
                    # both hops under the final capacities
                    self._stamp_tiers(rep, pend._plan, nvalid, width,
                                      dev_matrix=rep._tier_matrix,
                                      relay_cap=pend._relay_cap)
                else:
                    lay = ragged_layout(pend._plan, nvalid, width)
                    rep.wire_bytes = lay.wire_bytes
                    rep.pad_ratio = lay.pad_ratio
                self.node.metrics.inc("shuffle.retries", float(retries))
            if rep.tiers:
                self._settle_tiers(rep, getattr(pend, "tier_walls", None),
                                   completed=result is not None)
            if result is None:
                rep.error = rep.error or "exchange failed"
                return
            self._settle_volume(rep, width)
            if isinstance(result, LazyShuffleReaderResult):
                result.fetch_granularity = self.conf.fetch_granularity
            self._arm_d2h(result, rep)
            self._learn_cap(handle, result, total_rows)
            self.node.metrics.inc("shuffle.rows", float(local_rows))
            self.node.metrics.inc("shuffle.bytes",
                                  float(local_rows) * width * 4)
            rep.completed = True

        rep._t_dispatched = time.perf_counter()
        try:
            self.node.faults.check("exchange")
            with self.node.tracer.span(
                    "shuffle.dispatch", shuffle_id=handle.shuffle_id,
                    rows=total_rows, width=width,
                    hierarchical=self.hierarchical, trace=rep.trace_id):
                pending = dispatch(on_done)
        except BaseException:
            self.node.pool.put(stage_buf)
            release_admitted()
            raise
        pending_box["pending"] = weakref.ref(pending)
        rep.dispatch_ms = (time.perf_counter() - rep._t_dispatched) * 1e3
        return pending

    # -- the distributed read (shuffle/distributed.py) -------------------
    def _submit_distributed(self, handle: ShuffleHandle, timeout: float,
                            combine: Optional[str], ordered: bool,
                            combine_sum_words: int, sink: Optional[str]):
        sink = self._resolve_sink(sink, combine, ordered)
        rep = self._new_report(handle, distributed=True)
        rep.sink = sink
        try:
            with self.node.tracer.span("shuffle.submit",
                                       shuffle_id=handle.shuffle_id,
                                       trace=rep.trace_id):
                return self._submit_distributed_impl(
                    handle, timeout, combine, ordered, combine_sum_words,
                    rep, sink)
        except BaseException as e:
            rep.error = rep.error or repr(e)[:300]
            self.node.flight.end_trace(rep.trace_id)
            raise

    def _submit_distributed_impl(self, handle: ShuffleHandle,
                                 timeout: float, combine: Optional[str],
                                 ordered: bool, combine_sum_words: int,
                                 rep: ExchangeReport, sink: str):
        """COLLECTIVE: the completeness barrier, then the staged submit.
        Map outputs stay on the process that committed them."""
        if self.conf.a2a_impl == "pallas":
            # conf facts only: every process raises here, before any
            # collective
            raise NotImplementedError(
                "a2a.impl='pallas' on a distributed node: the segment-move "
                "kernel is device-local and cannot move rows between "
                "processes; use dense or gather (or auto) for multi-process "
                "reads")
        shard_ids = self.node.local_shard_ids
        limit = self.conf.meta_buffer_size
        if (handle.num_maps + 1) * 8 > limit:
            raise ValueError(
                f"shuffle {handle.shuffle_id}: presence bitmap "
                f"({(handle.num_maps + 1) * 8} B for {handle.num_maps} "
                f"maps) exceeds meta.bufferSize={limit}; raise "
                f"spark.shuffle.tpu.meta.bufferSize")
        with self.node.tracer.span("shuffle.barrier", kind="map_outputs",
                                   shuffle_id=handle.shuffle_id,
                                   trace=rep.trace_id):
            committed = self._completeness_barrier(handle, timeout)
        # the snapshot is retaken under the in-flight guard: the barrier's
        # predates it, and a remesh in between could release its writers
        guard = _ReadGuard(self)
        try:
            with self._lock:
                writers = {m: w for m, w in
                           self._writers.get(handle.shuffle_id, {}).items()
                           if w.committed}
            # the stale-snapshot verdict rides a collective too: one
            # process raising while its peers enter the schema allgather
            # would hang them
            changed = int(sorted(writers) != committed)
            if allgather_blob(np.array([changed], dtype=np.int64),
                              what="staging snapshot verdict").any():
                raise RuntimeError(
                    f"shuffle {handle.shuffle_id}: committed map outputs "
                    f"changed between the completeness barrier and staging "
                    f"on at least one process (remesh or unregister raced "
                    f"this read)")
            return self._submit_distributed_staged(
                handle, writers, shard_ids, combine, ordered,
                combine_sum_words, rep, sink, guard)
        except BaseException:
            guard.close()
            raise

    def _completeness_barrier(self, handle: ShuffleHandle,
                              timeout: float) -> List[int]:
        """COLLECTIVE: poll the presence bitmap of the DISTINCT map ids (a
        count would let a duplicate commit mask a missing map) until
        every map of the shuffle is committed on some process; returns
        this process's committed map ids. The timeout bit rides the
        allgather, so one process's expired clock makes every process
        raise together."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if handle.shuffle_id not in self._writers:
                    raise RuntimeError(
                        f"shuffle {handle.shuffle_id} is not registered "
                        f"with this manager (already unregistered?)")
                committed = sorted(
                    m for m, w in self._writers[handle.shuffle_id].items()
                    if w.committed)
            bitmap = np.zeros(handle.num_maps + 1, dtype=np.int64)
            bitmap[committed] = 1
            bitmap[-1] = 1 if time.monotonic() > deadline else 0
            gathered = allgather_blob(bitmap, what="completeness barrier")
            owners = gathered[:, :-1].sum(axis=0)
            if (owners > 1).any():
                dups = np.nonzero(owners > 1)[0].tolist()
                raise RuntimeError(
                    f"shuffle {handle.shuffle_id}: map ids {dups} committed "
                    f"by multiple processes — ambiguous ownership (maps "
                    f"must be partitioned over processes)")
            total = int((owners > 0).sum())
            if total >= handle.num_maps:
                return committed
            if gathered[:, -1].any():
                raise TimeoutError(
                    f"shuffle {handle.shuffle_id}: only {total}/"
                    f"{handle.num_maps} map outputs published within "
                    f"{timeout}s")
            time.sleep(0.05)

    def _agree_schema(self, has_vals: bool, val_tail, val_dtype,
                      local_rows: int) -> tuple:
        """COLLECTIVE: one value schema over every process; a process
        that staged no rows adopts the cluster's. Returns (has_vals,
        val_tail, val_dtype)."""
        blob = np.full(8, -1, dtype=np.int64)
        if local_rows:
            blob[0] = 1 if has_vals else 0
        if has_vals:
            if len(val_tail) > 5:
                raise ValueError(
                    f"value rank {len(val_tail)} > 5 unsupported in "
                    f"multi-process mode; flatten the trailing dims")
            dt = np.dtype(val_dtype).str.encode()[:6]
            blob[1] = int.from_bytes(dt, "little")
            blob[2] = len(val_tail)
            blob[3:3 + len(val_tail)] = val_tail
        schemas = allgather_blob(blob, what="schema agreement")
        known = schemas[schemas[:, 0] >= 0]
        if known.size:
            if not (known == known[0]).all():
                raise ValueError(
                    f"mixed value schema across processes: {schemas}")
            ref = known[0]
            if ref[0] == 1 and not has_vals:
                val_dtype = np.dtype(
                    int(ref[1]).to_bytes(6, "little").rstrip(b"\0")
                    .decode())
                val_tail = tuple(int(x) for x in ref[3:3 + int(ref[2])])
            has_vals = bool(ref[0])
        return has_vals, val_tail, val_dtype

    def _agreed_dev_matrix(self, handle: ShuffleHandle, writers,
                           shard_ids) -> np.ndarray:
        """COLLECTIVE: the exact ``[P, P]`` source x destination row
        matrix of a distributed tiered read: each process sums its own
        maps' size rows (source shard ``shard_ids[ordinal % L]``, the
        staging rule) and the cluster matrix is the agreed sum."""
        Pn, L = self.node.num_shards, len(shard_ids)
        local = np.zeros((Pn, Pn), dtype=np.int64)
        red_to_dev = blocked_partition_map(handle.num_partitions, Pn)
        for ordinal, mid in enumerate(sorted(writers)):
            sizes = np.asarray(handle.entry.fetch_record(mid),
                               dtype=np.int64)
            np.add.at(local[int(shard_ids[ordinal % L])], red_to_dev, sizes)
        return agree("tier.crossRows", local.reshape(-1), reduce="sum",
                     conf_key="spark.shuffle.tpu.a2a.topology",
                     metrics=self.node.metrics).reshape(Pn, Pn)

    def _submit_distributed_staged(self, handle: ShuffleHandle, writers,
                                   shard_ids, combine: Optional[str],
                                   ordered: bool, combine_sum_words: int,
                                   rep: ExchangeReport, sink: str,
                                   guard: "_ReadGuard"):
        node = self.node
        Pn, L = node.num_shards, len(shard_ids)
        shard_outputs, has_vals, val_tail, val_dtype = \
            self._materialize_outputs(writers, L, handle.entry, rep,
                                      by_ordinal=True)
        nvalid_local = np.array(
            [sum(k.shape[0] for k, _ in outs) for outs in shard_outputs],
            dtype=np.int64)
        has_vals, val_tail, val_dtype = self._agree_schema(
            has_vals, val_tail, val_dtype, int(nvalid_local.sum()))
        nvalid = allgather_sizes(nvalid_local, shard_ids, Pn)
        validate_row_sizes(nvalid.reshape(1, -1))
        if self._integrity_for(handle.tenant) == "full" and not combine:
            # the receivers need the global per-partition digest tables
            self._stash_full_expect(handle, writers)

        t_plan = time.perf_counter()
        with node.tracer.span("shuffle.plan", shuffle_id=handle.shuffle_id,
                              trace=rep.trace_id):
            plan = make_plan(nvalid, Pn, handle.num_partitions, self.conf,
                             node.device, partitioner=handle.partitioner,
                             bounds=handle.bounds, sink=sink,
                             hierarchical=self.hierarchical,
                             distributed=True)
            # every process runs the same reads, so the learned hints
            # advance in lockstep
            plan = self._apply_cap_hint(plan, handle, int(nvalid.sum()))
        with node.tracer.span("shuffle.plan", shuffle_id=handle.shuffle_id,
                              decorate=True, trace=rep.trace_id):
            plan = self._decorated_plan(plan, combine, ordered, has_vals,
                                        val_tail, val_dtype,
                                        combine_sum_words, sink=sink)
        rep.plan_ms = (time.perf_counter() - t_plan) * 1e3
        width = KEY_WORDS + (value_words(val_tail, val_dtype)
                             if has_vals else 0)
        # no process holds the [M, R] table: skew from the size row
        return self._submit_planned(
            handle, rep, plan, shard_outputs, nvalid, width, has_vals,
            val_tail, val_dtype, combine, ordered, None, part_rows=nvalid,
            dev_matrix=lambda: self._agreed_dev_matrix(handle, writers,
                                                       shard_ids),
            guard=guard, local=(shard_ids, nvalid_local))

    def _report_volume(self, rep: ExchangeReport, plan: ShufflePlan,
                       nvalid: np.ndarray, width: int,
                       part_rows: np.ndarray,
                       local_rows: Optional[int] = None) -> None:
        """The report's volume, skew and plan fields. ``local_rows``:
        this process's staged rows on a distributed node (None: all)."""
        layout = ragged_layout(plan, nvalid, width)
        rep.impl = layout.impl
        rep.wire = layout.wire
        rep.kernel = plan.kernel_impl
        rep.payload_bytes = layout.payload_bytes
        rep.wire_bytes = layout.wire_bytes
        rep.pad_ratio = layout.pad_ratio
        rep._wire_gain = (width * 4 / layout.wire_row_bytes) \
            if layout.wire == "int8" and layout.wire_row_bytes else 1.0
        rep.plan_bucket = [int(plan.cap_in), int(plan.cap_out)]
        rep.peer_rows = [int(x) for x in nvalid]
        rep.peer_bytes = [r * width * 4 for r in rep.peer_rows]
        rep.rows_global = sum(rep.peer_rows)
        rep.rows_local = rep.rows_global if local_rows is None \
            else int(local_rows)
        rep.bytes_local = rep.rows_local * width * 4
        skew = [int(x) for x in part_rows]
        mean = sum(skew) / len(skew) if skew else 0.0
        rep.skew_ratio = max(skew) / mean if mean > 0 else 0.0
        metrics = self.node.metrics
        for r, b in zip(rep.peer_rows, rep.peer_bytes):
            metrics.observe(H_PEER_ROWS, float(r))
            metrics.observe(H_PEER_BYTES, float(b))

    # -- topology plane (shuffle/topology.py) ------------------------------
    def _set_tiers(self, rep: ExchangeReport, tiers: List[Dict]) -> None:
        """``rep.tiers`` and the headline wire accounting as the two-hop
        sum — the exchange's cost over both tiers, replacing the flat
        single-exchange figure ``_report_volume`` stamped."""
        rep.tiers = tiers
        wire = sum(t["wire_bytes"] for t in tiers)
        rep.wire_bytes = int(wire)
        rep.pad_ratio = round(wire / rep.payload_bytes, 6) \
            if rep.payload_bytes else 0.0

    def _stamp_tiers(self, rep: ExchangeReport, plan: ShufflePlan, nvalid,
                     width: int, dev_matrix=None, relay_cap=None) -> None:
        """The per-tier entries of a single-shot hierarchical read; the
        ``[P, P]`` ``dev_matrix`` (the metadata table's) makes their
        cross rows exact."""
        rep._tier_matrix = None if dev_matrix is None \
            else np.asarray(dev_matrix)
        self._set_tiers(rep, tier_layouts(plan, self.topology, nvalid,
                                          width, dev_matrix=dev_matrix,
                                          relay_cap=relay_cap))

    def _stamp_wave_tiers(self, rep: ExchangeReport, wplan: ShufflePlan,
                          wave_sizes, width: int) -> None:
        """Waved hierarchical accounting: W tiered exchanges of the wave
        plan's shape, the wire cost per wave and the payload the summed
        real rows. The device matrix is whole-exchange, so the entries
        carry the every-row bound (``cross_exact`` false)."""
        tiers = None
        for n in wave_sizes:
            lays = tier_layouts(wplan, self.topology, np.asarray([int(n)]),
                                width)
            if tiers is None:
                tiers = lays
                continue
            for acc, lay in zip(tiers, lays):
                for k in ("payload_rows", "payload_bytes", "wire_rows",
                          "wire_bytes"):
                    acc[k] += lay[k]
        for t in tiers or []:
            t["pad_ratio"] = round(t["wire_bytes"] / t["payload_bytes"], 6) \
                if t["payload_bytes"] else 0.0
            t["rows_in"] = int(sum(int(n) for n in wave_sizes))
        self._set_tiers(rep, tiers or [])

    def _settle_tiers(self, rep: ExchangeReport, tier_walls,
                      completed: bool = True) -> None:
        """Stamp the measured per-tier walls onto ``rep.tiers`` and count
        each tier's wire bytes into ``shuffle.tier.bytes{tier, tenant}``
        (this process's share of the global figure) — once per read. A
        failed read keeps its walls but counts no bytes."""
        if tier_walls:
            settle_tier_walls(rep.tiers, tier_walls)
        if not completed:
            return
        tid = rep.tenant or self._tenants.default_id
        frac = self._local_share()
        for t in rep.tiers:
            self.node.metrics.inc(labeled(C_TIER_BYTES, tier=t["tier"],
                                          tenant=tid),
                                  float(t["wire_bytes"]) * frac)

    def _local_share(self) -> float:
        """This process's fraction of the shards: the share of a global
        wire figure its counters carry (1 on one process), so the sum
        over the processes is the global figure."""
        return len(self.node.local_shard_ids) / max(self.node.num_shards, 1)

    def _settle_volume(self, rep: ExchangeReport, width: int) -> None:
        """A completed read's rates and volume counters: ``bw_gbps`` (the
        payload over ``group_ms``), ``effective_bw_gbps`` (times the
        int8 tier's row-width gain), and ``shuffle.payload.bytes`` /
        ``shuffle.wire.bytes`` with their ``{tenant}`` twins (this
        process's staged bytes and its share of the wire bytes)."""
        if rep.group_ms > 0:
            payload = rep.payload_bytes or rep.rows_global * width * 4
            gbps = payload / (rep.group_ms * 1e6)
            rep.bw_gbps = round(gbps, 6)
            rep.effective_bw_gbps = round(gbps * rep._wire_gain, 6)
            self.node.metrics.observe(H_BW, gbps)
        if not rep.payload_bytes:
            return
        metrics = self.node.metrics
        tid = rep.tenant or self._tenants.default_id
        for name, value in (
                (C_PAYLOAD_BYTES, float(rep.rows_local) * width * 4),
                (C_WIRE_BYTES, float(rep.wire_bytes) * self._local_share())):
            metrics.inc(name, value)
            metrics.inc(labeled(name, tenant=tid), value)

    def _estimate_wire_error(self, rep: ExchangeReport, plan: ShufflePlan,
                             slot_outputs) -> None:
        """An int8 read's ``wire_dequant_error``: the first
        ``a2a.wireErrorSampleRows`` staged value rows (shard by shard, in
        map order) through ``shuffle/wire.estimate_dequant_error``."""
        limit = self.conf.wire_error_sample_rows
        if not plan_takes_seed(plan) or limit <= 0:
            return
        sample, left = [], limit
        for outs in slot_outputs:
            for _keys, vals in outs:
                if left <= 0:
                    break
                if vals is None or not vals.shape[0]:
                    continue
                take = min(left, vals.shape[0])
                sample.append(np.asarray(vals[:take], dtype=np.float32)
                              .reshape(take, -1))
                left -= take
        if sample:
            rep.wire_dequant_error = round(estimate_dequant_error(
                np.concatenate(sample), sample_rows=limit), 6)

    def _arm_d2h(self, result, rep: ExchangeReport) -> None:
        """Join a result's device-to-host payload pulls onto its report:
        a lazy result drains on first touch, after the read, so
        ``rep.d2h_bytes`` keeps growing on the live report. A device
        result arms its wave views, so a ``host_view()`` drain is charged
        to the read that made it."""
        def cb(n, _rep=rep):
            _rep.d2h_bytes += int(n)
        views = result.wave_views() if isinstance(
            result, DeviceShuffleReaderResult) else [result]
        for v in views:
            v._d2h_cb = cb
            # a distributed host view drained as its read settled
            cb(getattr(v, "d2h_bytes", 0))

    # -- admission (a2a.maxBytesInFlight) ---------------------------------
    @staticmethod
    def _exchange_footprint(plan: ShufflePlan, width: int,
                            stage_bytes: int) -> int:
        """Approximate bytes a pending exchange holds until it settles:
        the pinned pack buffer plus the device send and receive row
        matrices. An estimate: the cap is backpressure, not a ledger."""
        device = (plan.cap_in + plan.cap_out) * width * 4 * plan.num_shards
        return int(stage_bytes) + int(device)

    def _tenant_fits_locked(self, tenant: str, nbytes: int) -> bool:
        """Whether one tenant's reservation fits now (under the lock):
        global room (an exchange bigger than the cap is admitted when
        nothing is in flight, so it cannot deadlock itself) and room in
        the tenant's ``maxBytesInFlight`` quota (the same rule: a tenant
        holding nothing is admitted)."""
        cap = self.conf.max_bytes_in_flight
        if self._inflight_bytes and self._inflight_bytes + nbytes > cap:
            return False
        quota = self._tenants.spec(tenant).max_bytes_in_flight
        if quota > 0:
            held = self._inflight_by_tenant.get(tenant, 0)
            if held and held + nbytes > quota:
                return False
        return True

    def _tenant_quota_blocked_locked(self, tenant: str,
                                     nbytes: int) -> bool:
        """True when global room exists but the tenant's own quota
        refuses the reservation: the one case the fair-share queue
        bypasses its head for."""
        cap = self.conf.max_bytes_in_flight
        if self._inflight_bytes and self._inflight_bytes + nbytes > cap:
            return False
        quota = self._tenants.spec(tenant).max_bytes_in_flight
        if quota <= 0:
            return False
        held = self._inflight_by_tenant.get(tenant, 0)
        return bool(held) and held + nbytes > quota

    def _fits_inflight_locked(self, nbytes: int, ticket=None,
                              tenant: Optional[str] = None) -> bool:
        """Whether a reservation may be granted now (under the lock). A
        submit-time attempt (``ticket`` None) yields to every deferred
        one, so a later submit never takes capacity freed for a queued
        exchange; a queued ticket is granted when the admission queue
        serves it (DRR across tenants, FIFO within one)."""
        tid = self._tenants.resolve(tenant)
        if ticket is None:
            if self._admit_queue:
                return False
            return self._tenant_fits_locked(tid, nbytes)
        return self._admit_queue.grantable(
            self._tenant_fits_locked,
            self._tenant_quota_blocked_locked) == ticket

    def _grant_inflight_locked(self, tenant: str, nbytes: int) -> None:
        """Account one grant (under the lock): the bytes in flight in all
        and per tenant, the grant counts, ``shuffle.admit.bytes`` (and
        its {tenant} twin) and the tenant's ``shuffle.inflight.bytes``
        gauge."""
        self._inflight_bytes += nbytes
        held = self._inflight_by_tenant.get(tenant, 0) + nbytes
        self._inflight_by_tenant[tenant] = held
        self._grant_seq += 1
        self._grant_count_by_tenant[tenant] = \
            self._grant_count_by_tenant.get(tenant, 0) + 1
        metrics = self.node.metrics
        metrics.inc(C_ADMIT_BYTES, float(nbytes))
        metrics.inc(labeled(C_ADMIT_BYTES, tenant=tenant), float(nbytes))
        metrics.set_gauge(labeled(G_TENANT_INFLIGHT, tenant=tenant), held)

    def _release_inflight(self, nbytes: int,
                          tenant: Optional[str] = None) -> None:
        if nbytes <= 0:
            return
        tid = self._tenants.resolve(tenant)
        with self._inflight_cv:
            self._inflight_bytes -= nbytes
            held = self._inflight_by_tenant.get(tid, 0) - nbytes
            if held > 0:
                self._inflight_by_tenant[tid] = held
            else:
                self._inflight_by_tenant.pop(tid, None)
            self.node.metrics.set_gauge(
                labeled(G_TENANT_INFLIGHT, tenant=tid), max(0, held))
            self._inflight_cv.notify_all()

    def _observe_admit(self, tenant: str, waited_ms: float) -> None:
        metrics = self.node.metrics
        metrics.observe(H_ADMIT_WAIT, waited_ms)
        metrics.observe(labeled(H_ADMIT_WAIT, tenant=tenant), waited_ms)

    def _make_admitter(self, plan: ShufflePlan, width: int,
                       stage_bytes: int, timeout: Optional[float],
                       tenant: Optional[str] = None,
                       report: Optional[ExchangeReport] = None):
        """(admit, release) for one exchange of ``tenant``.
        ``admit(block)`` goes to the pending handle (None when the cap is
        off): ``admit(False)`` grants or enqueues and returns whether it
        granted; ``admit(True)`` waits until the admission queue serves
        the ticket and the reservation fits, or raises ``TimeoutError``
        after ``timeout`` seconds. ``release()`` is idempotent, and takes
        a still-queued ticket out of the queue. Every grant observes its
        wait into ``shuffle.admit.wait_ms`` (and its {tenant} twin; 0 for
        an immediate grant); a deferred grant also observes the grants
        other tenants received while it waited into
        ``shuffle.admit.cross_grants{tenant}``."""
        if self.conf.max_bytes_in_flight <= 0:
            return None, lambda: None
        tid = self._tenants.resolve(tenant)
        nbytes = self._exchange_footprint(plan, width, stage_bytes)
        state = {"reserved": 0, "ticket": None, "queued_at": 0.0,
                 "seq0": 0, "own0": 0}

        def admit(block: bool) -> bool:
            with self._inflight_cv:
                if not block:
                    if self._fits_inflight_locked(nbytes, tenant=tid):
                        self._grant_inflight_locked(tid, nbytes)
                        state["reserved"] = nbytes
                        self._observe_admit(tid, 0.0)
                        return True
                    ticket = self._admit_ticket
                    self._admit_ticket += 1
                    self._admit_queue.enqueue(ticket, tid, nbytes)
                    state["ticket"] = ticket
                    state["queued_at"] = time.perf_counter()
                    state["seq0"] = self._grant_seq
                    state["own0"] = self._grant_count_by_tenant.get(tid, 0)
                    log.info("submit deferred by maxBytesInFlight=%d "
                             "(tenant %s, in flight %d B, requesting %d B, "
                             "queue depth %d)",
                             self.conf.max_bytes_in_flight, tid,
                             self._inflight_bytes, nbytes,
                             self._admit_queue.depth())
                    return False
                ticket = state["ticket"]
                deadline = None if timeout is None \
                    else time.monotonic() + timeout
                while not self._fits_inflight_locked(nbytes, ticket,
                                                     tenant=tid):
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"deferred exchange (tenant {tid}) waited "
                                f"{timeout}s: "
                                f"{self._inflight_bytes} B in flight "
                                f"exceeds a2a.maxBytesInFlight="
                                f"{self.conf.max_bytes_in_flight} and no "
                                f"exchange completed — resolve earlier "
                                f"submits or raise the cap")
                        self._inflight_cv.wait(min(remaining, 1.0))
                    else:
                        self._inflight_cv.wait(1.0)
                self._admit_queue.pop(ticket, nbytes)
                state["ticket"] = None
                # grants to other tenants while this ticket waited, taken
                # before this grant lands in the counts
                cross = (self._grant_seq - state["seq0"]) - (
                    self._grant_count_by_tenant.get(tid, 0) - state["own0"])
                self._grant_inflight_locked(tid, nbytes)
                state["reserved"] = nbytes
                t_grant = time.perf_counter()
                waited = (t_grant - state["queued_at"]) * 1e3
                if report is not None:
                    # the deferred admission's wall, enqueue to grant
                    self.node.tracer.record_span(
                        "shuffle.admit.wait", state["queued_at"], t_grant,
                        trace=report.trace_id, tenant=tid)
                self._observe_admit(tid, waited)
                self.node.metrics.observe(
                    labeled(H_ADMIT_CROSS, tenant=tid), float(max(0, cross)))
                if report is not None:
                    report.admit_wait_ms += waited
                self._inflight_cv.notify_all()
                return True

        def release() -> None:
            with self._inflight_cv:
                if state["ticket"] is not None:
                    # abandoned while queued: unblock those behind it
                    self._admit_queue.discard(state["ticket"])
                    state["ticket"] = None
                    self._inflight_cv.notify_all()
                n, state["reserved"] = state["reserved"], 0
            self._release_inflight(n, tenant=tid)

        return admit, release

    # -- sinks ------------------------------------------------------------
    def _note_sink_fallback(self, mode: str, reason: str) -> None:
        """A read that asked for the device sink landed on the host."""
        m = self.node.metrics
        m.inc(C_SINK_FALLBACK, 1.0)
        m.inc(labeled(C_SINK_FALLBACK, mode=mode, reason=reason), 1.0)

    def _resolve_sink(self, requested: Optional[str],
                      combine: Optional[str] = None,
                      ordered: bool = False) -> str:
        """The sink this read runs from the per-read ask and the
        ``read.sink`` conf; the report's ``sink`` names it. Conf ``auto``
        (the default): host unless the read asks for the device; conf
        ``device``: device unless the read asks for the host; conf
        ``host`` pins the host, and a per-read device ask under it lands
        on the host, warned once and counted in
        ``shuffle.sink.fallback.count`` (reason ``conf_pins_host``). The
        device sink holds for every read mode, waved or not."""
        if requested is not None:
            validate_sink(requested, conf_key="read(sink=...)")
            if requested == "auto":
                requested = None
        mode = "combine" if combine else ("ordered" if ordered else "plain")
        conf = self.conf.read_sink
        want = requested
        if want is None:
            want = "device" if conf == "device" else "host"
        elif want == "device" and conf == "host":
            self._warn_once("conf_pins_host",
                            "read(sink='device') under read.sink=host: the "
                            "conf pins the host drain; set read.sink=auto "
                            "(or device) to honour per-read device sinks")
            self._note_sink_fallback(mode, "conf_pins_host")
            want = "host"
        return want

    # -- waved reads (a2a.waveRows) ----------------------------------------
    def _waves_eligible(self, plan: ShufflePlan) -> bool:
        """Whether a2a.waveRows applies to this read: not under an
        explicit ``a2a.impl=pallas`` (``auto`` never resolves to it on a
        waved read), whose chunk-aligned move stays single-shot, as in
        the JAX package."""
        if plan.impl == "pallas":
            log.info("a2a.waveRows set with impl='pallas': single-shot "
                     "read (the segment-move kernel runs unwaved)")
            return False
        return True

    @staticmethod
    def _set_wave_wire(rep: ExchangeReport, wplan: ShufflePlan, wave_sizes,
                       width: int) -> None:
        """Waved wire accounting: the per-wave layout costs under the
        (current) wave plan, over the whole payload."""
        wire = sum(
            ragged_layout(wplan, np.asarray([int(s)]), width).wire_bytes
            for s in wave_sizes)
        rep.wire_bytes = int(wire)
        rep.pad_ratio = round(wire / rep.payload_bytes, 6) \
            if rep.payload_bytes else 0.0

    def _submit_waved(self, handle: ShuffleHandle, slot_outputs,
                      nvalid: np.ndarray, plan: ShufflePlan, width: int,
                      has_vals: bool, val_tail, val_dtype,
                      rep: ExchangeReport, num_waves: int,
                      timeout: Optional[float], guard: "_ReadGuard",
                      distributed: bool = False) -> "PendingWaveShuffle":
        """The pending handle of a waved read; the packs run inside its
        ``result()``, overlapped with the waves' exchanges, and the
        handle closes the read's ``guard`` after the last one. The
        ``exchange`` fault site comes before the handle exists.
        Distributed, ``slot_outputs`` are this process's shards, the
        per-wave sizes are agreed, and admission never times out (a
        local clock must not fail one process while its peers enter the
        next collective)."""
        wave_rows = self.conf.wave_rows
        outer = dataclasses.replace(plan, wave_rows=wave_rows,
                                    num_waves=num_waves)
        wplan = wave_step_plan(outer, self.conf)
        with self._lock:
            hint = self._wave_cap_hints.get(
                (self._cap_key(handle), wplan.cap_in), 0)
        if hint > wplan.cap_out:
            # a same-shape read already settled its wave capacity
            wplan = dataclasses.replace(wplan, cap_out=hint)
        wave_sizes = wave_payload_rows(nvalid, wave_rows, num_waves)
        if distributed:
            wave_sizes = agree_wave_sizes(wave_sizes, self.node.metrics)
        rep.waves = num_waves
        rep.wave_rows = wave_rows
        rep.wave_payload_rows = [int(x) for x in wave_sizes]
        rep.plan_bucket = [int(wplan.cap_in), int(wplan.cap_out)]
        self._set_wave_wire(rep, wplan, wave_sizes, width)
        if rep.tiers:
            # hierarchical waves: the per-tier pairs summed over the waves
            self._stamp_wave_tiers(rep, wplan, wave_sizes, width)
        # the tenant's waveDepth wins over a2a.waveDepth
        spec_depth = self._tenants.spec(handle.tenant).wave_depth
        depth = max(1, min(spec_depth or self.conf.wave_depth, num_waves))
        # admission: ``depth`` pinned wave blocks plus the device buffers
        # of ``depth`` waves on the host sink (a wave holds its send and
        # receive matrices until it drains), of every wave on the device
        # sink (no wave drains); _make_admitter adds one wave's device
        # term itself
        block_bytes = len(slot_outputs) * wplan.cap_in * width * 4
        device_wave = (wplan.cap_in + wplan.cap_out) * width * 4 \
            * wplan.num_shards
        hbm_waves = num_waves if wplan.sink == "device" else depth
        admit, release_admitted = self._make_admitter(
            wplan, width,
            depth * block_bytes + (hbm_waves - 1) * device_wave,
            None if distributed else timeout, tenant=handle.tenant,
            report=rep)
        try:
            self.node.faults.check("exchange")
        except BaseException:
            release_admitted()
            raise
        log.info("wave-pipelined read: shuffle %d, %d waves x %d rows/shard "
                 "(depth %d, wave plan cap_in=%d cap_out=%d)",
                 handle.shuffle_id, num_waves, wave_rows, depth,
                 wplan.cap_in, wplan.cap_out)
        local_rows = sum(int(k.shape[0])
                         for outs in slot_outputs for k, _ in outs)
        return PendingWaveShuffle(self, handle, outer, wplan, depth,
                                  slot_outputs, width, has_vals, val_tail,
                                  val_dtype, rep, local_rows, wave_sizes,
                                  guard, admit, release_admitted,
                                  distributed=distributed)

    # -- wire tiers -------------------------------------------------------
    def _warn_once(self, key: str, msg: str, *args) -> None:
        with self._lock:
            first = key not in self._warned
            self._warned.add(key)
        if first:
            log.warning(msg, *args)

    def _resolve_wire(self, plan: ShufflePlan, has_vals: bool, val_tail,
                      val_dtype) -> tuple:
        """The (wire, wire_words) pair a read runs from the ``a2a.wire``
        conf: int8 needs float32 value lanes (keys and integer payloads
        stay exact) and a real exchange between shards; a read without
        them runs raw, logged with the reason. lossless fits any schema.
        (The JAX package's strip-sorted path, which also resolves raw,
        has no counterpart here.)"""
        wire = self.conf.a2a_wire
        if wire != "int8":
            return wire, 0
        reason = None
        if plan.num_shards == 1:
            reason = "one shard: no exchange between shards"
        elif not has_vals:
            reason = "keys-only payload (key lanes stay exact)"
        elif np.dtype(val_dtype) != np.float32:
            reason = (f"value dtype {np.dtype(val_dtype).str} is not "
                      f"float32 (integer lanes stay exact)")
        if reason is not None:
            log.info("a2a.wire=int8 resolves to raw for this read: %s",
                     reason)
            return "raw", 0
        return "int8", value_words(val_tail, val_dtype)

    def _note_inert_lossless(self, plan: ShufflePlan) -> None:
        """Warn once that ``a2a.wire=lossless`` does nothing on a read
        that runs single-shot (the codec runs on the wave drain path):
        such reads report ``lossless_bytes=0``."""
        if plan.wire == "lossless":
            self._warn_once(
                "lossless_single_shot",
                "a2a.wire=lossless on a single-shot read: the codec runs on "
                "the wave drain path only (set spark.shuffle.tpu.a2a."
                "waveRows); such reads report lossless_bytes=0")

    # -- read options -----------------------------------------------------
    def _decorated_plan(self, plan: ShufflePlan, combine: Optional[str],
                        ordered: bool, has_vals: bool, val_tail, val_dtype,
                        combine_sum_words: int = 0,
                        sink: str = "host") -> ShufflePlan:
        """Validate the combine/ordered read options and stamp them, the
        sink and the resolved wire tier (:meth:`_resolve_wire`) on the
        plan. combine implies ordered output, so it takes precedence;
        ``combine_sum_words`` > 0 sums only that many leading value words
        and carries the rest per key."""
        wire, wire_words = self._resolve_wire(plan, has_vals, val_tail,
                                              val_dtype)
        plan = dataclasses.replace(plan, wire=wire, wire_words=wire_words,
                                   sink=sink)
        if sink == "device" and wire == "lossless":
            self._warn_once(
                "lossless_device",
                "a2a.wire=lossless with a device sink: the codec is "
                "host-only (it runs on the drain path) and will not run; "
                "device-sink reads report lossless_bytes=0")
        if combine:
            check_combinable(val_tail if has_vals else None,
                             val_dtype if has_vals else None, combine)
            vw = value_words(val_tail, val_dtype)
            if combine_sum_words < 0 or combine_sum_words > vw:
                raise ValueError(
                    f"combine_sum_words={combine_sum_words} out of "
                    f"[0, {vw}] for this value schema")
            return self._stamp_kernel(dataclasses.replace(
                plan, combine=combine, combine_words=vw,
                combine_dtype=np.dtype(val_dtype).str,
                combine_sum_words=combine_sum_words))
        if ordered:
            return self._stamp_kernel(dataclasses.replace(plan, ordered=True))
        return plan

    def _stamp_kernel(self, plan: ShufflePlan) -> ShufflePlan:
        """Resolve ``read.mergeImpl`` for a combine/ordered plan
        (ops/segmented.resolve_kernel_impl) and stamp it: the step
        branches on ``plan.kernel_impl`` and the report names it. An ask
        for the kernel that resolves to jnp counts into
        C_KERNEL_FALLBACK with its reason."""
        impl, reason = resolve_kernel_impl(
            self.conf.read_merge_impl, self.node.device,
            combine_dtype=plan.combine_dtype or None)
        if reason is not None:
            m = self.node.metrics
            m.inc(C_KERNEL_FALLBACK, 1.0)
            m.inc(labeled(C_KERNEL_FALLBACK, reason=reason), 1.0)
            self._warn_once(reason, "read.mergeImpl=%s resolves to jnp on "
                            "this read: %s (the report's 'kernel' field "
                            "names what ran)", self.conf.read_merge_impl,
                            reason)
        return dataclasses.replace(plan, kernel_impl=impl)

    # -- capacity hints ---------------------------------------------------
    @staticmethod
    def _cap_key(handle: ShuffleHandle) -> tuple:
        return (handle.num_maps, handle.num_partitions, handle.partitioner)

    def _apply_cap_hint(self, plan: ShufflePlan, handle: ShuffleHandle,
                        total_rows: int) -> ShufflePlan:
        """Seed cap_out with the skew factor a previous same-shape read
        settled at (stored volume-normalized: capacity over the balanced
        share), quantized by the same bucket ladder as make_plan."""
        with self._lock:
            factor = self._cap_hints.get(self._cap_key(handle))
        if not factor:
            return plan
        balanced = max(1.0, total_rows / max(plan.num_shards, 1))
        hint = bucket_cap_conf(
            int(np.ceil(balanced * factor / 8.0 - 1e-6)) * 8, self.conf)
        if hint > plan.cap_out:
            return dataclasses.replace(plan, cap_out=hint)
        return plan

    def _learn_cap(self, handle: ShuffleHandle, result,
                   total_rows: int) -> None:
        """Update the shape's skew-factor hint: track the delivered rows
        with 15% headroom (decaying toward them) where the result can see
        them; otherwise ratchet up to the provisioned capacity."""
        used = getattr(result, "cap_out_used", None)
        if not (used and total_rows):
            return
        balanced = max(1.0, total_rows / max(self.node.num_shards, 1))
        needed = getattr(result, "recv_rows_needed", None)
        key = self._cap_key(handle)
        with self._lock:
            cur = self._cap_hints.get(key, 0.0)
            if needed:
                observed = needed * 1.15 / balanced
                self._cap_hints[key] = (observed if observed >= cur
                                        else 0.5 * (cur + observed))
            elif used / balanced > cur:
                self._cap_hints[key] = used / balanced

    # -- staging ----------------------------------------------------------
    def _materialize_outputs(self, writers, num_slots: int,
                             entry: ShuffleEntry, rep: ExchangeReport,
                             by_ordinal: bool = False):
        """Committed map outputs grouped onto shards (``map_id % P``; with
        ``by_ordinal``, the i-th map in id order on slot ``i % num_slots``:
        a distributed process's maps over its local shards), with one
        agreed value schema. Unless ``integrity.verify=off`` every output
        is verified against its commit's record first
        (:meth:`_verified_materialize`), so no byte is packed before every
        map verified; ``rep`` gets the level and the bytes when any map
        published a record. Returns (slot_outputs, has_vals, val_tail,
        val_dtype)."""
        level = self._integrity_for(rep.tenant)
        verify = level != "off"
        if verify:
            outputs = self._verified_materialize(entry, writers)
        else:
            outputs = [(m, *w.materialize(), -1)
                       for m, w in sorted(writers.items())]
        verified_bytes = sum(nb for *_, nb in outputs if nb >= 0)
        verified_maps = sum(1 for *_, nb in outputs if nb >= 0)
        slot_outputs = [[] for _ in range(num_slots)]
        has_vals = False
        val_tail, val_dtype = None, None
        for ordinal, (map_id, keys, values, _) in enumerate(outputs):
            if values is not None and keys.shape[0]:
                has_vals = True
                if val_dtype is None:
                    val_tail, val_dtype = values.shape[1:], values.dtype
                elif (values.shape[1:], values.dtype) != (val_tail,
                                                          val_dtype):
                    raise ValueError(
                        f"mixed value schema across map outputs: mapId "
                        f"{map_id} wrote {values.dtype}{values.shape[1:]}, "
                        f"earlier outputs wrote {val_dtype}{val_tail}")
            slot = ordinal if by_ordinal else map_id
            slot_outputs[slot % num_slots].append((keys, values))
        if has_vals:
            for outs in slot_outputs:
                for keys, values in outs:
                    if keys.shape[0] and values is None:
                        raise ValueError(
                            "mixed schema: some map outputs have values, "
                            "others have keys only")
        if verify:
            if verified_bytes:
                self.node.metrics.inc(C_INTEGRITY_VERIFIED,
                                      float(verified_bytes))
            if verified_maps:
                # a shuffle whose maps published no record keeps
                # integrity="": no check ran
                rep.integrity = level
                rep.integrity_bytes += verified_bytes
        return slot_outputs, has_vals, val_tail, val_dtype

    def _pack_share(self, tenant: str) -> int:
        """A tenant's share of the pack executor's workers: all of them
        while it packs alone; with several tenants packing, split by
        priority weight (at least 1)."""
        workers = self._pack_workers()
        with self._lock:
            contending = [t for t, n in self._packing.items() if n > 0]
        if len(contending) <= 1:
            return workers
        weights = {t: self._tenants.spec(t).weight for t in contending}
        total = sum(weights.values()) or 1
        return max(1, (workers * weights.get(tenant, 1)) // total)

    def _pack_shards(self, slot_outputs, cap_in: int, width: int,
                     has_vals: bool, tenant: Optional[str] = None):
        """Fuse key+value bytes into one [P, cap_in, width] int32 matrix
        inside a staging-pool buffer (page-locked on CUDA) — the one host
        copy on the read path. Shards fill in parallel on the pack
        executor (numpy copies release the GIL); while packs of several
        tenants run, this pack keeps at most its tenant's
        :meth:`_pack_share` of fills in flight. Returns (rows tensor,
        pool buffer); the caller returns the buffer once the exchange
        settled."""
        tid = self._tenants.resolve(tenant)
        P = len(slot_outputs)
        buf = self.node.pool.get(P * cap_in * width * 4)
        rows_t = buf[:P * cap_in * width * 4].view(torch.int32) \
            .reshape(P, cap_in, width)
        rows = rows_t.numpy()

        def fill(p):
            off = 0
            for keys, values in slot_outputs[p]:
                n = keys.shape[0]
                if n:
                    pack_rows(keys, values if has_vals else None, width,
                              out=rows[p, off:off + n])
                off += n
            rows[p, off:] = 0       # recycled buffer: no stale rows

        with self._lock:
            self._packing[tid] = self._packing.get(tid, 0) + 1
        try:
            if P > 1 and rows.nbytes >= (1 << 20):
                ex = self._executor()
                share = self._pack_share(tid)
                if share >= self._pack_workers():
                    list(ex.map(fill, range(P)))
                else:
                    # a sliding window of ``share`` fills (topped up as
                    # each completes); the fills run on pack workers and
                    # submit nothing, so a window cannot deadlock
                    live = set()
                    for p in range(P):
                        live.add(ex.submit(fill, p))
                        if len(live) >= share:
                            done, live = futures_wait(
                                live, return_when=FIRST_COMPLETED)
                            for f in done:
                                f.result()
                    for f in live:
                        f.result()
            else:
                for p in range(P):
                    fill(p)
        except BaseException:
            self.node.pool.put(buf)
            raise
        finally:
            with self._lock:
                n = self._packing.get(tid, 1) - 1
                if n > 0:
                    self._packing[tid] = n
                else:
                    self._packing.pop(tid, None)
        return rows_t, buf

    def _pack_workers(self) -> int:
        """``a2a.packThreads`` (0 = ``coresPerProcess``), at least 1."""
        return max(1, int(self.conf.pack_threads
                          or self.conf.cores_per_process))

    def _executor(self) -> ThreadPoolExecutor:
        """The pack executor: :meth:`_pack_workers` workers."""
        with self._lock:
            if self._pack_pool is None:
                self._pack_pool = ThreadPoolExecutor(
                    max_workers=self._pack_workers(),
                    thread_name_prefix="sxt-pack")
            return self._pack_pool


def _slice_slot_outputs(slot_outputs, lo: int, hi: int):
    """Rows ``[lo, hi)`` of each slot's concatenated staged sequence, as
    views into the writers' arrays: one wave's share of the map outputs.
    Returns (sliced slot outputs, per-slot row counts)."""
    out, counts = [], []
    for outs in slot_outputs:
        sliced = []
        off = 0
        for keys, values in outs:
            n = keys.shape[0]
            s, e = max(lo - off, 0), min(hi - off, n)
            if s < e:
                sliced.append((keys[s:e],
                               None if values is None else values[s:e]))
            off += n
        out.append(sliced)
        counts.append(sum(int(k.shape[0]) for k, _ in sliced))
    return out, np.asarray(counts, dtype=np.int64)


class PendingWaveShuffle:
    """Handle of a WAVE-PIPELINED read (``a2a.waveRows``).

    ``result()`` drives a depth-D pipeline over the staged map outputs:
    wave i+1 is packed into a pinned pool block on the host while wave
    i's exchange runs on the device's stream and wave i-1 drains. It
    keeps these invariants:

    * every wave dispatches the same plan (``wave_step_plan``);
    * an overflow regrows and re-runs ONLY the offending wave (its
      ``PendingShuffle`` retry loop), and later waves start at the grown
      capacity;
    * at most ``depth`` waves are in flight, so pinned staging holds at
      most ``depth`` wave blocks; a block goes back to the pool once its
      wave's ``result()`` has waited on the overflow flag, which follows
      the block's H2D copy on the stream;
    * on a hierarchical binding each wave is a tiered exchange, and its
      tier walls go into its timeline entry (``ici_ms``, ``dcn_ms``) and
      into the read's tier entries, summed over the waves;
    * the ``wave`` fault site comes before each wave; a failure anywhere
      settles every wave in flight (their pinned blocks go back) before
      it propagates, and the read's in-flight guard closes after the last
      pack or on the failure.

    On the host sink each drained wave is pulled to the host at once
    (``drain_wave_result``) and the result is a
    ``WavedShuffleReaderResult``. On the device sink the waves stay on the
    device; an ordered or combine read folds them into one merged view
    (``reader.device_merge_fold``). ``done()`` is False until
    ``result()`` ran."""

    def __init__(self, mgr: ShuffleManager, handle: ShuffleHandle,
                 outer_plan: ShufflePlan, wave_plan: ShufflePlan,
                 depth: int, slot_outputs, width: int, has_vals: bool,
                 val_tail, val_dtype, rep: ExchangeReport, local_rows: int,
                 wave_sizes: np.ndarray, guard: "_ReadGuard", admit=None,
                 release_admitted=lambda: None, distributed: bool = False):
        self._mgr = mgr
        self._guard = guard
        self._distributed = distributed
        self._handle = handle
        self._outer_plan = outer_plan
        self._wave_plan = wave_plan
        self._depth = depth
        self._slot_outputs = slot_outputs
        self._width = width
        self._has_vals = has_vals
        self._val_tail = val_tail
        self._val_dtype = val_dtype
        self._rep = rep
        self._local_rows = local_rows
        self._wave_sizes = np.asarray(wave_sizes, dtype=np.int64)
        self._num_waves = outer_plan.num_waves
        self._wave_rows = outer_plan.wave_rows
        self._result = None
        self._dead = False
        self._lossless_bytes = 0      # compressed bytes of drained waves
        self._admit = admit
        self._release_admitted = release_admitted
        # hierarchical waves: the tier walls summed over drained waves
        self._tier_walls: Dict[str, float] = {}

    def done(self) -> bool:
        return self._result is not None or self._dead

    def _finish_guard(self) -> None:
        # the staged views go first: they alias the writers' memory the
        # guard stops protecting
        self._slot_outputs = None
        self._guard.close()

    def __del__(self):
        # an abandoned handle dispatched nothing (the packs run in
        # result()), but its guard must not hold a graveyard batch
        try:
            self._finish_guard()
            if self._result is None and not self._dead:
                self._mgr.node.flight.end_trace(self._rep.trace_id)
        except Exception:
            pass

    def result(self):
        if self._result is not None:
            return self._result
        if self._dead:
            raise RuntimeError(
                "wave exchange handle is dead: a previous result() failed "
                "and its buffers were released; re-submit the shuffle")
        try:
            res = self._drive()
        except BaseException as e:
            self._dead = True
            self._finish_guard()
            self._release_admitted()
            self._rep.error = self._rep.error or repr(e)[:300]
            if self._rep.tiers:
                # the walls the drained waves measured; no bytes counted
                self._mgr._settle_tiers(self._rep, self._tier_walls,
                                        completed=False)
            self._mgr._settle_report(self._rep, completed=False)
            raise
        self._result = res
        return res

    # -- the pipeline ------------------------------------------------------
    def _drive(self):
        mgr = self._mgr
        rep = self._rep
        t_read0 = time.perf_counter()
        inflight: deque = deque()            # (wave index, pending)
        timeline: List[Dict] = []
        wave_results: List = [None] * self._num_waves
        retries_total = 0
        pack_total = dispatch_total = pack_hidden = 0.0
        if self._admit is not None and not self._admit(False):
            self._admit(True)             # waits until capacity frees
        try:
            for i in range(self._num_waves):
                mgr.node.faults.check("wave")
                while len(inflight) >= self._depth:
                    retries_total += self._drain_oldest(
                        inflight, wave_results, timeline, t_read0)
                oldest = inflight[0][1] if inflight else None
                t0 = time.perf_counter()
                with mgr.node.tracer.span("shuffle.wave",
                                          shuffle_id=self._handle.shuffle_id,
                                          wave=i, trace=rep.trace_id):
                    sliced, wnv = _slice_slot_outputs(
                        self._slot_outputs, i * self._wave_rows,
                        (i + 1) * self._wave_rows)
                    shard_rows, buf = mgr._pack_shards(
                        sliced, self._wave_plan.cap_in, self._width,
                        self._has_vals, tenant=self._handle.tenant)
                    t1 = time.perf_counter()
                    if i == self._num_waves - 1:
                        self._finish_guard()          # last pack done
                    if not rep._t_dispatched:
                        rep._t_dispatched = t1
                    try:
                        pending = self._dispatch_wave(shard_rows, wnv, buf,
                                                      i)
                    except BaseException:
                        # no pending owns the pinned block yet
                        mgr.node.pool.put(buf)
                        raise
                t2 = time.perf_counter()
                # measured, not assumed: the pack counts as hidden only if
                # the oldest in-flight exchange was still running on the
                # device when it finished (partial overlap counts as not
                # hidden, so the hidden total is a lower bound)
                hidden = oldest is not None and not oldest._outputs_ready()
                pack_ms = (t1 - t0) * 1e3
                pack_total += pack_ms
                if hidden:
                    pack_hidden += pack_ms
                dispatch_total += (t2 - t1) * 1e3
                timeline.append({
                    "wave": i, "rows": int(wnv.sum()),
                    "pack_start_ms": round((t0 - t_read0) * 1e3, 3),
                    "pack_ms": round(pack_ms, 3),
                    "dispatch_ms": round((t2 - t1) * 1e3, 3),
                    "hidden": hidden,
                    "forced_ms": 0.0, "wait_ms": 0.0, "retries": 0})
                inflight.append((i, pending))
            while inflight:
                retries_total += self._drain_oldest(
                    inflight, wave_results, timeline, t_read0)
        except BaseException:
            # settle every in-flight wave first: its on_done returns its
            # pinned block to the pool; the settled waves' device results
            # go with this frame
            while inflight:
                _, p = inflight.popleft()
                try:
                    p.result()
                except Exception:
                    pass
            wave_results.clear()
            raise
        outer = self._outer_plan
        if outer.sink == "device":
            views = [w.wave_views()[0] for w in wave_results]
            res = DeviceShuffleReaderResult(views, outer, self._val_tail,
                                            self._val_dtype)
            if (outer.combine or outer.ordered) and len(views) > 1:
                t_merge = time.perf_counter()
                merged = device_merge_fold(res, mgr.conf)
                if merged._rows_dev.is_cuda:
                    # an honest wall: the waves' exchanges are done (each
                    # overflow check waited on them), so this is the fold
                    torch.cuda.synchronize(merged._rows_dev.device)
                rep.merge_ms = (time.perf_counter() - t_merge) * 1e3
                res = DeviceShuffleReaderResult(
                    [merged], outer, self._val_tail, self._val_dtype)
            mgr._arm_d2h(res, rep)
            res._release_hbm = self._release_admitted
        else:
            # every wave drained: the device buffers are gone
            self._release_admitted()
            res = WavedShuffleReaderResult(wave_results, outer,
                                           self._val_tail, self._val_dtype)
        self._finalize(timeline, retries_total, pack_total, pack_hidden,
                       dispatch_total)
        # integrity.verify=full: digests are wave-split invariant, so the
        # drained waves verify together against every map's digest rows
        mgr._verify_full_result(self._handle, res, outer.combine)
        return res

    def _dispatch_wave(self, shard_rows, wnv: np.ndarray, buf,
                       wave_i: int):
        mgr = self._mgr
        pool = mgr.node.pool
        # int8 noise base of this wave: the exchange sequence number
        # spaces reads, the wave index the waves of one read
        wseed = (self._rep._seq * 100_003 + wave_i) & 0x7FFFFFFF

        def on_done(result, _b=buf):
            # the pool hands this block to a later wave's pack
            pool.put(_b)

        node = mgr.node
        if self._distributed and mgr.hierarchical:
            return submit_shuffle_tiered_distributed(
                mgr.topology, self._wave_plan, shard_rows, wnv,
                node.local_shard_ids, self._val_tail, self._val_dtype,
                node.device, pool, on_done=on_done, wire_seed=wseed,
                metrics=node.metrics, **mgr._tier_hooks(self._rep.trace_id))
        if self._distributed:
            return submit_shuffle_distributed(
                self._wave_plan, shard_rows, wnv, node.local_shard_ids,
                self._val_tail, self._val_dtype, node.device, pool,
                on_done=on_done, metrics=node.metrics, wire_seed=wseed)
        if mgr.hierarchical:     # (waves never run under 'pallas')
            return submit_shuffle_tiered(
                mgr.topology, self._wave_plan, shard_rows, wnv,
                self._val_tail, self._val_dtype, mgr.node.device,
                on_done=on_done, wire_seed=wseed, metrics=mgr.node.metrics,
                **mgr._tier_hooks(self._rep.trace_id))
        return submit_shuffle(self._wave_plan, shard_rows, wnv,
                              self._val_tail, self._val_dtype,
                              mgr.node.device, on_done=on_done,
                              metrics=mgr.node.metrics, wire_seed=wseed)

    def _drain_oldest(self, inflight, wave_results, timeline,
                      t_read0: float) -> int:
        """Force the oldest in-flight wave: its result (the overflow retry
        loop runs inside), then, on the host sink, its rows to the host,
        freeing its device buffers. Returns the wave's retry count."""
        i, pending = inflight.popleft()
        t0 = time.perf_counter()
        res = pending.result()
        wait_ms = (time.perf_counter() - t0) * 1e3
        self._mgr._arm_d2h(res, self._rep)
        if self._outer_plan.sink != "device":
            drain_wave_result(res)
            if self._wave_plan.wire == "lossless":
                # the lossless tier: the drained wave waits on the host
                # for the composed result, so it waits compressed
                ex = self._mgr._executor() if self._mgr.node.num_shards > 1 \
                    else None
                self._lossless_bytes += res.compress_host_blocks(ex)[1]
        entry = timeline[i]
        entry["forced_ms"] = round((t0 - t_read0) * 1e3, 3)
        entry["wait_ms"] = round(wait_ms, 3)
        retries = int(pending._attempt)
        entry["retries"] = retries
        for tier, ms in getattr(pending, "tier_walls", {}).items():
            entry[f"{tier}_ms"] = round(ms, 3)
            self._tier_walls[tier] = self._tier_walls.get(tier, 0.0) + ms
        wave_results[i] = res
        used = res.cap_out_used
        if used and int(used) > self._wave_plan.cap_out:
            # this wave overflowed and grew: later waves start there
            self._wave_plan = dataclasses.replace(self._wave_plan,
                                                  cap_out=int(used))
        return retries

    def _finalize(self, timeline, retries_total: int, pack_total: float,
                  pack_hidden: float, dispatch_total: float) -> None:
        mgr = self._mgr
        rep = self._rep
        rep.pack_ms = pack_total
        rep.dispatch_ms = dispatch_total
        rep.wave_pack_hidden_ms = round(pack_hidden, 3)
        rep.wave_timeline = timeline
        rep.retries = retries_total
        if rep._t_dispatched:
            rep.group_ms = (time.perf_counter() - rep._t_dispatched) * 1e3
        # the wire under the FINAL wave plan (a regrow raised cap_out for
        # the waves behind it)
        mgr._set_wave_wire(rep, self._wave_plan, self._wave_sizes,
                           self._width)
        if rep.tiers:
            mgr._stamp_wave_tiers(rep, self._wave_plan, self._wave_sizes,
                                  self._width)
            mgr._settle_tiers(rep, self._tier_walls)
        rep.lossless_bytes = int(self._lossless_bytes)
        if rep.lossless_bytes:
            rep.lossless_ratio = round(
                rep.lossless_bytes / rep.payload_bytes, 6) \
                if rep.payload_bytes else 0.0
        mgr._settle_volume(rep, self._width)
        rep.completed = True
        mgr._settle_report(rep, completed=True)
        metrics = mgr.node.metrics
        metrics.inc("shuffle.rows", float(self._local_rows))
        metrics.inc("shuffle.bytes",
                    float(self._local_rows) * self._width * 4)
        if retries_total:
            metrics.inc("shuffle.retries", float(retries_total))
        # pack time the previous wave's exchange did not cover
        for k in range(1, len(timeline)):
            metrics.observe(H_WAVE_GAP, max(
                0.0, timeline[k]["pack_ms"] - timeline[k - 1]["wait_ms"]))
        with mgr._lock:
            key = (mgr._cap_key(self._handle), self._wave_plan.cap_in)
            if self._wave_plan.cap_out > mgr._wave_cap_hints.get(key, 0):
                mgr._wave_cap_hints[key] = self._wave_plan.cap_out
