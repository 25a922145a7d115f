"""The ``spark.shuffle.tpu.*`` keys the ported read paths consume.

The same key strings as the JAX package's conf, so one flat dict drives
both packages. Only the keys the ported reads (plain, combine, ordered)
use are typed here; every other key in the mapping is carried (``get``)
but not interpreted — a conf written for the full JAX surface passes
through unchanged.

Keys: ``a2a.impl``, ``a2a.capacityFactor``, ``a2a.capBuckets``,
``a2a.capBucketGrowth``, ``a2a.sortImpl``, ``a2a.combineCompaction``,
``a2a.waveRows``, ``a2a.waveDepth``, ``a2a.wire``,
``a2a.wireErrorSampleRows``, ``a2a.maxBytesInFlight``, ``a2a.topology``,
``mesh.numSlices``, ``read.mergeImpl``, ``read.sink``, ``network.timeoutMs``,
``spill.threshold``, ``spill.dir``, and the multi-process keys
``coordinator.address``, ``numProcesses``, ``meta.bufferSize``,
``failure.collectiveTimeoutMs``, ``failure.ici.timeoutMs`` and
``failure.dcn.timeoutMs``; the failure plane's ``failure.policy``,
``failure.replayBudget`` and ``failure.replayAgreeTimeoutMs``; the
integrity plane's ``integrity.verify`` and ``failure.ledgerDir`` (the keys
``failure.maxAttempts``, ``failure.backoffMs``, ``failure.maxBackoffMs``,
``fault.*`` and ``flightRecorder.*`` are read where they are used:
``runtime/failures.py``, ``runtime/node.py``); the pool's ``memory.*``
keys; ``a2a.packThreads``, ``coresPerProcess``, ``io.fetchGranularity``
and ``metrics.reportCapacity``; the tenancy plane's ``tenant.id``,
``tenant.priority``, ``tenant.fairShare``, ``tenant.asyncWorkers``,
``tenant.asyncAgreedOrder`` and the per-tenant ``tenant.<id>.*`` keys
(:meth:`ShuffleConf.tenant_policy`); the telemetry and decision planes'
keys (:data:`TELEMETRY_KEYS`: ``trace.*``, ``metrics.dumpDir``,
``metrics.dumpIntervalSecs``, ``devmon.*``, ``history.*``,
``decisions.*``). Byte sizes parse as the JAX package's do
(``'4m'``, ``'1k'``, ``'300'``, ``'2GiB'``).
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Iterator, Mapping, Optional, Tuple

PREFIX = "spark.shuffle.tpu."

# a2a.impl values the port runs. 'pallas' names the hand-written segment
# move kernel (the conf value is shared with the JAX package, whose
# 'pallas' transport it replaces); dense/gather are torch-op exchanges;
# auto resolves per device (backend.resolve_a2a_impl). The JAX package's
# 'native' (XLA's ragged collective) has no counterpart here.
ALLOWED_IMPLS = ("auto", "dense", "gather", "pallas")

# a2a.sortImpl values (the JAX package's set). The port sorts with one
# torch.sort + row gather whatever the value; argsort/counting ask for
# the stable order, the others accept the unstable one.
SORT_METHODS = ("auto", "argsort", "multisort", "multisort8", "counting")

PARTITIONERS = ("hash", "direct", "range")

# read.mergeImpl values (the JAX package's set). 'pallas' names the
# hand-written CUDA segment-reduce kernel (csrc/segment_reduce.cu, the
# counterpart of the JAX package's Pallas kernel), 'jnp' the torch-op
# formulation (ops/aggregate.combine_rows); auto resolves per device
# (ops/segmented.resolve_kernel_impl).
MERGE_IMPLS = ("auto", "jnp", "pallas")

# a2a.combineCompaction values: two formulations of combine_rows' end-row
# compaction with bit-identical results (ops/aggregate.combine_rows).
COMPACTIONS = ("stable", "unstable")

# a2a.capBucketGrowth bounds
CAP_BUCKET_GROWTH_RANGE = (1.05, 4.0)

# a2a.waveDepth bounds: 1 = serial waves (bounded memory, no overlap);
# past ~8 the pinned-block working set grows without hiding more latency
# (the pipeline has three stages: pack, exchange, drain)
WAVE_DEPTH_RANGE = (1, 8)

# read.sink values (the JAX package's set): 'host' drains each result to
# numpy partition views, 'device' keeps the partitions in device tensors
# handed to a consumer (reader.DeviceShuffleReaderResult), 'auto' is host
# unless a read asks for the device sink (read(sink="device")).
ALLOWED_SINKS = ("host", "device", "auto")
READ_SINK_KEY = PREFIX + "read.sink"

# a2a.wire values (the JAX package's set): 'raw' moves exact int32 lanes;
# 'int8' moves float32 value lanes as stochastically rounded int8 plus
# one float32 scale per row (keys stay exact; shuffle/alltoall.
# wire_pack_rows); 'lossless' re-encodes drained host blocks of a waved
# read as byte planes + deflate (shuffle/wire.py), bit-exact.
ALLOWED_WIRES = ("raw", "int8", "lossless")
A2A_WIRE_KEY = PREFIX + "a2a.wire"

# a2a.topology values (the JAX package's set): 'flat' is one exchange over
# every shard; 'hier' the two-stage decomposition on a (dcn, ici) slice
# grid (shuffle/topology.py: stage 1 within each slice, stage 2 across
# slices, each row crossing the slow tier once); 'auto' is hier exactly
# when the node's grid has more than one slice
ALLOWED_TOPOLOGIES = ("flat", "hier", "auto")
A2A_TOPOLOGY_KEY = PREFIX + "a2a.topology"

# failure.policy values (the JAX package's set): failfast surfaces typed
# errors to the caller; replay keeps the recovery ledger across epoch
# bumps and re-runs a failed exchange within failure.replayBudget
FAILURE_POLICIES = ("failfast", "replay")

# io.fetchGranularity values (the JAX package's set): shard pulls a
# shard's whole delivered prefix on its first touch; partition copies only
# the touched partition's runs
FETCH_GRANULARITIES = ("shard", "partition")

# most-recent ExchangeReports a manager keeps (metrics.reportCapacity)
REPORT_CAPACITY = 64

# the telemetry and decision planes' keys: {key: (default, description)},
# the JAX package's defaults and descriptions
TELEMETRY_KEYS = {
    "trace.enabled": ("false", "turn on the span tracer (utils/trace.py)"),
    "trace.device": ("false", "also record device-time spans (a "
                              "torch.profiler record_function range "
                              "around every span)"),
    "trace.capacity": ("65536", "tracer ring-buffer size"),
    "metrics.dumpDir": ("", "periodic JSON metrics-snapshot dumps land "
                            "here (off when unset; utils/export.py)"),
    "metrics.dumpIntervalSecs": ("60", "seconds between periodic metrics "
                                       "dumps (default 60)"),
    "devmon.enabled": ("false", "device memory sampler "
                                "(runtime/devmon.py): device memory + "
                                "pool watermark gauges on a cadence "
                                "(default off, null-object)"),
    "devmon.intervalMs": ("1000", "devmon sampling interval in ms "
                                  "(default 1000)"),
    "history.dir": ("", "windowed telemetry history JSONL directory "
                        "(utils/history.py; unset = in-memory ring only) "
                        "— restart-durable, bounded to retainWindows "
                        "lines"),
    "history.windowSecs": ("60", "history window length in seconds "
                                 "(default 60); rolled on the periodic-"
                                 "dumper cadence, no extra thread"),
    "history.retainWindows": ("120", "history retention, in windows, for "
                                     "both the ring and the on-disk log "
                                     "(default 120)"),
    "decisions.enabled": ("true", "decision ledger "
                                  "(shuffle/decisions.py): append every "
                                  "agree() round — winner/proposal "
                                  "digests, round wall ms, per-peer "
                                  "header lag — to a bounded ring plus "
                                  "(when history.dir is set) a rank-"
                                  "keyed decisions_p<rank>.jsonl "
                                  "(default on; off = null-object, zero "
                                  "overhead)"),
    "decisions.retain": ("256", "decision-ledger retention, in records, "
                                "for both the ring and the on-disk log "
                                "(default 256)"),
}


_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kKmMgGtT]?)i?[bB]?\s*$")
_SIZE_MULT = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(text) -> int:
    """Parse '4m', '1k', '300', '2GiB' into a byte count (SparkConf's
    getSizeAsBytes units)."""
    if isinstance(text, int):
        return text
    m = _SIZE_RE.match(str(text))
    if not m:
        raise ValueError(f"cannot parse byte size: {text!r}")
    value, unit = m.groups()
    return int(float(value) * _SIZE_MULT[unit.lower()])


def _norm(key: str) -> str:
    """Case/punctuation-insensitive key form ('a2a.capacityFactor',
    'A2A_CAPACITYFACTOR' and 'a2a.capacityfactor' collide)."""
    return key.lower().replace(".", "").replace("_", "")


def validate_impl(impl: str, conf_key: str = PREFIX + "a2a.impl") -> str:
    if impl not in ALLOWED_IMPLS:
        raise ValueError(
            f"{conf_key}={impl!r}: want one of {ALLOWED_IMPLS} (pallas = "
            f"the hand-written CUDA segment move, dense/gather = torch-op "
            f"exchanges, auto = the kernel on CUDA, dense on the CPU)")
    return impl


def validate_sink(sink: str, conf_key: str = READ_SINK_KEY) -> str:
    if sink not in ALLOWED_SINKS:
        raise ValueError(
            f"{conf_key}={sink!r}: want one of {ALLOWED_SINKS} (host = "
            f"drain results to the host, device = partitions stay in device "
            f"tensors handed to a consumer, auto = device when the read "
            f"asks for it)")
    return sink


def validate_wire(wire: str, conf_key: str = A2A_WIRE_KEY) -> str:
    if wire not in ALLOWED_WIRES:
        raise ValueError(
            f"{conf_key}={wire!r}: want one of {ALLOWED_WIRES} (raw = "
            f"exact int32 lanes, int8 = quantized float value lanes + a "
            f"per-row scale, lossless = host-side byte-plane compression "
            f"of drained wave blocks)")
    return wire


def validate_topology(topology: str,
                      conf_key: str = A2A_TOPOLOGY_KEY) -> str:
    if topology not in ALLOWED_TOPOLOGIES:
        raise ValueError(
            f"{conf_key}={topology!r}: want one of {ALLOWED_TOPOLOGIES} "
            f"(flat = one collective over every device, hier = the "
            f"two-stage ICI/DCN decomposition on a 2-D (dcn, ici) mesh, "
            f"auto = hier exactly when the mesh has >1 slice)")
    return topology


def validate_sort_impl(v: str) -> str:
    if v not in SORT_METHODS:
        raise ValueError(
            f"{PREFIX}a2a.sortImpl={v!r}: want one of {SORT_METHODS}")
    return v


class ShuffleConf:
    """Typed view over a flat ``spark.shuffle.tpu.*`` key/value map, with
    ``SPARKUCX_TPU_*`` environment overlay unless ``use_env=False``."""

    _TYPED_PROPS = ("a2a_impl", "capacity_factor", "cap_buckets",
                    "cap_bucket_growth", "sort_impl", "combine_compaction",
                    "wave_rows", "wave_depth", "a2a_wire",
                    "wire_error_sample_rows", "read_merge_impl",
                    "read_sink", "connection_timeout_ms",
                    "spill_threshold", "max_bytes_in_flight",
                    "a2a_topology", "num_slices", "coordinator_address",
                    "num_processes", "meta_buffer_size",
                    "collective_timeout_ms", "ici_timeout_ms",
                    "dcn_timeout_ms", "failure_policy", "replay_budget",
                    "replay_agree_timeout_ms", "integrity_verify",
                    "ledger_dir", "min_buffer_size",
                    "min_allocation_size", "pre_allocate_buffers",
                    "pinned_memory", "pack_threads", "cores_per_process",
                    "fetch_granularity", "report_capacity",
                    "tenant_id", "tenant_priority", "tenant_fair_share",
                    "tenant_async_workers", "tenant_async_agreed_order",
                    "trace_enabled", "trace_device", "trace_capacity",
                    "metrics_dump_interval_secs", "devmon_enabled",
                    "devmon_interval_ms", "history_window_secs",
                    "history_retain_windows", "decisions_enabled",
                    "decisions_retain")

    def __init__(self, conf: Optional[Mapping[str, str]] = None,
                 use_env: bool = True):
        self._conf: Dict[str, str] = {}
        self._index: Dict[str, str] = {}
        for k, v in (conf or {}).items():
            self._conf[str(k)] = str(v)
            self._index[_norm(str(k))] = str(k)
        if use_env:
            for k, v in os.environ.items():
                if k.startswith("SPARKUCX_TPU_"):
                    key = PREFIX + k[len("SPARKUCX_TPU_"):].lower() \
                        .replace("_", ".")
                    if _norm(key) not in self._index:
                        self._conf[key] = v
                        self._index[_norm(key)] = key
        for name in self._TYPED_PROPS:       # fail fast on bad values
            try:
                getattr(self, name)
            except ValueError as e:
                raise ValueError(f"conf key for {name!r}: {e}") from e

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        if key in self._conf:
            return self._conf[key]
        hit = self._index.get(_norm(key))
        return default if hit is None else self._conf[hit]

    def set(self, key: str, value) -> "ShuffleConf":
        """Set one key (a full ``spark.shuffle.tpu.*`` name)."""
        hit = self._index.get(_norm(key))
        if hit is not None and hit != key:
            del self._conf[hit]
        self._conf[key] = str(value)
        self._index[_norm(key)] = key
        return self

    def items(self) -> Iterator[Tuple[str, str]]:
        """Every key and value of the mapping, sorted by key (the fault
        injector arms its sites from the ``fault.*`` keys here)."""
        return iter(sorted(self._conf.items()))

    def _get(self, short: str, default) -> str:
        return self.get(PREFIX + short, str(default))

    def get_int(self, short: str, default: int) -> int:
        return int(self._get(short, default))

    def get_float(self, short: str, default: float) -> float:
        return float(self._get(short, default))

    def get_bytes(self, short: str, default) -> int:
        return parse_bytes(self._get(short, default))

    def get_bool(self, short: str, default: bool) -> bool:
        v = self._get(short, default).strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"conf key {PREFIX}{short}={v!r} is not a boolean")

    @property
    def a2a_impl(self) -> str:
        """Exchange implementation: auto | dense | gather | pallas."""
        return validate_impl(self._get("a2a.impl", "auto"))

    @property
    def capacity_factor(self) -> float:
        """Receive-buffer headroom over the perfectly balanced share."""
        v = float(self._get("a2a.capacityFactor", 2.0))
        if v <= 0:
            raise ValueError(f"{PREFIX}a2a.capacityFactor={v}: want > 0")
        return v

    @property
    def cap_buckets(self) -> bool:
        """Quantize plan capacities up onto a geometric ladder."""
        return self.get_bool("a2a.capBuckets", True)

    @property
    def cap_bucket_growth(self) -> float:
        """Ratio between consecutive capacity-ladder rungs."""
        v = float(self._get("a2a.capBucketGrowth", 1.25))
        lo, hi = CAP_BUCKET_GROWTH_RANGE
        if not lo <= v <= hi:
            raise ValueError(
                f"{PREFIX}a2a.capBucketGrowth={v}: want {lo}..{hi}")
        return v

    @property
    def sort_impl(self) -> str:
        """Destination-sort order contract (see SORT_METHODS)."""
        return validate_sort_impl(self._get("a2a.sortImpl", "auto"))

    @property
    def combine_compaction(self) -> str:
        """combine_rows end-row compaction formulation: stable |
        unstable (bit-identical results)."""
        v = self._get("a2a.combineCompaction", "stable")
        if v not in COMPACTIONS:
            raise ValueError(f"{PREFIX}a2a.combineCompaction={v!r}: want "
                             f"one of {COMPACTIONS}")
        return v

    @property
    def wave_rows(self) -> int:
        """Wave-pipelined read: split the staged rows into waves of at
        most this many rows per shard and pack wave i+1 on the host while
        wave i's exchange runs on the device. 0 (default) = single-shot.
        An overflow regrows and re-runs only the offending wave
        (shuffle/manager.PendingWaveShuffle)."""
        v = self.get_int("a2a.waveRows", 0)
        if v < 0:
            raise ValueError(f"{PREFIX}a2a.waveRows={v}: want >= 0 (0 = off)")
        return v

    @property
    def wave_depth(self) -> int:
        """Waves in flight at once (and recycled pinned pack blocks the
        pipeline holds); 2 (default) is the classic depth-2 pipeline, 1
        runs the waves one after another."""
        v = self.get_int("a2a.waveDepth", 2)
        lo, hi = WAVE_DEPTH_RANGE
        if not lo <= v <= hi:
            raise ValueError(f"{PREFIX}a2a.waveDepth={v}: want {lo}..{hi}")
        return v

    @property
    def a2a_wire(self) -> str:
        """Wire tier, orthogonal to ``a2a.impl``: raw (default), int8
        (float32 value lanes quantized per row around the exchange; needs
        a float32 value schema and more than one shard, else the read
        runs raw and its report says so) or lossless (drained blocks of a
        waved host-sink read held compressed until first touch)."""
        return validate_wire(self._get("a2a.wire", "raw"))

    @property
    def wire_error_sample_rows(self) -> int:
        """Staged rows an int8 read samples to estimate its
        dequantization error (``ExchangeReport.wire_dequant_error``);
        0 turns the estimate off."""
        v = self.get_int("a2a.wireErrorSampleRows", 256)
        if v < 0:
            raise ValueError(f"{PREFIX}a2a.wireErrorSampleRows={v}: want "
                             f">= 0 (0 = off)")
        return v

    @property
    def read_merge_impl(self) -> str:
        """How the combine read's reduce-side segment reduce runs: auto
        (the CUDA kernel on the card, the torch-op formulation on the
        CPU), jnp (the torch-op formulation) or pallas (the kernel on
        the card, its plain version on the CPU)."""
        v = self._get("read.mergeImpl", "auto")
        if v not in MERGE_IMPLS:
            raise ValueError(f"{PREFIX}read.mergeImpl={v!r}: want one of "
                             f"{MERGE_IMPLS} (pallas = the hand-written CUDA "
                             f"segment reduce, jnp = torch ops)")
        return v

    @property
    def read_sink(self) -> str:
        """Where a completed exchange lands: host (numpy partition
        views), device (partitions stay in device tensors handed to a
        consumer; ordered and combine waved reads merge on the device) or
        auto (default: host unless the read asks for the device sink).
        The manager resolves it per read (``_resolve_sink``)."""
        return validate_sink(self._get("read.sink", "auto"))

    @property
    def connection_timeout_ms(self) -> int:
        """How long a read waits for every map output to be published."""
        return int(self._get("network.timeoutMs", 120_000))

    @property
    def spill_threshold(self) -> int:
        """Staged bytes per map writer before its batches move to disk
        files (0 disables): past it a writer appends to sealed, mmapped
        spill files (``shuffle/writer.SpillFiles``), so its host staging
        stays bounded by this threshold instead of the output's size."""
        v = self.get_bytes("spill.threshold", "256m")
        if v < 0:
            raise ValueError(f"{PREFIX}spill.threshold={v}: want >= 0 "
                             f"(0 = off)")
        return v

    @property
    def spill_dir(self) -> str:
        """Directory of the spill files. Default: a per-process directory
        under the system temp directory."""
        return self._get(
            "spill.dir",
            os.path.join(tempfile.gettempdir(),
                         f"sparkucx_tpu_torch_spill_{os.getpid()}"))

    @property
    def max_bytes_in_flight(self) -> int:
        """Cap on the summed footprint (pinned pack buffers + estimated
        device send and receive buffers) of the exchanges in flight at
        once; 0 (default) = no cap. A submit over the cap is deferred
        and dispatches in ``result()`` once earlier exchanges release
        (FIFO); one exchange larger than the cap is admitted when
        nothing else is in flight (``ShuffleManager._make_admitter``)."""
        v = self.get_bytes("a2a.maxBytesInFlight", 0)
        if v < 0:
            raise ValueError(f"{PREFIX}a2a.maxBytesInFlight={v}: want >= 0 "
                             f"(0 = off)")
        return v

    @property
    def a2a_topology(self) -> str:
        """Exchange topology: flat, hier (the two-stage exchange of
        ``shuffle/topology.py``; needs a grid of more than one slice) or
        auto (default: hier exactly when ``mesh.numSlices`` > 1)."""
        return validate_topology(self._get("a2a.topology", "auto"))

    @property
    def num_slices(self) -> int:
        """Slices the node's shards are laid out in (``parallel/mesh``):
        more than 1 makes the grid ``[S, P/S]``, slice-major."""
        return self.get_int("mesh.numSlices", 1)

    # -- the multi-process keys (shuffle/distributed.py) -------------------
    @property
    def coordinator_address(self) -> str:
        """``host:port`` of the rendezvous every process of a distributed
        node dials (``torch.distributed``'s TCP init)."""
        return self._get("coordinator.address", "localhost:55443")

    @property
    def num_processes(self) -> int:
        """Processes in the cluster; a node started with
        ``distributed=True`` spans processes only when this is above 1."""
        v = self.get_int("numProcesses", 1)
        if v < 1:
            raise ValueError(f"{PREFIX}numProcesses={v}: want >= 1")
        return v

    @property
    def meta_buffer_size(self) -> int:
        """Upper bound on one metadata-plane message (the presence bitmap
        a distributed read allgathers: 8 B a map, plus one)."""
        return self.get_bytes("meta.bufferSize", "64k")

    @property
    def collective_timeout_ms(self) -> float:
        """Deadline on every distributed rendezvous and collective wait
        (``runtime/watchdog.py``): past it the watchdog probes the device
        and raises ``PeerLostError`` instead of hanging on a dead peer.
        0 (default) = off."""
        v = self.get_float("failure.collectiveTimeoutMs", 0.0)
        if v < 0:
            raise ValueError(
                f"spark.shuffle.tpu.failure.collectiveTimeoutMs={v}: "
                f"want >= 0 (0 = off)")
        return v

    def _tier_timeout(self, tier: str) -> float:
        v = self.get_float(f"failure.{tier}.timeoutMs",
                           self.collective_timeout_ms)
        if v < 0:
            raise ValueError(
                f"spark.shuffle.tpu.failure.{tier}.timeoutMs={v}: "
                f"want >= 0 (0 = off)")
        return v

    @property
    def ici_timeout_ms(self) -> float:
        """Deadline on the intra-slice (ICI) stage of a hierarchical
        read; past it ``PeerLostError`` names the ICI tier. Defaults to
        ``failure.collectiveTimeoutMs`` (0 = off)."""
        return self._tier_timeout("ici")

    @property
    def dcn_timeout_ms(self) -> float:
        """Deadline on the cross-slice (DCN) stage of a hierarchical
        read, the ``failure.ici.timeoutMs`` twin. Defaults to
        ``failure.collectiveTimeoutMs`` (0 = off)."""
        return self._tier_timeout("dcn")

    # -- the failure plane (runtime/failures.py, shuffle/manager.py) -------
    @property
    def failure_policy(self) -> str:
        """What ``read()`` / ``submit()`` do when an exchange fails or a
        remesh invalidates its handle: ``failfast`` (default: typed
        errors reach the caller) or ``replay`` (the manager keeps the
        shuffles whose staged state is intact across an epoch bump, and
        re-runs a failed exchange, up to ``failure.replayBudget`` times
        a shuffle)."""
        v = self._get("failure.policy", "failfast")
        if v not in FAILURE_POLICIES:
            raise ValueError(
                f"spark.shuffle.tpu.failure.policy={v!r}: want "
                f"failfast|replay")
        return v

    @property
    def replay_budget(self) -> int:
        """Replays a shuffle may spend under ``failure.policy=replay``
        (stale-handle re-pins after a remesh plus re-runs after a
        transient failure, cumulative per shuffle); past it the shuffle
        fails fast."""
        v = self.get_int("failure.replayBudget", 2)
        if v < 0:
            raise ValueError(
                f"spark.shuffle.tpu.failure.replayBudget={v}: want >= 0")
        return v

    @property
    def replay_agree_timeout_ms(self) -> float:
        """Deadline of a distributed replay's ``replay.enter`` agreement
        round: a peer whose read did not fail never enters it, and this
        bounds the wait of those that did. Defaults to
        ``failure.collectiveTimeoutMs`` (0 = off)."""
        v = self.get_float("failure.replayAgreeTimeoutMs",
                           self.collective_timeout_ms)
        if v < 0:
            raise ValueError(
                f"spark.shuffle.tpu.failure.replayAgreeTimeoutMs={v}: "
                f"want >= 0 (0 = off)")
        return v

    # -- the integrity plane (shuffle/integrity.py, shuffle/durable.py) -----
    @property
    def integrity_verify(self) -> str:
        """Block-integrity verification level: ``off`` (no checksums);
        ``staged`` (default: commit publishes a checksum record beside
        each size row and the read re-verifies the staged or spilled
        bytes before they enter the exchange); ``full`` (staged, and the
        result after the exchange: the host sink per reduce partition
        against order-free digest sums, key lanes only under the int8
        wire; the device sink by re-routing the sampled key lanes). A
        mismatch raises ``BlockCorruptionError``, which
        ``failure.policy=replay`` may absorb. Every level launches the
        same kernels."""
        from sparkucx_tpu_torch.shuffle.integrity import \
            validate_verify_level
        return validate_verify_level(
            self._get("integrity.verify", "staged"),
            conf_key=PREFIX + "integrity.verify")

    @property
    def ledger_dir(self) -> str:
        """The durable ledger's directory (empty = off): every commit
        seals its output under ``<dir>/shuffle_<id>/`` and rewrites the
        shuffle's checksummed ``commit.manifest``; a manager started on
        the same directory validates them and serves the intact maps
        without recompute (``shuffle/durable.py``). ``stop()`` keeps the
        ledger; ``unregister_shuffle`` deletes a shuffle's part."""
        return self._get("failure.ledgerDir", "")

    # -- the staging pool (runtime/node.HostStagingPool) --------------------
    @property
    def min_buffer_size(self) -> int:
        """The smallest buffer the staging pool hands out (rounded up to
        a power of two by the pool; default 1k)."""
        return self.get_bytes("memory.minBufferSize", "1k")

    @property
    def min_allocation_size(self) -> int:
        """The page-locked slab that preallocated buffers smaller than it
        are carved from (default 4m)."""
        return self.get_bytes("memory.minAllocationSize", "4m")

    @property
    def pre_allocate_buffers(self) -> Dict[int, int]:
        """``'size:count,size:count'`` parsed to {bytes: count}: buffers
        the staging pool takes at node start."""
        spec = self._get("memory.preAllocateBuffers", "")
        out: Dict[int, int] = {}
        if spec:
            for part in spec.split(","):
                try:
                    size, count = part.split(":")
                    out[parse_bytes(size)] = int(count)
                except ValueError as e:
                    raise ValueError(
                        f"preAllocateBuffers entry {part!r} is not "
                        f"'size:count'") from e
        return out

    @property
    def pinned_memory(self) -> bool:
        """Whether the staging pool of a CUDA node page-locks its
        buffers (default true; a CPU node never does)."""
        return self.get_bool("memory.pinned", True)

    # -- the pack executor and the result views ----------------------------
    @property
    def pack_threads(self) -> int:
        """Worker threads of the manager's pack executor (the shard
        fan-out of a pack; numpy copies release the GIL). 0 (default) =
        ``coresPerProcess``."""
        v = self.get_int("a2a.packThreads", 0)
        if v < 0:
            raise ValueError(
                f"spark.shuffle.tpu.a2a.packThreads={v}: want >= 0 "
                f"(0 = coresPerProcess)")
        return v

    @property
    def cores_per_process(self) -> int:
        """Concurrent map tasks a process expects; sizes the pack
        executor when ``a2a.packThreads`` is 0. Default: the host's CPU
        count."""
        return self.get_int("coresPerProcess", os.cpu_count() or 1)

    @property
    def fetch_granularity(self) -> str:
        """How a host result moves its rows to the host: ``shard``
        (default: the first touch of a shard pulls its whole delivered
        prefix) or ``partition`` (each fetch copies only that partition's
        runs)."""
        v = self._get("io.fetchGranularity", "shard")
        if v not in FETCH_GRANULARITIES:
            raise ValueError(
                f"spark.shuffle.tpu.io.fetchGranularity={v!r}: want "
                f"shard|partition")
        return v

    @property
    def report_capacity(self) -> int:
        """ExchangeReports a manager keeps, most recent first
        (``metrics.reportCapacity``, at least 1; default 64)."""
        return max(1, self.get_int("metrics.reportCapacity",
                                   REPORT_CAPACITY))

    # -- the tenancy plane (shuffle/tenancy.py) ------------------------------
    @property
    def tenant_id(self) -> str:
        """This process's default tenant (``tenant.id``, default
        ``default``): the tenant of a shuffle registered without one."""
        return str(self._get("tenant.id", "default")).strip() or "default"

    @property
    def tenant_priority(self) -> str:
        """The default priority class (``high`` | ``normal`` | ``batch``)
        of a tenant without a ``tenant.<id>.priority``."""
        from sparkucx_tpu_torch.shuffle.tenancy import validate_priority
        return validate_priority(self._get("tenant.priority", "normal"),
                                 PREFIX + "tenant.priority")

    @property
    def tenant_fair_share(self) -> bool:
        """Deficit-round-robin admission across tenants (default on);
        off = the strictly FIFO deferral queue."""
        return self.get_bool("tenant.fairShare", True)

    @property
    def tenant_async_workers(self) -> int:
        """Worker threads of the async read plane (``read_async``,
        default 4, at least 1)."""
        v = self.get_int("tenant.asyncWorkers", 4)
        if v < 1:
            raise ValueError(f"{PREFIX}tenant.asyncWorkers={v}: want >= 1")
        return v

    @property
    def tenant_async_agreed_order(self) -> bool:
        """Distributed async reads on more than one worker agree each
        batch's order collectively (default on); off clamps the pool to
        one worker."""
        return self.get_bool("tenant.asyncAgreedOrder", True)

    def tenant_policy(self, tenant: str, default_priority: str) -> Dict:
        """One tenant's ``tenant.<id>.*`` keys, validated: ``priority``
        (default ``default_priority``), ``max_bytes_in_flight`` and
        ``max_inflight_reads`` (0 = no per-tenant limit), and the
        overrides ``replay_budget``, ``integrity_verify`` and
        ``wave_depth`` (None = the global key applies)."""
        from sparkucx_tpu_torch.shuffle.integrity import \
            validate_verify_level
        from sparkucx_tpu_torch.shuffle.tenancy import validate_priority
        pre = f"tenant.{tenant}."
        key = PREFIX + pre
        priority = validate_priority(
            self._get(pre + "priority", default_priority), key + "priority")
        quota = self.get_bytes(pre + "maxBytesInFlight", 0)
        if quota < 0:
            raise ValueError(f"{key}maxBytesInFlight={quota}: want >= 0")
        inflight = self.get_int(pre + "maxInflightReads", 0)
        if inflight < 0:
            raise ValueError(f"{key}maxInflightReads={inflight}: want >= 0")
        budget = None
        raw = str(self._get(pre + "replayBudget", "")).strip()
        if raw:
            budget = int(raw)
            if budget < 0:
                raise ValueError(f"{key}replayBudget={budget}: want >= 0")
        verify = None
        raw = str(self._get(pre + "integrity.verify", "")).strip()
        if raw:
            verify = validate_verify_level(raw,
                                           conf_key=key + "integrity.verify")
        depth = None
        raw = str(self._get(pre + "waveDepth", "")).strip()
        if raw:
            depth = int(raw)
            lo, hi = WAVE_DEPTH_RANGE
            if not lo <= depth <= hi:
                raise ValueError(f"{key}waveDepth={depth}: want {lo}..{hi}")
        return {"priority": priority, "max_bytes_in_flight": quota,
                "max_inflight_reads": inflight, "replay_budget": budget,
                "integrity_verify": verify, "wave_depth": depth}

    # -- the telemetry and decision planes (TELEMETRY_KEYS) -----------------
    def _telemetry(self, short: str) -> str:
        return self._get(short, TELEMETRY_KEYS[short][0])

    @property
    def trace_enabled(self) -> bool:
        return self.get_bool("trace.enabled", False)

    @property
    def trace_device(self) -> bool:
        return self.get_bool("trace.device", False)

    @property
    def trace_capacity(self) -> int:
        return int(self._telemetry("trace.capacity"))

    @property
    def metrics_dump_dir(self) -> Optional[str]:
        return self._telemetry("metrics.dumpDir") or None

    @property
    def metrics_dump_interval_secs(self) -> float:
        return float(self._telemetry("metrics.dumpIntervalSecs"))

    @property
    def devmon_enabled(self) -> bool:
        return self.get_bool("devmon.enabled", False)

    @property
    def devmon_interval_ms(self) -> float:
        return float(self._telemetry("devmon.intervalMs"))

    @property
    def history_dir(self) -> Optional[str]:
        return self._telemetry("history.dir") or None

    @property
    def history_window_secs(self) -> float:
        return float(self._telemetry("history.windowSecs"))

    @property
    def history_retain_windows(self) -> int:
        return int(self._telemetry("history.retainWindows"))

    @property
    def decisions_enabled(self) -> bool:
        return self.get_bool("decisions.enabled", True)

    @property
    def decisions_retain(self) -> int:
        return int(self._telemetry("decisions.retain"))
