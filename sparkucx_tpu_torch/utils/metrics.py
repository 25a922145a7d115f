"""Counters and a wall timer — the subset of the metrics plane the ported
reads increment (``shuffle.read.ms``, ``shuffle.read.count``,
``shuffle.rows``, ``shuffle.bytes``, ``shuffle.retries``, the D2H byte
counter :data:`C_D2H`, the kernel-fallback counter
:data:`C_KERNEL_FALLBACK`, the sink-fallback counter
:data:`C_SINK_FALLBACK`), the wave-gap histogram :data:`H_WAVE_GAP` and
the workload counters :data:`C_WORKLOAD_ROWS` and
:data:`C_WORKLOAD_PHASE_MS`, the spill counters :data:`C_SPILL_BYTES`
and :data:`C_SPILL_COUNT`, the admission counter
:data:`C_ADMIT_BYTES` with its wait histogram :data:`H_ADMIT_WAIT`, and
the MoE exchange counters (:data:`C_PAYLOAD_BYTES`, :data:`C_WIRE_BYTES`,
:data:`C_MOE_EXCHANGES`, :data:`C_MOE_ROWS`) with the host-staged
consumer's upload counter :data:`C_H2D`, the per-tier wire counter of
hierarchical reads :data:`C_TIER_BYTES`, and the failure and agreement
planes of distributed reads (:data:`C_PEER_TIMEOUT`, :data:`C_PROBE_DEAD`,
:data:`C_AGREE_ROUNDS`, :data:`C_AGREE_DIVERGENCE`,
:data:`H_AGREE_ROUND`), the replay counters :data:`C_REPLAYS` and
:data:`C_REPLAY_MS`, the retry histogram :data:`H_RETRY_MS`, each
read's wall :data:`H_FETCH_WAIT` and the integrity counters
(:data:`C_INTEGRITY_VERIFIED` and the four beside it), and the tenancy
plane's names (:data:`H_ADMIT_CROSS`, :data:`C_SUBMIT_THROTTLED`,
:data:`G_TENANT_INFLIGHT`) with the collective turnstile's
(:data:`H_TURNSTILE_WAIT`, :data:`G_TURNSTILE_DEPTH`,
:data:`C_TURNSTILE_ABANDONED`). Point-in-time values are gauges
(:meth:`Metrics.set_gauge`). A reporter (:meth:`Metrics.add_reporter`,
the flight recorder's ring) sees every increment and observation."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List

from sparkucx_tpu_torch.utils.logging import get_logger

# payload bytes a reader result pulled device-to-host
C_D2H = "shuffle.read.d2h.bytes"
# combine reads whose read.mergeImpl offered the kernel but resolved to
# the torch-op path; labeled(C_KERNEL_FALLBACK, reason=...) counts by reason
C_KERNEL_FALLBACK = "shuffle.kernel.fallback.count"
# reads that asked for the device sink but landed on the host;
# labeled(C_SINK_FALLBACK, mode=..., reason=...) counts by read mode/reason
C_SINK_FALLBACK = "shuffle.sink.fallback.count"
# waved reads: per wave after the first, the pack time the previous wave's
# exchange did not cover (ms); sustained positive gaps mean the device
# waits on the host pack
H_WAVE_GAP = "shuffle.wave.gap_ms"
# rows a workload run emitted or verified, and its per-phase walls (ms);
# both carry labeled twins {workload=...} / {workload=..., phase=...}
# (workloads.PhaseWalls.publish)
C_WORKLOAD_ROWS = "workload.rows"
C_WORKLOAD_PHASE_MS = "workload.phase.ms"
# bytes the map writers moved from host staging to sealed spill files,
# and the number of such moves (shuffle/writer.MapOutputWriter.
# _flush_to_disk: threshold spills and budget-forced spills alike)
C_SPILL_BYTES = "shuffle.spill.bytes"
C_SPILL_COUNT = "shuffle.spill.count"
# a2a.maxBytesInFlight: bytes of every granted reservation, and each
# grant's wait in the deferral queue (ms; 0 for an immediate grant)
C_ADMIT_BYTES = "shuffle.admit.bytes"
H_ADMIT_WAIT = "shuffle.admit.wait_ms"
# the tenancy plane (shuffle/tenancy.py), each labeled {tenant=...}: per
# deferred grant, the grants OTHER tenants received between its enqueue
# and its grant (a tenant parked behind another's flood observes the
# flood's length, one queueing behind its own reads ~0); async
# submissions that waited at tenant.<id>.maxInflightReads; the bytes a
# tenant holds reserved now (a gauge)
H_ADMIT_CROSS = "shuffle.admit.cross_grants"
C_SUBMIT_THROTTLED = "shuffle.submit.throttled.count"
G_TENANT_INFLIGHT = "shuffle.inflight.bytes"
# the collective turnstile (shuffle/agreement.CollectiveTurnstile): each
# ticket's issue-to-enter wait (ms), the issued-but-unreleased tickets (a
# gauge), and tickets released without entering
H_TURNSTILE_WAIT = "shuffle.turnstile.wait_ms"
G_TURNSTILE_DEPTH = "shuffle.turnstile.depth"
C_TURNSTILE_ABANDONED = "shuffle.turnstile.abandoned.count"
# bytes a host-staged consumer re-uploaded host-to-device after draining a
# host-sink read (models/moe.host_staged_consume): the round trip the
# device sink removes
C_H2D = "shuffle.consume.h2d.bytes"
# the MoE model's dispatch and combine exchanges (models/moe.py): payload
# bytes, the bytes at the wire tier's width, moves and rows moved
C_PAYLOAD_BYTES = "shuffle.payload.bytes"
C_WIRE_BYTES = "shuffle.wire.bytes"
C_MOE_EXCHANGES = "moe.exchange.count"
C_MOE_ROWS = "moe.exchange.rows"
# wire bytes each tier of a hierarchical read moved
# (ExchangeReport.tiers), labeled {tier="ici|dcn", tenant=...}
C_TIER_BYTES = "shuffle.tier.bytes"
# the watchdog's deadline expiries, and the devices its probe found dead
# (runtime/watchdog.py)
C_PEER_TIMEOUT = "failure.peer_timeout.count"
C_PROBE_DEAD = "failure.probe.dead"
# agreement rounds (every exit: agreed, divergent or peer-lost), the
# divergent ones, and each round's wall (ms); each with a {topic=} twin
# (shuffle/agreement.py)
C_AGREE_ROUNDS = "shuffle.agreement.rounds.count"
C_AGREE_DIVERGENCE = "shuffle.agreement.divergence.count"
H_AGREE_ROUND = "shuffle.agreement.round_ms"
# failure.policy=replay: exchange replays executed and the wall the failed
# attempts burned (ms); each read's wall (ms, failures included); the wall
# of each failed attempt RetryPolicy.run retried (ms)
C_REPLAYS = "shuffle.replay.count"
C_REPLAY_MS = "shuffle.replay.ms"
H_FETCH_WAIT = "shuffle.read.wait_ms"
H_RETRY_MS = "failure.retry.ms"
# the integrity plane (shuffle/integrity.py, the manager's verifies,
# shuffle/durable.py's restart scan): bytes verified, bytes and blocks
# found corrupt, maps the restart scan quarantined and maps it recovered
C_INTEGRITY_VERIFIED = "shuffle.integrity.verified.bytes"
C_INTEGRITY_CORRUPT = "shuffle.integrity.corrupt.bytes"
C_INTEGRITY_CORRUPT_BLOCKS = "shuffle.integrity.corrupt.count"
C_INTEGRITY_QUARANTINED = "shuffle.integrity.quarantined.count"
C_INTEGRITY_RECOVERED = "shuffle.integrity.recovered.count"


def labeled(name: str, **labels) -> str:
    """Labeled-metric identity ``name{k="v",...}`` (sorted keys)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Timer:
    """Context-manager wall timer; ``.ms`` after exit."""

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        self.ms = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1e3


class Metrics:
    """Thread-safe named counters, owned by a :class:`~sparkucx_tpu_torch.
    runtime.node.Node`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._histograms: Dict[str, Dict[str, float]] = {}
        self._gauges: Dict[str, float] = {}
        self._reporters: List[Callable[[str, float], None]] = []
        self._broken: set = set()

    def add_reporter(self, fn: Callable[[str, float], None]) -> None:
        """Attach ``fn(name, value)``, called on every :meth:`inc` and
        :meth:`observe`; a reporter that raises is logged once and never
        reaches the caller."""
        with self._lock:
            self._reporters.append(fn)

    def _report(self, name: str, value: float, reporters) -> None:
        for fn in reporters:
            try:
                fn(name, value)
            except Exception:
                if id(fn) not in self._broken:
                    self._broken.add(id(fn))
                    get_logger("metrics").exception(
                        "metrics reporter %r raised; further failures "
                        "from it are silenced", fn)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value
            reporters = list(self._reporters)
        self._report(name, value, reporters)

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def set_gauge(self, name: str, value) -> None:
        """Publish a point-in-time value; ``None`` clears the gauge (a
        source that cannot be sampled leaves no stale number)."""
        with self._lock:
            if value is None:
                self._gauges.pop(name, None)
            else:
                self._gauges[name] = float(value)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def gauges(self) -> Dict[str, float]:
        """``{identity: value}`` (plain names or :func:`labeled` forms)."""
        with self._lock:
            return dict(self._gauges)

    def observe(self, name: str, value: float) -> None:
        """Add one observation to the named histogram (count, sum, min,
        max)."""
        value = float(value)
        with self._lock:
            h = self._histograms.setdefault(
                name, {"count": 0.0, "sum": 0.0, "min": value, "max": value})
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            reporters = list(self._reporters)
        self._report(name, value, reporters)

    def histogram(self, name: str) -> Dict[str, float]:
        """The named histogram's summary ({} before its first
        observation)."""
        with self._lock:
            return dict(self._histograms.get(name, {}))

    def histograms(self) -> Dict[str, Dict[str, float]]:
        """Every histogram's summary, by name."""
        with self._lock:
            return {k: dict(v) for k, v in self._histograms.items()}
