"""Counters, log-bucket histograms, gauges and timers — the metrics plane
of the port (the JAX package's ``sparkucx_tpu/utils/metrics.py``).

:class:`Metrics` is a node's registry: named counters (``inc``), fixed
log-bucket :class:`Histogram` distributions (``observe``; the names in
:data:`WELL_KNOWN_HISTOGRAMS` exist from construction, so an exporter
sees the full surface before the first read), set-semantics gauges
(``set_gauge``) and reporters that see every increment and observation
(the flight recorder's ring). Labeled identities are
``name{k="v",...}`` (:func:`labeled` / :func:`parse_labeled`), one
encoding shared by the registry, the JSON snapshot and the Prometheus
exporter (``utils/export.py``).

The names below are the ones the port's planes count into: the read
path (``shuffle.read.*``, :data:`H_FETCH_WAIT`, the per-peer
:data:`H_PEER_ROWS` / :data:`H_PEER_BYTES`, the achieved rate
:data:`H_BW`, the D2H / H2D byte counters, the kernel and sink
fallbacks, the wave gap), workloads and spill, admission and tenancy,
the MoE exchange counters, the per-tier wire bytes, the failure,
agreement and turnstile planes, replay, the integrity plane, the
tracer's drop counter :data:`C_TRACE_DROPPED` and the device-memory
gauges :data:`G_HBM_IN_USE` / :data:`G_HBM_LIMIT` / :data:`G_HBM_PEAK`
(``runtime/devmon.py``). :data:`H_FETCH_FIRST` and
:data:`H_COMPILE_SECS` belong to the JAX package's per-shape compiles:
the port pre-registers them (its exposition has the reference's
surface) and observes nothing into them."""

from __future__ import annotations

import contextlib
import math
import re
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

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
# the per-peer rows and bytes of every exchange (one observation per
# shard), and each completed exchange's achieved payload rate (GB/s)
H_PEER_ROWS = "shuffle.peer.rows"
H_PEER_BYTES = "shuffle.peer.bytes"
H_BW = "shuffle.collective.bw_gbps"
# the JAX package's compile-bearing reads and per-program compile
# seconds: pre-registered for the same exposition surface, never
# observed by the port (eager PyTorch compiles nothing per shape)
H_FETCH_FIRST = "shuffle.read.first_wait_ms"
H_COMPILE_SECS = "compile.step.duration_s"

WELL_KNOWN_HISTOGRAMS = (H_FETCH_WAIT, H_FETCH_FIRST, H_PEER_ROWS,
                         H_PEER_BYTES, H_RETRY_MS, H_COMPILE_SECS,
                         H_WAVE_GAP, H_BW)

# wall ms per canonical exchange phase, labeled {phase=...} (the
# anatomy fold, not ported yet), and the tracer ring's drops published
# as a counter (utils/trace.Tracer.publish_dropped)
C_PHASE_MS = "shuffle.phase.ms"
C_TRACE_DROPPED = "trace.spans.dropped"
# device-memory gauges per device index (runtime/devmon.py), labeled
# {device=...}
G_HBM_IN_USE = "devmon.hbm.in_use"
G_HBM_LIMIT = "devmon.hbm.limit"
G_HBM_PEAK = "devmon.hbm.peak"


def escape_label_value(value) -> str:
    """Prometheus exposition label-value escaping: backslash, quote and
    newline. Applied when a label is ENCODED into a metric identity
    (``labeled``), so the canonical key itself is exposition-legal and a
    hostile-looking value (device paths, rule names) can never corrupt a
    scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


_LABELED_RE = re.compile(r"^([^{}\n]+)\{(.*)\}$", re.S)
_LABEL_ITEM_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")


def labeled(name: str, **labels) -> str:
    """Canonical labeled-metric identity: ``name{k="v",...}`` with sorted
    keys and escaped values — ONE encoding shared by the gauge registry,
    the JSON snapshot (keys must be stable for the doctor's build_view)
    and the Prometheus exporter (which emits the label block verbatim
    after sanitizing the name parts)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def parse_labeled(name: str):
    """Inverse of :func:`labeled`: ``(base, {k: v})`` with UNescaped
    values, or ``(name, None)`` when the identity carries no parseable
    label block (including hostile brace garbage — the exporter then
    sanitizes the whole string as a plain name)."""
    m = _LABELED_RE.match(name)
    if not m:
        return name, None
    base, inner = m.groups()
    items = _LABEL_ITEM_RE.findall(inner)
    if not items:
        return name, None
    out = {}
    for k, v in items:
        # ONE pass: sequential str.replace would mangle a literal
        # backslash adjacent to 'n' ("\\n" must stay backslash+n)
        out[k] = _UNESCAPE_RE.sub(
            lambda m: "\n" if m.group(1) == "n" else m.group(1), v)
    return base, out


class Histogram:
    """Thread-safe fixed log-bucket histogram with live p50/p99/max.

    Buckets are a fixed geometric ladder ``GROWTH**k`` (8 per octave, so
    consecutive bucket bounds differ by ~9%); an observation lands in the
    smallest bucket whose upper bound covers it. Quantiles interpolate at
    the geometric midpoint of the hit bucket clipped to the observed
    [min, max], bounding relative quantile error by half a bucket (~4.5%)
    — the trade the reference's per-fetch log line can't make (exact
    values, but only in a log file). Memory is O(occupied buckets): a
    sparse dict, ~no cost until observed."""

    GROWTH = 2.0 ** 0.125
    _LOG_G = math.log(GROWTH)

    __slots__ = ("name", "_lock", "_counts", "_nonpos", "count", "sum",
                 "min", "max")

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._nonpos = 0          # observations <= 0 (their own bucket)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, value: float) -> int:
        # smallest k with GROWTH**k >= value
        return int(math.ceil(math.log(value) / self._LOG_G - 1e-9))

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            if value <= 0.0:
                self._nonpos += 1
            else:
                idx = self._index(value)
                self._counts[idx] = self._counts.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1) of everything observed."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = self._nonpos
        if cum >= target and self._nonpos:
            return min(self.min, 0.0)
        for idx in sorted(self._counts):
            cum += self._counts[idx]
            if cum >= target:
                lo = self.GROWTH ** (idx - 1)
                hi = self.GROWTH ** idx
                est = math.sqrt(lo * hi)    # geometric midpoint
                return min(max(est, self.min), self.max)
        return self.max

    def _percentiles_locked(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0.0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p99": 0.0}
        return {
            "count": float(self.count),
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": self._quantile_locked(0.50),
            "p99": self._quantile_locked(0.99),
        }

    def percentiles(self) -> Dict[str, float]:
        with self._lock:
            return self._percentiles_locked()

    def _buckets_locked(self) -> List[Tuple[float, int]]:
        out: List[Tuple[float, int]] = []
        cum = self._nonpos
        if self._nonpos:
            out.append((0.0, cum))
        for idx in sorted(self._counts):
            cum += self._counts[idx]
            out.append((self.GROWTH ** idx, cum))
        out.append((math.inf, self.count))
        return out

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative ``(upper_bound, count_leq)`` pairs over occupied
        buckets plus the +Inf terminal — the Prometheus histogram series
        shape (utils/export.py renders these as ``_bucket{le=...}``)."""
        with self._lock:
            return self._buckets_locked()

    def snapshot(self) -> Dict:
        """percentiles() plus the bucket series — the JSON-able full
        state an exporter or flight-recorder dump embeds. The bucket
        bounds are exact ladder values (GROWTH**k survives a JSON float
        round-trip bit-for-bit), so :meth:`from_snapshot` reconstructs
        the histogram losslessly — the property the doctor's
        cluster-wide aggregation (merge over per-process dumps) rides.
        ONE lock acquisition for both halves: a concurrent observe
        between percentiles and buckets would otherwise publish a +Inf
        bucket that disagrees with ``count`` — invalid Prometheus
        exposition and a skewed from_snapshot reconstruction."""
        with self._lock:
            snap = self._percentiles_locked()
            snap["buckets"] = [[le, c]
                               for le, c in self._buckets_locked()]
        return snap

    # to_snapshot is the doctor-facing name; snapshot() predates it
    to_snapshot = snapshot

    @classmethod
    def from_snapshot(cls, snap: Dict, name: str = "") -> "Histogram":
        """Rebuild a histogram from :meth:`snapshot` output (a dump
        written by another process, possibly dead). Per-bucket counts
        come from differencing the cumulative series; the bucket index
        from inverting the exact ladder bound."""
        h = cls(name)
        count = int(snap.get("count", 0))
        if count == 0:
            return h
        h.count = count
        h.sum = float(snap.get("sum", 0.0))
        h.min = float(snap.get("min", 0.0))
        h.max = float(snap.get("max", 0.0))
        prev = 0
        for le, cum in snap.get("buckets", []):
            le, cum = float(le), int(cum)
            c, prev = cum - prev, cum
            if c <= 0:
                continue
            if le <= 0.0:
                h._nonpos += c
            elif le == math.inf:
                # terminal diff should be 0 for a well-formed snapshot;
                # a truncated bucket list attributes the tail to max
                idx = h._index(h.max if h.max > 0 else 1.0)
                h._counts[idx] = h._counts.get(idx, 0) + c
            else:
                idx = int(round(math.log(le) / cls._LOG_G))
                h._counts[idx] = h._counts.get(idx, 0) + c
        return h

    @classmethod
    def snapshot_delta(cls, cur: Dict, prev: Optional[Dict],
                       name: str = "") -> Dict:
        """The WINDOW between two snapshots of the SAME cumulative
        histogram, as a snapshot dict: counts and sums subtract, and the
        cumulative bucket series subtracts bucket-wise (same fixed
        ladder, so per-bucket counts diff exactly). This is the time
        axis the telemetry plane lacked — ``utils/history.py`` calls it
        per retained window so the SLO plane can ask "what was p99 in
        the LAST five minutes" instead of since boot.

        ``prev`` of ``None``/empty means the window starts at zero (the
        first frame IS the cumulative state). A shrinking count means
        the source registry restarted mid-window; the honest answer is
        the current cumulative state, not a negative window.

        The window's min/max are NOT recoverable from two cumulative
        snapshots (the cumulative min/max may predate the window), so
        they are estimated from the occupied delta buckets' geometric
        bounds — the same half-bucket error contract quantiles already
        carry."""
        if not prev or not int(prev.get("count", 0)):
            return dict(cur)
        c0, c1 = int(prev.get("count", 0)), int(cur.get("count", 0))
        if c1 < c0:           # source registry restarted: window = cur
            return dict(cur)
        empty = {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                 "mean": 0.0, "p50": 0.0, "p99": 0.0,
                 "buckets": [[math.inf, 0]]}
        if c1 == c0:
            return dict(empty)

        def _per_bucket(snap):
            out, prior = {}, 0
            for le, cum in snap.get("buckets", []):
                le, cum = float(le), int(cum)
                if le == math.inf:
                    continue      # terminal carries no bucket of its own
                out[le] = cum - prior
                prior = cum
            return out

        b_cur, b_prev = _per_bucket(cur), _per_bucket(prev)
        count = c1 - c0
        cum, series = 0, []
        occupied: List[float] = []
        for le in sorted(set(b_cur) | set(b_prev)):
            c = max(0, b_cur.get(le, 0) - b_prev.get(le, 0))
            if c:
                cum += c
                series.append([le, cum])
                occupied.append(le)
        series.append([math.inf, count])
        # min/max estimates from the occupied bounds (lower geometric
        # neighbour for min), clipped to the cumulative envelope
        if occupied:
            lo = occupied[0] / cls.GROWTH if occupied[0] > 0 else \
                min(float(cur.get("min", 0.0)), 0.0)
            hi = occupied[-1]
        else:
            lo = hi = 0.0
        lo = max(lo, float(cur.get("min", lo)))
        hi = min(hi, float(cur.get("max", hi))) if hi else hi
        s = float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0))
        h = cls.from_snapshot(
            {"count": count, "sum": s, "min": lo, "max": hi,
             "buckets": series}, name)
        return h.snapshot()

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations into this histogram (exact —
        same fixed ladder, so bucket counts add). The cluster-wide
        aggregation primitive: N per-process dumps merge into ONE
        distribution the doctor's rules evaluate. Returns self."""
        with other._lock:
            counts = dict(other._counts)
            nonpos, count = other._nonpos, other.count
            osum, omin, omax = other.sum, other.min, other.max
        with self._lock:
            for idx, c in counts.items():
                self._counts[idx] = self._counts.get(idx, 0) + c
            self._nonpos += nonpos
            self.count += count
            self.sum += osum
            if omin < self.min:
                self.min = omin
            if omax > self.max:
                self.max = omax
        return self


class Timer:
    """Context-manager wall timer; ``.ms`` after exit."""

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        self.ms = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1e3


class Metrics:
    """Thread-safe named counters, histograms and gauges, owned by a
    :class:`~sparkucx_tpu_torch.runtime.node.Node`.

    Reporters (:meth:`add_reporter`) see every :meth:`inc` and
    :meth:`observe` as ``fn(name, value)``; one that raises is logged
    once and never reaches the caller. Gauges are set-semantics values
    (a watermark that goes down), and reporters do not see them: the
    device sampler re-publishes them on a cadence."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._reporters: List[Callable[[str, float], None]] = []
        self._broken: set = set()
        self._histograms: Dict[str, Histogram] = {
            name: Histogram(name) for name in WELL_KNOWN_HISTOGRAMS}

    def add_reporter(self, fn: Callable[[str, float], None]) -> None:
        """Attach ``fn(name, value)``, called on every :meth:`inc` and
        :meth:`observe`."""
        with self._lock:
            self._reporters.append(fn)

    def remove_reporter(self, fn) -> None:
        with self._lock:
            try:
                self._reporters.remove(fn)
            except ValueError:
                pass

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

    def observe(self, name: str, value: float) -> None:
        """Add one observation to the named histogram (created on first
        use). With no reporter attached and the histogram present, the
        registry lock is skipped (both reads are atomic under the GIL,
        and histograms are only ever added)."""
        h = self._histograms.get(name)
        if h is not None and not self._reporters:
            h.observe(value)
            return
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            reporters = list(self._reporters)
        h.observe(value)
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

    def histogram(self, name: str) -> Optional[Histogram]:
        """The named :class:`Histogram`, or None before its first
        observation (the well-known names exist from construction)."""
        with self._lock:
            return self._histograms.get(name)

    def histograms(self, populated_only: bool = False) -> Dict[str, Dict]:
        """``{name: Histogram.snapshot()}``; ``populated_only`` skips the
        empty ones."""
        with self._lock:
            hists = list(self._histograms.items())
        return {name: h.snapshot() for name, h in hists
                if not populated_only or h.count}

    @contextlib.contextmanager
    def timeit(self, name: str, hist: Optional[str] = None):
        """Counter timer: adds the wall ms to ``name.ms`` and one to
        ``name.count``; ``hist=`` also observes the ms into that
        histogram."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.inc(name + ".ms", ms)
            self.inc(name + ".count", 1)
            if hist is not None:
                self.observe(hist, ms)
