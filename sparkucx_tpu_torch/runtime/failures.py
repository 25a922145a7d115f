"""Typed failures, fault injection, bounded retry, the flight recorder,
the device probe and the epoch plane (the JAX package's
``sparkucx_tpu/runtime/failures.py``).

* the errors: :class:`TransientError` (worth retrying) and under it
  :class:`InjectedFault` (an armed injection site fired),
  :class:`PeerLostError` (a collective outlived its deadline or its
  transport failed: a peer is dead) and :class:`BlockCorruptionError`
  with :class:`TruncatedBlockError` (the spill files raise it); the
  fatal :class:`StaleEpochError` and :class:`DeviceUnhealthy` (the
  probe found the device dead, or a local completion wait outlived its
  deadline);
* :class:`FlightRecorder` — a bounded ring of recent events (metric
  increments, epoch bumps, injected faults, retries, replays, tier
  faults) and a one-shot postmortem dump; :data:`NULL_FLIGHT_RECORDER`
  when ``flightRecorder.enabled`` is off;
* :class:`FaultInjector` — deterministic injection at named sites
  (``publish``, ``spill``, ``fetch``, ``exchange``, ``wave``,
  ``tier.ici``, ``tier.dcn``), armed from ``fault.*`` keys;
* :class:`RetryPolicy` — bounded backoff with decorrelated jitter over
  transient failures (the metadata fetch runs under it);
* :class:`ThreadLeakCensus` — the account of threads abandoned in a
  wedged device op or a dead collective, shared by the probe and the
  watchdog (``runtime/watchdog.py``);
* :class:`HealthMonitor` — a deadline-bound liveness probe of the node's
  device (one tiny device op joined on a watched thread);
* :class:`EpochManager` — monotonic membership epochs: a remesh bumps
  the epoch, and work pinned to an older one fails fast with
  :class:`StaleEpochError` instead of entering a collective that would
  hang.

The postmortem carries the reason, the event ring, the exchanges in
flight (``in_flight_traces``: the manager opens each read's trace id
with :meth:`FlightRecorder.begin_trace` and closes it at settlement;
ring events recorded meanwhile carry it), the process tracer's clock
anchor, span summary, chrome trace events and dropped-span count
(``utils/trace.py``), the counters, gauges and histograms of the
attached metrics and the context providers' output (the manager's
exchange reports, the node's decision ledger and SLO verdict) and the
doctor's ``findings`` on the dump itself (``utils/doctor.diagnose``)."""

from __future__ import annotations

import json
import os
import random
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sparkucx_tpu_torch.utils.atomicio import atomic_write_text
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import H_RETRY_MS

log = get_logger("runtime.failures")

# the jitter entropy of RetryPolicy when none is injected: seeded from the
# OS, so processes draw different backoff schedules
_JITTER_RNG = random.Random()


# -- errors ---------------------------------------------------------------
class TransientError(RuntimeError):
    """A failure worth retrying."""


class InjectedFault(TransientError):
    """Raised by the fault injector at an armed site."""


class PeerLostError(TransientError):
    """A collective outlived ``failure.collectiveTimeoutMs``, or its
    transport failed because a peer went away: a peer is unreachable or
    dead (``runtime/watchdog.py``). Raised instead of hanging the
    survivors, so a recovery controller can remesh and re-run."""


class BlockCorruptionError(TransientError):
    """A staged or spilled block no longer matches what its commit
    published."""


class TruncatedBlockError(BlockCorruptionError):
    """A spill file is shorter than its sealed sidecar declares — a torn
    write or an external truncation. Raised before the file is mapped,
    naming the file, so a reader never gets a short or garbage view."""


class StaleEpochError(RuntimeError):
    """Work references a membership epoch that a remesh invalidated."""


class DeviceUnhealthy(RuntimeError):
    """A device failed the liveness probe, or a wait on its own work
    outlived the deadline."""


# -- the flight recorder ----------------------------------------------------
class _NullFlightRecorder:
    """The recorder when ``flightRecorder.enabled`` is off: every call is
    a no-op, so call sites stay unconditional."""

    __slots__ = ()
    enabled = False

    def record(self, kind: str, **data) -> None:
        pass

    def metrics_reporter(self, name: str, value: float) -> None:
        pass

    def on_epoch_bump(self, epoch: int) -> None:
        pass

    def begin_trace(self, trace_id: str) -> None:
        pass

    def end_trace(self, trace_id: str) -> None:
        pass

    def current_trace(self) -> Optional[str]:
        return None

    def events(self):
        return []

    def dump(self, reason: str, extra: Optional[Dict] = None):
        return None

    def add_context_provider(self, fn) -> None:
        pass

    def remove_context_provider(self, fn) -> None:
        pass

    def install_abort_hook(self) -> None:
        pass

    def uninstall_abort_hook(self) -> None:
        pass


NULL_FLIGHT_RECORDER = _NullFlightRecorder()


class FlightRecorder:
    """A bounded ring of recent events and a one-shot postmortem dump.

    The ring keeps the last ``capacity`` events (``flightRecorder.
    capacity``, default 512), each ``{"t", "kind", ...}`` with ``t`` in
    seconds since the recorder started: metric increments and
    observations (through :meth:`metrics_reporter`), epoch bumps, injected
    faults, retries, replays and tier faults.

    :meth:`dump` writes one JSON file under ``out_dir``
    (``flightRecorder.dir``, default a per-process directory under the
    system temp directory): when a retry budget is spent, when the probe
    finds the device dead, or, with :meth:`install_abort_hook`, when an
    exception reaches ``sys.excepthook`` or ``threading.excepthook``.
    Recording and dumping never raise into the caller."""

    enabled = True

    def __init__(self, conf=None, capacity: int = 512,
                 out_dir: Optional[str] = None):
        if conf is not None:
            capacity = conf.get_int("flightRecorder.capacity", capacity)
            out_dir = out_dir or conf.get(
                "spark.shuffle.tpu.flightRecorder.dir")
        if not out_dir:
            out_dir = os.path.join(tempfile.gettempdir(),
                                   f"sparkucx_tpu_flight_{os.getpid()}")
        self.out_dir = out_dir
        self._events: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._providers: list = []
        self._warned = False
        self._prev_hook = None
        self.dumps: list = []          # paths written
        # metrics registries whose counters and histograms every dump
        # carries (the node appends its own)
        self.metrics_sources: list = []
        self._epoch = time.time()
        # the exchanges in flight, newest last (a stack: concurrent reads
        # from several threads overlap)
        self._inflight_traces: list = []

    # -- recording --------------------------------------------------------
    def begin_trace(self, trace_id: str) -> None:
        with self._lock:
            self._inflight_traces.append(trace_id)

    def end_trace(self, trace_id: str) -> None:
        with self._lock:
            try:
                self._inflight_traces.remove(trace_id)
            except ValueError:
                pass

    def current_trace(self) -> Optional[str]:
        """The newest in-flight exchange's trace id, or None (the device
        sampler stamps its samples with it)."""
        with self._lock:
            return self._inflight_traces[-1] if self._inflight_traces \
                else None

    def events(self):
        """The ring, oldest first (what a dump would carry)."""
        with self._lock:
            return list(self._events)

    def record(self, kind: str, **data) -> None:
        try:
            with self._lock:
                if self._inflight_traces and "trace" not in data:
                    data["trace"] = self._inflight_traces[-1]
                self._events.append(
                    {"t": round(time.time() - self._epoch, 6),
                     "kind": kind, **data})
        except Exception:
            self._warn_once("flight recorder record failed")

    def metrics_reporter(self, name: str, value: float) -> None:
        """``fn(name, value)`` for ``Metrics.add_reporter``: every counter
        increment and histogram observation lands in the ring."""
        self.record("metric", name=name, value=value)

    def on_epoch_bump(self, epoch: int) -> None:
        self.record("epoch", epoch=epoch)

    def add_context_provider(self, fn) -> None:
        """``fn() -> JSON-able``, called at dump time; its output goes
        under ``contexts[fn.__name__]``."""
        with self._lock:
            self._providers.append(fn)

    def remove_context_provider(self, fn) -> None:
        with self._lock:
            try:
                self._providers.remove(fn)
            except ValueError:
                pass

    # -- the postmortem ---------------------------------------------------
    def dump(self, reason: str, extra: Optional[Dict] = None
             ) -> Optional[str]:
        """Write the postmortem JSON; returns its path, or None when the
        write failed (a failing process must not fail harder because its
        recorder did). Keys: ``reason``, ``ts``, ``pid``, ``anchor``,
        ``in_flight_traces``, ``events``, ``counters``, ``gauges``,
        ``histograms`` (from the node's metrics), ``spans``,
        ``trace_events``, ``dropped_spans`` (the process tracer),
        ``contexts``, ``extra``'s, and ``findings`` (the doctor's, on
        this document)."""
        try:
            from sparkucx_tpu_torch.utils.export import \
                merge_histogram_snapshots
            from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
            with self._lock:
                events = list(self._events)
                providers = list(self._providers)
                inflight = list(self._inflight_traces)
            contexts: Dict = {}
            for fn in providers:
                name = getattr(fn, "__name__", repr(fn))
                try:
                    contexts[name] = fn()
                except Exception as e:
                    contexts[name] = f"<provider failed: {e!r}>"
            doc = {"reason": reason, "ts": time.time(), "pid": os.getpid(),
                   "anchor": GLOBAL_TRACER.anchor(),
                   "in_flight_traces": inflight,
                   "events": events, "counters": {}, "gauges": {},
                   "histograms": {},
                   "spans": GLOBAL_TRACER.summary(),
                   "trace_events": GLOBAL_TRACER.chrome_events(),
                   "dropped_spans": GLOBAL_TRACER.dropped,
                   "contexts": contexts}
            for m in self.metrics_sources:
                doc["counters"].update(m.snapshot())
                doc["gauges"].update(m.gauges())
                merge_histogram_snapshots(doc["histograms"],
                                          m.histograms())
            if extra:
                doc.update(extra)
            # the postmortem diagnoses itself; the manager's exchange
            # reports reach the report rules through ``contexts``
            try:
                from sparkucx_tpu_torch.utils.doctor import diagnose
                doc["findings"] = [f.to_dict() for f in diagnose(doc)]
            except Exception as e:
                doc["findings"] = [f"<doctor failed: {e!r}>"]
            os.makedirs(self.out_dir, exist_ok=True)
            slug = "".join(c if c.isalnum() else "-"
                           for c in reason.lower())[:40].strip("-")
            path = os.path.join(
                self.out_dir,
                f"flight_{int(time.time() * 1e3)}_{slug or 'dump'}.json")
            atomic_write_text(path, json.dumps(doc, default=str))
            self.dumps.append(path)
            log.error("flight recorder dumped postmortem (%s): %s", reason,
                      path)
            return path
        except Exception:
            self._warn_once("flight recorder dump failed")
            return None

    def _warn_once(self, msg: str) -> None:
        if not self._warned:
            self._warned = True
            log.exception("%s; further failures are silenced", msg)

    # -- the abort hook ---------------------------------------------------
    def install_abort_hook(self) -> None:
        """Dump on an exception that reaches ``sys.excepthook`` or
        ``threading.excepthook``; the previous hooks still run. Undone by
        :meth:`uninstall_abort_hook` (the node does it at close)."""
        if self._prev_hook is not None:
            return
        prev = sys.excepthook
        prev_thread = threading.excepthook

        def hook(exc_type, exc, tb):
            try:
                self.dump(f"unhandled {exc_type.__name__}: {exc}")
            finally:
                prev(exc_type, exc, tb)

        def thread_hook(args):
            try:
                self.dump(f"unhandled {args.exc_type.__name__} in thread "
                          f"{getattr(args.thread, 'name', '?')}: "
                          f"{args.exc_value}")
            finally:
                prev_thread(args)

        self._prev_hook = (prev, prev_thread)
        sys.excepthook = hook
        threading.excepthook = thread_hook

    def uninstall_abort_hook(self) -> None:
        if self._prev_hook is not None:
            sys.excepthook, threading.excepthook = self._prev_hook
            self._prev_hook = None


# -- fault injection --------------------------------------------------------
class FaultInjector:
    """Deterministic fault injection at named sites, armed from conf::

        spark.shuffle.tpu.fault.<site>.failCount = N   # fail the first N hits
        spark.shuffle.tpu.fault.<site>.failRate  = p   # else fail w.p. p
        spark.shuffle.tpu.fault.<site>.delayMs   = ms  # sleep at each hit
        spark.shuffle.tpu.fault.<site>.offset    = b   # a corrupt site's byte
        spark.shuffle.tpu.fault.seed             = s   # the rate's draws

    (the knob names match case-insensitively) or :meth:`arm`. Sites:
    ``publish`` (a map's commit), ``spill`` (a writer's move to disk),
    ``fetch`` (the metadata table fetch), ``exchange`` (before a read's
    dispatch), ``wave`` (before each wave of a waved read), ``tier.ici``
    and ``tier.dcn`` (each tier's join of a hierarchical read), and the
    corrupt pair ``corrupt.staged`` / ``corrupt.spill``, consumed through
    :meth:`fire`: instead of raising, a firing tells the read's staged
    verify to flip one bit of the staged buffer / sealed spill file at
    the site's ``offset``, which the verify must then detect.

    While anything is armed, every :meth:`check` of any site counts a hit
    and, unless the site has fail counts left, draws one number from
    ``numpy.random.default_rng(seed)``; so one conf and one sequence of
    hits give one firing sequence. With nothing armed a check does no
    work."""

    def __init__(self, conf=None, seed: Optional[int] = None,
                 flight=NULL_FLIGHT_RECORDER):
        self.flight = flight
        self._lock = threading.Lock()
        self._fail_count: Dict[str, int] = {}
        self._fail_rate: Dict[str, float] = {}
        self._delay_ms: Dict[str, float] = {}
        self._offset: Dict[str, int] = {}
        self._hits: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        if conf is not None:
            seed = seed if seed is not None else conf.get_int("fault.seed", 0)
            prefix = "spark.shuffle.tpu.fault."
            for key, val in conf.items():
                if not key.startswith(prefix) or key.endswith(".seed"):
                    continue
                tail = key[len(prefix):]
                if "." not in tail:
                    continue
                site, knob = tail.rsplit(".", 1)
                knob = knob.lower()
                if knob == "failcount":
                    self._fail_count[site] = int(val)
                elif knob == "failrate":
                    self._fail_rate[site] = float(val)
                elif knob == "delayms":
                    self._delay_ms[site] = float(val)
                elif knob == "offset":
                    self._offset[site] = int(val)
        self._rng = np.random.default_rng(seed or 0)

    def arm(self, site: str, fail_count: int = 0, fail_rate: float = 0.0,
            delay_ms: float = 0.0, offset: Optional[int] = None) -> None:
        with self._lock:
            if fail_count:
                self._fail_count[site] = fail_count
            if fail_rate:
                self._fail_rate[site] = fail_rate
            if delay_ms:
                self._delay_ms[site] = delay_ms
            if offset is not None:
                self._offset[site] = int(offset)

    def disarm(self, site: str) -> None:
        with self._lock:
            self._fail_count.pop(site, None)
            self._fail_rate.pop(site, None)
            self._delay_ms.pop(site, None)
            self._offset.pop(site, None)

    @property
    def active(self) -> bool:
        return bool(self._fail_count or self._fail_rate or self._delay_ms)

    def check(self, site: str) -> None:
        """An injection site: raises :class:`InjectedFault` when it fires
        (after the site's ``delayMs``, if any)."""
        if not self.active:
            return
        with self._lock:
            delay = self._delay_ms.get(site, 0.0)
            self._hits[site] = self._hits.get(site, 0) + 1
            remaining = self._fail_count.get(site, 0)
            if remaining > 0:
                self._fail_count[site] = remaining - 1
                fired = True
            else:
                fired = bool(self._rng.random()
                             < self._fail_rate.get(site, 0.0))
            if fired:
                self._injected[site] = self._injected.get(site, 0) + 1
        if delay:
            time.sleep(delay / 1e3)
        if fired:
            self.flight.record("fault", site=site)
            raise InjectedFault(f"injected fault at site {site!r}")

    def fire(self, site: str) -> Optional[int]:
        """A corrupt site's :meth:`check`: when the site fires, one firing
        is consumed, a ``fault`` ring event records the offset, and the
        armed byte offset (default 0) is returned instead of a raise;
        None otherwise. No work while nothing is armed."""
        if not self.active:
            return None
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            remaining = self._fail_count.get(site, 0)
            if remaining > 0:
                self._fail_count[site] = remaining - 1
                fired = True
            else:
                fired = bool(self._rng.random()
                             < self._fail_rate.get(site, 0.0))
            if fired:
                self._injected[site] = self._injected.get(site, 0) + 1
            offset = self._offset.get(site, 0)
        if fired:
            self.flight.record("fault", site=site, offset=offset)
            return offset
        return None

    def stats(self) -> Dict[str, Tuple[int, int]]:
        """``{site: (hits, injected)}``."""
        with self._lock:
            return {s: (self._hits.get(s, 0), self._injected.get(s, 0))
                    for s in set(self._hits) | set(self._injected)}


# -- retry ------------------------------------------------------------------
@dataclass(frozen=True)
class RetryPolicy:
    """Bounded backoff over transient failures (the metadata fetch's
    retry; the data plane's overflow regrow is a plan change, not a
    re-run).

    With ``jitter`` (default) the first delay is uniform in ``[backoff_ms,
    backoff_ms * backoff_factor]`` and each later one uniform in
    ``[backoff_ms, 3 * previous]`` (decorrelated jitter, so processes that
    fail together do not retry together); without it the delays are
    geometric. Every delay is capped at ``max_backoff_ms``, and
    ``total_deadline_ms`` (``failure.collectiveTimeoutMs`` from conf)
    stops the retries once the next sleep would cross it. Each failed
    attempt's wall goes into ``metrics``' ``failure.retry.ms`` histogram
    and a ``retry`` ring event; the last failure dumps the flight
    recorder's postmortem."""

    max_attempts: int = 3
    backoff_ms: float = 10.0
    backoff_factor: float = 2.0
    jitter: bool = True
    max_backoff_ms: float = 10_000.0
    total_deadline_ms: Optional[float] = None
    retryable: Tuple[type, ...] = (TransientError,)
    # the jitter's entropy (anything with ``uniform(a, b)``); None = the
    # process's own OS-seeded random.Random
    rng: Optional[object] = field(default=None, compare=False, repr=False)
    metrics: Optional[object] = field(default=None, compare=False,
                                      repr=False)
    flight: object = field(default=NULL_FLIGHT_RECORDER, compare=False,
                           repr=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1 (1 = no retries), got "
                f"{self.max_attempts}")
        if self.max_backoff_ms < self.backoff_ms:
            raise ValueError(
                f"max_backoff_ms={self.max_backoff_ms} < "
                f"backoff_ms={self.backoff_ms}")

    def next_delay_ms(self, prev_ms: Optional[float]) -> float:
        """The sleep before the next attempt, from the previous one (None
        before the first retry)."""
        rng = self.rng if self.rng is not None else _JITTER_RNG
        if prev_ms is None:
            first = self.backoff_ms
            if self.jitter:
                first = rng.uniform(self.backoff_ms,
                                    self.backoff_ms * self.backoff_factor)
            return min(first, self.max_backoff_ms)
        if not self.jitter:
            return min(prev_ms * self.backoff_factor, self.max_backoff_ms)
        return min(rng.uniform(self.backoff_ms, prev_ms * 3.0),
                   self.max_backoff_ms)

    def run(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)``, retried on ``retryable`` errors."""
        deadline = None if not self.total_deadline_ms else \
            time.monotonic() + self.total_deadline_ms / 1e3
        delay_ms: Optional[float] = None
        for attempt in range(1, self.max_attempts + 1):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                ms = (time.perf_counter() - t0) * 1e3
                try:
                    if self.metrics is not None:
                        self.metrics.observe(H_RETRY_MS, ms)
                    self.flight.record("retry", attempt=attempt,
                                       error=repr(e)[:200], ms=round(ms, 3))
                    from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
                    GLOBAL_TRACER.instant("retry", attempt=attempt,
                                          error=repr(e)[:200])
                except Exception:
                    log.debug("retry telemetry failed", exc_info=True)
                if attempt == self.max_attempts:
                    self.flight.dump(f"retry budget exhausted after "
                                     f"{attempt} attempts: {e!r}")
                    raise
                delay_ms = self.next_delay_ms(delay_ms)
                if deadline is not None and \
                        time.monotonic() + delay_ms / 1e3 >= deadline:
                    self.flight.dump(
                        f"retry deadline exhausted after {attempt} "
                        f"attempts ({self.total_deadline_ms:.0f} ms "
                        f"budget): {e!r}")
                    raise
                log.info("attempt %d/%d failed (%s); retrying in %.0f ms",
                         attempt, self.max_attempts, e, delay_ms)
                time.sleep(delay_ms / 1e3)

    @classmethod
    def from_conf(cls, conf, metrics=None,
                  flight=NULL_FLIGHT_RECORDER) -> "RetryPolicy":
        """``failure.maxAttempts`` (3), ``failure.backoffMs`` (10),
        ``failure.maxBackoffMs`` (10,000; never below the base) and
        ``failure.collectiveTimeoutMs`` as the total deadline (0 = none)."""
        collective_ms = conf.get_float("failure.collectiveTimeoutMs", 0.0)
        backoff = conf.get_float("failure.backoffMs", 10.0)
        return cls(
            max_attempts=conf.get_int("failure.maxAttempts", 3),
            backoff_ms=backoff,
            max_backoff_ms=max(
                conf.get_float("failure.maxBackoffMs", 10_000.0), backoff),
            total_deadline_ms=collective_ms if collective_ms > 0 else None,
            metrics=metrics, flight=flight)


# -- health ---------------------------------------------------------------
class ThreadLeakCensus:
    """Daemon threads abandoned in a wedged device op or a dead
    collective, by key; finished threads age out on every access. Warns
    exactly once, the first time the census reaches ``warn_at``."""

    def __init__(self, warn_at: int, warning: str, logger=None):
        self._lock = threading.Lock()
        self._items: Dict[str, threading.Thread] = {}
        self._warn_at = int(warn_at)
        self._warning = warning          # one %d slot: the census size
        self._logger = logger if logger is not None else log
        self._warned = False

    def _sweep_locked(self) -> None:
        self._items = {k: t for k, t in self._items.items()
                       if t.is_alive()}

    def count(self) -> int:
        with self._lock:
            self._sweep_locked()
            return len(self._items)

    def keys(self) -> set:
        """Keys of the threads still parked."""
        with self._lock:
            self._sweep_locked()
            return set(self._items)

    def add(self, key: str, thread: threading.Thread) -> int:
        """Track one abandoned thread; returns the census size after."""
        with self._lock:
            self._sweep_locked()
            self._items[key] = thread
            n = len(self._items)
            warn = n >= self._warn_at and not self._warned
            if warn:
                self._warned = True
        if warn:
            self._logger.warning(self._warning, n)
        return n


class HealthMonitor:
    """Liveness probe of the node's device.

    ``probe()`` runs a tiny op on the device (a sum of 8 ones, read back
    to the host) on a daemon thread and joins it against ``timeout_ms``.
    A probe thread that outlives its deadline stays parked in the wedged
    op; it is tracked, and the device is reported dead without another
    thread until that one returns. A failed :meth:`assert_healthy`
    records a ``device_unhealthy`` event, dumps the flight recorder and
    calls ``on_unhealthy(bad)`` when set (the node marks itself
    unhealthy there)."""

    def __init__(self, device, timeout_ms: float = 30_000.0,
                 flight=NULL_FLIGHT_RECORDER):
        self.device = torch.device(device)
        self.timeout_ms = float(timeout_ms)
        self.flight = flight
        self.on_unhealthy = None
        self._stuck = ThreadLeakCensus(
            warn_at=1,
            warning=("%d probe thread(s) exceeded the "
                     f"{self.timeout_ms:.0f} ms deadline and remain parked;"
                     " the device stays marked dead until they return"))

    def _run_one(self, out: list) -> None:
        """The device op (seam: tests wedge the device here)."""
        try:
            x = torch.ones(8, dtype=torch.float32, device=self.device)
            out[0] = bool(np.isfinite(float(x.sum().item())))
        except Exception as e:
            log.warning("probe failed on %s: %s", self.device, e)
            out[0] = False

    @property
    def leaked_probe_threads(self) -> int:
        return self._stuck.count()

    def probe(self) -> Dict[str, bool]:
        """``{device: alive}``."""
        name = str(self.device)
        if name in self._stuck.keys():
            return {name: False}
        out = [False]
        t = threading.Thread(target=self._run_one, args=(out,), daemon=True,
                             name="sxt-probe")
        t.start()
        t.join(self.timeout_ms / 1e3)
        if t.is_alive():
            self._stuck.add(name, t)
            return {name: False}
        return {name: out[0]}

    def assert_healthy(self) -> None:
        bad = [d for d, ok in self.probe().items() if not ok]
        if bad:
            self.flight.record("device_unhealthy", devices=bad)
            self.flight.dump(f"DeviceUnhealthy: {bad}")
            if self.on_unhealthy is not None:
                try:
                    self.on_unhealthy(bad)
                except Exception:
                    log.debug("on_unhealthy callback failed",
                              exc_info=True)
            raise DeviceUnhealthy(f"devices failed liveness probe: {bad}")


# -- epochs ---------------------------------------------------------------
class EpochManager:
    """Monotonic membership epochs. Every shuffle registration captures
    ``current``; a membership change calls :meth:`bump`; stale work
    raises :class:`StaleEpochError` at its next :meth:`validate` instead
    of issuing a collective that would hang. Bump listeners run after the
    epoch moved (the agreement plane resets its round sequence there)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._epoch = 0
        self._listeners = []

    @property
    def current(self) -> int:
        with self._lock:
            return self._epoch

    def bump(self, reason: str = "") -> int:
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
            listeners = list(self._listeners)
        log.info("mesh epoch -> %d (%s)", epoch, reason or "remesh")
        for fn in listeners:
            fn(epoch)
        return epoch

    def on_bump(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[int], None]) -> None:
        """Deregister a bump listener (no-op if absent)."""
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def validate(self, epoch: int, what: str = "work") -> None:
        cur = self.current
        if epoch != cur:
            raise StaleEpochError(
                f"{what} pinned to epoch {epoch}, mesh is at {cur}; "
                f"re-register after remesh")
