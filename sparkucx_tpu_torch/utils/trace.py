"""Structured tracing — spans, Chrome-trace export and the device
profiler hooks (the JAX package's ``sparkucx_tpu/utils/trace.py``).

Nested wall-clock spans on the host, a Chrome ``chrome://tracing`` /
Perfetto export, and, on the card, ``torch.profiler``: under
``trace.device`` every span also opens a
``torch.profiler.record_function`` range, so a :meth:`Tracer.
device_trace` capture shows the host spans in the same timeline as the
CUDA kernels they launched. Where the JAX package writes a TensorBoard
profile through ``jax.profiler``, :meth:`Tracer.device_trace` writes
``torch.profiler``'s Chrome trace (CPU activity, and CUDA activity when
a card is present) into its ``logdir``.

* **Near-zero cost when disabled.** ``span()`` on a disabled tracer
  returns one shared no-op context manager: no allocation, no clock
  read. Enable with ``spark.shuffle.tpu.trace.enabled`` or
  ``Tracer(enabled=True)``.
* **Thread-safe, nesting-aware.** Spans nest per thread; each thread's
  spans carry its own ``tid`` (its own track in the export).
* **Bounded memory.** A ring of ``capacity`` finished spans; drops are
  counted (:attr:`Tracer.dropped`), never silent.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from sparkucx_tpu_torch.utils.atomicio import atomic_write_text
from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("trace")


def format_trace_id(shuffle_id: int, epoch: int, seq: int) -> str:
    """The cluster-correlation key ``(shuffle_id, epoch, exchange_seq)``
    as one grep-able token, ``s<sid>.e<epoch>.x<seq>``. Distributed
    reads are collectives that run in the same order on every process,
    so the per-process exchange sequence number agrees cluster-wide:
    one trace id names one exchange in every process's spans, reports
    and flight events."""
    return f"s{shuffle_id}.e{epoch}.x{seq}"


@dataclass
class Span:
    """One finished span (Chrome trace 'X' event)."""

    name: str
    start_us: float
    dur_us: float
    tid: int
    depth: int
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return self.dur_us / 1e3


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):  # parity with _LiveSpan
        return self


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_annot")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._annot = None

    def set(self, **attrs) -> "_LiveSpan":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        tls = self._tracer._tls
        tls.depth = getattr(tls, "depth", 0) + 1
        if self._tracer.annotate_device:
            # a range in torch.profiler's trace, beside the kernels the
            # span launches
            import torch
            self._annot = torch.profiler.record_function(self.name)
            self._annot.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        tls = self._tracer._tls
        depth = getattr(tls, "depth", 1)
        tls.depth = depth - 1
        self._tracer._record(Span(
            name=self.name,
            start_us=(self._t0 - self._tracer._epoch) * 1e6,
            dur_us=(t1 - self._t0) * 1e6,
            tid=threading.get_ident(),
            depth=depth - 1,
            attrs=self.attrs,
        ))
        return False


class Tracer:
    """Span collector with Chrome-trace export.

    ``annotate_device=True`` also opens a ``torch.profiler.
    record_function`` range around every span, so host spans line up
    with the CUDA kernels inside a :meth:`device_trace` capture."""

    def __init__(self, enabled: bool = False, capacity: int = 65536,
                 annotate_device: bool = False):
        self.enabled = enabled
        self.annotate_device = annotate_device
        self._spans: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._published_dropped = 0
        self._capacity = capacity
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._epoch = time.perf_counter()
        self._device_traces = 0
        self.device_trace_path: Optional[str] = None

    # -- recording --------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing one region. No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        self._record(Span(name, (time.perf_counter() - self._epoch) * 1e6,
                          0.0, threading.get_ident(), 0, attrs))

    def record_span(self, name: str, t0: float, t1: Optional[float] = None,
                    **attrs) -> None:
        """Record a span from explicit ``perf_counter`` endpoints — for
        regions whose start predates knowing whether (or under what
        name/attrs) they'd be recorded. The exchange WALL span is the
        canonical user: ``ExchangeReport`` stamps its start inside
        ``submit()`` and the settlement callback closes it with the
        trace id only once the read is fully notified. No-op when
        disabled — ONE branch, so the disabled read path pays a single
        attribute check per exchange."""
        if not self.enabled:
            return
        if t1 is None:
            t1 = time.perf_counter()
        self._record(Span(name, (t0 - self._epoch) * 1e6,
                          (t1 - t0) * 1e6, threading.get_ident(), 0,
                          attrs))

    def _record(self, s: Span) -> None:
        with self._lock:
            if len(self._spans) == self._capacity:
                self._dropped += 1
            self._spans.append(s)

    # -- clock anchoring ---------------------------------------------------
    def anchor(self) -> Dict[str, float]:
        """The wall/perf anchor pair that makes this process's span
        timestamps comparable across processes. Span ``start_us`` is
        ``perf_counter`` from the tracer's private epoch, a monotonic
        clock with a per-process zero; ``wall_epoch`` is the wall time
        at span ts=0, from one adjacent (time.time, perf_counter) pair.
        Every snapshot and dump embeds it (``export.collect_snapshot``),
        and a distributed node gathers every process's at start
        (``shuffle/distributed.gather_clock_anchors``), so
        ``export.merge_timeline`` aligns the processes' spans."""
        perf = time.perf_counter()
        wall = time.time()
        return {
            "wall": wall,                       # the sample pair itself
            "perf": perf,
            "perf_epoch": self._epoch,          # span ts=0 in perf time
            "wall_epoch": wall - (perf - self._epoch),  # span ts=0, wall
            "pid": float(os.getpid()),
        }

    # -- inspection -------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        return [s for s in out if s.name == name] if name else out

    def spans_ending_after(self, t_us: float) -> List[Span]:
        """Spans whose END falls at/after ``t_us`` (tracer-epoch µs),
        oldest first. The ring appends in end order (a span records at
        ``__exit__``), so the reversed walk stops at the first span that
        ended earlier."""
        out: List[Span] = []
        with self._lock:
            for s in reversed(self._spans):
                if s.start_us + s.dur_us < t_us:
                    break
                out.append(s)
        out.reverse()
        return out

    def publish_dropped(self, metrics) -> int:
        """Publish ring drops into ``metrics`` as the
        ``trace.spans.dropped`` counter, watermark-delta style: each call
        adds only the drops since the last (the exchange settlement
        calls it). Returns the delta."""
        with self._lock:
            delta = self._dropped - self._published_dropped
            self._published_dropped = self._dropped
        if delta > 0:
            from sparkucx_tpu_torch.utils.metrics import C_TRACE_DROPPED
            metrics.inc(C_TRACE_DROPPED, delta)
        return delta

    @property
    def dropped(self) -> int:
        # under the lock, so the count agrees with the ring it pairs with
        with self._lock:
            return self._dropped

    def resize(self, capacity: int) -> None:
        """Resize the span ring, keeping the newest buffered spans that
        fit and the drop count; spans a shrink discards count as
        dropped. One mutation under the lock."""
        with self._lock:
            if capacity == self._capacity:
                return
            discarded = max(0, len(self._spans) - capacity)
            self._dropped += discarded
            self._capacity = capacity
            self._spans = deque(self._spans, maxlen=capacity)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name ``{count, total_ms, mean_ms, p50_ms, p99_ms, max_ms}``
        over the buffered spans."""
        groups: Dict[str, List[float]] = defaultdict(list)
        for s in self.spans():
            groups[s.name].append(s.dur_ms)
        out = {}
        for name, ds in groups.items():
            ds.sort()
            out[name] = {
                "count": float(len(ds)),
                "total_ms": sum(ds),
                "mean_ms": sum(ds) / len(ds),
                "p50_ms": ds[len(ds) // 2],
                "p99_ms": ds[min(len(ds) - 1, (len(ds) * 99) // 100)],
                "max_ms": ds[-1],
            }
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0
            self._published_dropped = 0

    # -- export -----------------------------------------------------------
    def chrome_events(self) -> List[Dict[str, Any]]:
        """The span buffer as Chrome trace-event dicts (the 'X' events of
        a ``traceEvents`` list): the file export, the snapshot and the
        flight recorder's postmortem share it. Attrs that are not JSON
        primitives are passed through :func:`_jsonable`."""
        out: List[Dict[str, Any]] = []
        prim = (str, int, float, bool)
        for s in self.spans():
            attrs = s.attrs
            if attrs and any(type(v) not in prim and v is not None
                             for v in attrs.values()):
                attrs = {k: _jsonable(v) for k, v in attrs.items()}
            else:
                attrs = dict(attrs)    # events must not alias the span
            out.append({
                "name": s.name, "ph": "X", "ts": s.start_us,
                "dur": s.dur_us, "pid": 0, "tid": s.tid, "args": attrs})
        return out

    def export_chrome_trace(self, path: str) -> int:
        """Write the span buffer as a Chrome trace-event JSON file, loadable
        in Perfetto / chrome://tracing. Returns the number of events."""
        events = self.chrome_events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        atomic_write_text(path, json.dumps(doc))
        dropped = self.dropped
        if dropped:
            log.warning("trace export dropped %d spans (capacity %d)",
                        dropped, self._capacity)
        return len(events)

    # -- device traces (torch.profiler) ------------------------------------
    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Capture a ``torch.profiler`` trace around a region and write
        it as a Chrome trace, ``device_trace_<pid>_<n>.json`` in
        ``logdir`` (its path is :attr:`device_trace_path` afterwards).
        The capture records CPU activity, and CUDA activity when a card
        is present (the kernels with their host launches); host spans
        recorded inside also appear as ``record_function`` ranges when
        ``annotate_device`` is set. Where the profiler cannot start, it
        logs and records host spans only (:attr:`device_trace_path`
        stays None)."""
        import torch
        prof = None
        self.device_trace_path = None
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except Exception as e:
            log.warning("device trace unavailable (%s); host spans only", e)
            prof = None
        try:
            yield self
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                self._device_traces += 1
                path = os.path.join(
                    logdir, f"device_trace_{os.getpid()}_"
                            f"{self._device_traces}.json")
                prof.export_chrome_trace(path)
                self.device_trace_path = path


def _jsonable(v):
    if v is None or type(v) in (str, int, float, bool):
        return v
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


GLOBAL_TRACER = Tracer(enabled=False)


def configure_from_conf(conf) -> Tracer:
    """Wire the process-global tracer from conf keys (every node does
    at start, as the JAX package's does):

    ``spark.shuffle.tpu.trace.enabled``   master switch (default off)
    ``spark.shuffle.tpu.trace.capacity``  span ring size (default 65536)
    ``spark.shuffle.tpu.trace.device``    open a ``record_function``
                                          range around every span
    """
    GLOBAL_TRACER.enabled = conf.trace_enabled
    GLOBAL_TRACER.annotate_device = conf.trace_device
    GLOBAL_TRACER.resize(conf.trace_capacity)
    return GLOBAL_TRACER
