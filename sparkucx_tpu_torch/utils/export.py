"""Metric exporters — Prometheus text exposition, JSON snapshots and the
multi-process timeline merge (the JAX package's
``sparkucx_tpu/utils/export.py``).

One snapshot document (counters, gauges, histograms, the span summary,
the exchange reports; :func:`collect_snapshot`) renders into:

* Prometheus text exposition (:func:`render_prometheus`, format 0.0.4):
  counters, full ``_bucket{le=...}`` histogram series with companion
  ``_p50`` / ``_p99`` / ``_max`` gauges, gauges, and the span summary;
  :func:`validate_exposition` is its strict line-grammar check;
* a JSON snapshot (:func:`render_json`, :func:`write_snapshot`), what
  :class:`PeriodicDumper` writes.

Everything renders from the snapshot dict, not live objects, so a dump
written by a dead process renders as a live scrape would.
:func:`dedupe_process_docs` collapses several captures of one process,
and :func:`merge_timeline` merges per-process span captures into one
Chrome trace with a track per process, aligned through each capture's
clock anchor.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Union

from sparkucx_tpu_torch.utils.atomicio import atomic_write_text
from sparkucx_tpu_torch.utils.logging import get_logger
from sparkucx_tpu_torch.utils.metrics import (Histogram, Metrics,
                                              escape_label_value,
                                              parse_labeled)
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER, Tracer

log = get_logger("export")

PROM_PREFIX = "sparkucx_tpu_"
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name: str) -> str:
    """Metric name -> Prometheus-legal series name (illegal characters
    become underscores, namespaced under ``sparkucx_tpu_``, the JAX
    package's prefix, so one scrape config serves both packages)."""
    return PROM_PREFIX + _BAD_CHARS.sub("_", name)


def prom_series(identity: str) -> str:
    """Metric identity (possibly carrying a ``labeled()`` block, e.g.
    ``devmon.hbm.in_use{device="0"}``) -> exposition series reference:
    sanitized base name + sanitized label keys + escaped label values.
    An identity whose label block does not parse as canonical
    ``k="v"`` pairs is treated as a plain (hostile) name and sanitized
    wholesale — junk braces become underscores instead of exposition
    syntax."""
    base, labels = parse_labeled(identity)
    if labels is None:
        return prom_name(identity)
    inner = ",".join(
        f'{_BAD_CHARS.sub("_", k)}="{escape_label_value(v)}"'
        for k, v in labels.items())
    return f"{prom_name(base)}{{{inner}}}"


def prom_family(identity: str) -> str:
    """The family name an identity's samples belong to (label block
    stripped) — what the ``# TYPE`` line names."""
    base, labels = parse_labeled(identity)
    return prom_name(base if labels is not None else identity)


def _fmt(v: float) -> str:
    """Float -> exposition literal. Prometheus accepts 'Inf'/'+Inf';
    integral values render without a trailing .0 for stable goldens."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def merge_histogram_snapshots(into: Dict[str, Dict],
                              new: Dict[str, Dict]) -> None:
    """Fold ``new``'s histogram snapshots into ``into`` in place. Name
    collisions merge (exact: one fixed bucket ladder) rather than the
    last writer winning: every registry pre-creates the well-known
    histograms, so an empty one must not clobber a populated one."""
    for name, snap in new.items():
        prev = into.get(name)
        if prev is None or not prev.get("count"):
            into[name] = snap
        elif snap.get("count"):
            into[name] = Histogram.from_snapshot(prev, name).merge(
                Histogram.from_snapshot(snap, name)).snapshot()


def collect_snapshot(metrics: Union[Metrics, Iterable[Metrics]],
                     tracer: Optional[Tracer] = None,
                     reports: Optional[List[Dict]] = None,
                     extra: Optional[Dict] = None,
                     populated_only: bool = False) -> Dict:
    """Build the canonical snapshot document.

    ``metrics`` may be one registry or several: counters and gauges
    merge with later registries winning name collisions, histograms
    merge exactly (:func:`merge_histogram_snapshots`).
    ``populated_only`` drops zero-count histograms (the history plane's
    lean collect); scrapes and dumps keep the full surface."""
    if isinstance(metrics, Metrics):
        metrics = [metrics]
    counters: Dict[str, float] = {}
    histograms: Dict[str, Dict] = {}
    gauges: Dict[str, float] = {}
    for m in metrics:
        counters.update(m.snapshot())
        merge_histogram_snapshots(
            histograms, m.histograms(populated_only=populated_only))
        # gauges are point-in-time: later registries win collisions,
        # same one-owning-registry rule as counters
        gauges.update(m.gauges())
    doc = {
        "ts": time.time(),
        "pid": os.getpid(),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }
    # clock anchor: doc["ts"] is wall time while spans are perf_counter
    # offsets; the tracer owns the span epoch, so the anchor comes from it
    anchor_src = tracer if tracer is not None else GLOBAL_TRACER
    doc["anchor"] = anchor_src.anchor()
    if tracer is not None:
        doc["spans"] = tracer.summary()
        doc["dropped_spans"] = tracer.dropped
        # raw chrome events ride along so a dump directory is a timeline
        # source (merge_timeline); empty when the tracer is off
        doc["trace_events"] = tracer.chrome_events()
    if reports is not None:
        doc["exchange_reports"] = reports
    if extra:
        doc.update(extra)
    return doc


def require_anchor(doc: Dict, source: str = "dump") -> Dict:
    """The wall/perf anchor of a snapshot or dump doc, or a loud error:
    an anchor-less doc cannot be placed on a shared timeline."""
    a = doc.get("anchor")
    if not isinstance(a, dict) or "wall_epoch" not in a:
        raise ValueError(
            f"{source} carries no clock anchor (no 'anchor.wall_epoch' "
            f"key): written by a pre-anchor version? Re-capture the dump "
            f"— span timestamps cannot be aligned without the wall<->perf "
            f"anchor pair")
    return a


def freshest_anchor(doc: Dict, source: str = "dump") -> Dict:
    """The doc's freshest wall/perf anchor (largest ``wall``) among its
    primary ``anchor`` and its ``anchors`` history (the node's boot
    anchor rides there, ``Node.telemetry_snapshot``): the wall clock
    drifts against ``perf_counter`` over a long life, so alignment uses
    the sample closest to the spans. No valid sample anywhere fails as
    :func:`require_anchor` does."""
    cands = []
    a = doc.get("anchor")
    if isinstance(a, dict) and "wall_epoch" in a:
        cands.append(a)
    for h in (doc.get("anchors") or []):
        if isinstance(h, dict) and "wall_epoch" in h:
            cands.append(h)
    if not cands:
        return require_anchor(doc, source)   # raises with the message
    return max(cands, key=lambda c: float(c.get("wall", 0.0)))


def dedupe_process_docs(docs: Iterable[Dict]) -> List[Dict]:
    """Collapse several captures of the same process into one doc. A
    dump directory holds a process's rolling metrics snapshot and its
    flight postmortems, each embedding the same cumulative registries
    and span ring; summing them would count everything twice. Processes
    are keyed by (process_id, pid); within a key a registry-bearing doc
    beats a frame-only history replay, then the latest ``ts`` wins (tie:
    most trace events), and the group's exchange reports (by trace id),
    history frames and decision records (by their monotonic ``n``)
    union into it."""
    groups: Dict = {}
    order: List = []
    for i, doc in enumerate(docs):
        key = (doc.get("process_id"), doc.get("pid"))
        if key == (None, None):
            key = ("__unkeyed__", i)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(doc)

    def _reports_in(doc):
        reps = doc.get("exchange_reports")
        if reps is None:
            reps = (doc.get("contexts") or {}).get("exchange_reports")
        return [r for r in (reps or []) if isinstance(r, dict)]

    out: List[Dict] = []
    for key in order:
        group = groups[key]
        if len(group) == 1:
            out.append(group[0])
            continue
        best = max(group, key=lambda d: (
            bool(d.get("counters") or d.get("histograms")),
            d.get("ts", 0.0),
            len(d.get("trace_events", d.get("events", [])))))
        merged = dict(best)
        seen, reports = set(), []
        for doc in group:
            for r in _reports_in(doc):
                rk = r.get("trace_id") or json.dumps(
                    r, sort_keys=True, default=repr)
                if rk not in seen:
                    seen.add(rk)
                    reports.append(r)
        if reports:
            # the flat key shadows any contexts.exchange_reports copy
            merged["exchange_reports"] = reports
        # history frames union across the group the same way: a flight
        # postmortem (usually the newest capture) does not embed the
        # window ring
        seen_f, frames = set(), []
        for doc in group:
            for f in (doc.get("history_frames") or []):
                if not isinstance(f, dict):
                    continue
                fk = (f.get("pid"), f.get("seq"), f.get("t_end"))
                if fk not in seen_f:
                    seen_f.add(fk)
                    frames.append(f)
        if frames:
            frames.sort(key=lambda f: f.get("t_end", 0.0))
            merged["history_frames"] = frames
            for doc in group:
                if doc.get("slo_objectives"):
                    merged.setdefault("slo_objectives",
                                      doc["slo_objectives"])
                if doc.get("slo_policy"):
                    merged.setdefault("slo_policy", doc["slo_policy"])
        # decision records union the same way: the decisions JSONL
        # (decisions_to_doc) outlives the snapshot's bounded tail, and
        # records carry a per-process monotonic ``n``, so dedupe is exact
        seen_n, decs = set(), []
        for doc in group:
            for r in (doc.get("decisions") or []):
                if not isinstance(r, dict) or r.get("n") in seen_n:
                    continue
                seen_n.add(r.get("n"))
                decs.append(r)
        if decs:
            decs.sort(key=lambda r: r.get("n", 0))
            merged["decisions"] = decs
        out.append(merged)
    return out


def merge_timeline(docs: Iterable[Dict], anatomy: bool = False) -> Dict:
    """Merge per-process span captures into ONE Chrome/Perfetto trace doc
    with a track (pid) per process, clock-aligned via each capture's
    wall↔perf anchor.

    Each doc needs an ``anchor`` (see :func:`require_anchor`) and chrome
    events under ``trace_events`` (snapshots, flight postmortems) or
    ``events`` (``manager.gather_spans()`` blobs). Event timestamps are
    per-process perf offsets; the merge rebases them onto a shared
    wall-clock zero (the earliest span epoch across processes), so a
    fetch that waited on a straggler peer visibly overlaps that peer's
    late dispatch in the merged view.

    ``anatomy=True`` (the JAX package's phase tracks from its exchange
    anatomy) raises ``NotImplementedError``: the anatomy fold is not
    ported yet (ROADMAP item 6b)."""
    if anatomy:
        raise NotImplementedError(
            "merge_timeline(anatomy=True) needs the exchange anatomy "
            "(utils/anatomy), which is not ported yet (ROADMAP item 6b)")
    docs = dedupe_process_docs(docs)
    if not docs:
        raise ValueError("merge_timeline: no input docs")
    # the freshest anchor of each capture: a long-lived process's boot
    # anchor is stale against its latest re-anchor
    anchors = [freshest_anchor(d, f"timeline input {i}")
               for i, d in enumerate(docs)]
    t0 = min(a["wall_epoch"] for a in anchors)
    # Track identity: the process index when the captures are from
    # distinct cluster members, else the OS pid (N single-process dumps
    # all claim process_id 0 and must not collapse onto one track),
    # else the input index.
    procs = [d.get("process_id") for d in docs]
    ospids = [d.get("pid") for d in docs]
    if None not in procs and len(set(procs)) == len(docs):
        tracks = [(int(p), f"process {int(p)}") for p in procs]
    elif None not in ospids and len(set(ospids)) == len(docs):
        tracks = [(int(o), f"pid {int(o)}") for o in ospids]
    else:
        tracks = [(i, f"track {i}") for i in range(len(docs))]
    events: List[Dict] = []
    for (doc, a, (pid, label)) in zip(docs, anchors, tracks):
        shift_us = (a["wall_epoch"] - t0) * 1e6
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        shifted: List[Dict] = []
        for ev in doc.get("trace_events", doc.get("events", [])):
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            shifted.append(ev)
        events.extend(shifted)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"processes": len(docs),
                         "wall_epoch_zero": t0}}


def render_json(doc: Dict, indent: int = 1) -> str:
    return json.dumps(doc, indent=indent, sort_keys=True, default=repr)


def render_prometheus(doc: Dict) -> str:
    """Snapshot document -> Prometheus text exposition (format 0.0.4).

    Counters export as ``counter``; histograms as a full cumulative
    ``_bucket`` series + ``_sum``/``_count`` plus ``_p50``/``_p99``/
    ``_max`` companion gauges (quantiles are not part of the histogram
    exposition type, and forcing a dashboard to compute
    histogram_quantile() before a human can read p99 defeats the
    point of carrying it live)."""
    lines: List[str] = []
    # counters: first-class label support (per-tenant payload/wire/admit
    # counters carry a ``labeled()`` block). Grouped by FAMILY like the
    # gauges below — the exposition format wants ONE TYPE line per
    # family with all of its series adjacent, and two tenants of one
    # family must not each emit their own TYPE line.
    counters = doc.get("counters", {})
    cfamilies: Dict[str, List[str]] = {}
    for name in counters:
        cfamilies.setdefault(prom_family(name), []).append(name)
    for fam in sorted(cfamilies):
        lines.append(f"# TYPE {fam} counter")
        for name in sorted(cfamilies[fam]):
            lines.append(f"{prom_series(name)} {_fmt(counters[name])}")
    # gauges: set-semantics values (devmon HBM watermarks, pool in-use)
    # with first-class label support. Grouped by FAMILY, not identity
    # sort order: the exposition format requires one TYPE line per
    # family with all of its series adjacent, and a labeled identity
    # ("{" sorts above alphanumerics) could otherwise interleave with a
    # longer-named sibling family.
    gauges = doc.get("gauges", {})
    families: Dict[str, List[str]] = {}
    for name in gauges:
        families.setdefault(prom_family(name), []).append(name)
    for fam in sorted(families):
        lines.append(f"# TYPE {fam} gauge")
        for name in sorted(families[fam]):
            lines.append(f"{prom_series(name)} {_fmt(gauges[name])}")
    # histograms: labeled identities (shuffle.read.wait_ms{tenant=...})
    # merge their label block into every sample of the series — the
    # ``le`` bound joins the identity's own labels — and share ONE
    # family TYPE line with their unlabeled sibling.
    hists = doc.get("histograms", {})
    hfamilies: Dict[str, List[str]] = {}
    for name in hists:
        hfamilies.setdefault(prom_family(name), []).append(name)
    for fam in sorted(hfamilies):
        lines.append(f"# TYPE {fam} histogram")
        qlines: List[str] = []
        for name in sorted(hfamilies[fam]):
            h = hists[name]
            base, labels = parse_labeled(name)
            inner = "".join(
                f',{_BAD_CHARS.sub("_", k)}="{escape_label_value(v)}"'
                for k, v in (labels or {}).items())
            for le, cum in h.get("buckets", []):
                lines.append(
                    f'{fam}_bucket{{le="{_fmt(float(le))}"{inner}}} '
                    f'{int(cum)}')
            tail = f"{{{inner[1:]}}}" if inner else ""
            lines.append(f"{fam}_sum{tail} {_fmt(h.get('sum', 0.0))}")
            lines.append(f"{fam}_count{tail} {int(h.get('count', 0))}")
            for q in ("p50", "p99", "max"):
                qlines.append((f"{fam}_{q}",
                               f"{fam}_{q}{tail} {_fmt(h.get(q, 0.0))}"))
        # companion-gauge families emit GROUPED: one TYPE line with all
        # of that family's series adjacent — a labeled histogram beside
        # its unlabeled sibling would otherwise interleave f_p50 /
        # f_p99 / f_max blocks, which the exposition format forbids
        # (caught by export.validate_exposition's adjacency check)
        qfams: Dict[str, List[str]] = {}
        for tname, line in qlines:
            qfams.setdefault(tname, []).append(line)
        for tname in qfams:
            lines.append(f"# TYPE {tname} gauge")
            lines.extend(qfams[tname])
    # span summary rides as gauges so a scrape sees phase timings without
    # needing the chrome trace (one family per aggregate field)
    for name in sorted(doc.get("spans", {})):
        agg = doc["spans"][name]
        n = prom_name("span." + name)
        for field in ("count", "mean_ms", "p50_ms", "p99_ms", "max_ms"):
            if field in agg:
                lines.append(f"# TYPE {n}_{field} gauge")
                lines.append(f"{n}_{field} {_fmt(agg[field])}")
    return "\n".join(lines) + "\n"


_EXPO_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_EXPO_LABELS = r'\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*"' \
               r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*")*\}'
_EXPO_VALUE = r"(?:[+-]?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)|\+Inf|-Inf|NaN)"
_EXPO_SAMPLE = re.compile(
    f"^({_EXPO_NAME})({_EXPO_LABELS})? {_EXPO_VALUE}$")
_EXPO_TYPE = re.compile(
    f"^# TYPE ({_EXPO_NAME}) (counter|gauge|histogram|summary|untyped)$")


def validate_exposition(text: str) -> None:
    """Strict line-grammar check of a Prometheus text exposition
    (format 0.0.4) — the contract scrapers parse, pinned so a future
    exporter edit cannot silently break them. Raises ValueError naming
    the first offending line. Checks:

    * every line is a ``# TYPE`` declaration or a sample matching the
      ``name{label="escaped value",...} value`` grammar (escapes limited
      to ``\\\\``, ``\\"``, ``\\n`` — the legal label-value set);
    * every sample's family was TYPE-declared BEFORE it, exactly once,
      and all of a family's samples are adjacent to their declaration
      (the exposition adjacency rule);
    * histogram families carry ``_bucket``/``_sum``/``_count`` series,
      bucket ``le`` bounds strictly increase per label set, cumulative
      counts never decrease, and the ``+Inf`` bucket equals ``_count``.
    """
    declared: Dict[str, str] = {}
    current: Optional[str] = None
    hist_state: Dict = {}

    def _hist_family_of(name: str) -> Optional[str]:
        for suffix in ("_bucket", "_sum", "_count"):
            fam = name[:-len(suffix)] if name.endswith(suffix) else None
            if fam and declared.get(fam) == "histogram":
                return fam
        return None

    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        m = _EXPO_TYPE.match(line)
        if m:
            fam = m.group(1)
            if fam in declared:
                raise ValueError(
                    f"line {i}: duplicate # TYPE for family {fam!r}")
            declared[fam] = m.group(2)
            current = fam
            continue
        if line.startswith("#"):
            raise ValueError(
                f"line {i}: only # TYPE comments are emitted, got "
                f"{line!r}")
        m = _EXPO_SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {i}: not a legal sample: {line!r}")
        name, labels = m.group(1), m.group(2) or ""
        fam = name if name in declared else _hist_family_of(name)
        if fam is None:
            raise ValueError(
                f"line {i}: sample {name!r} has no preceding # TYPE")
        if fam != current:
            raise ValueError(
                f"line {i}: sample {name!r} is not adjacent to its "
                f"family {fam!r} TYPE block (current block: "
                f"{current!r})")
        if declared[fam] == "histogram":
            st = hist_state.setdefault(fam, {"counts": {}, "le": {}})
            value = float(line.rsplit(" ", 1)[1]
                          .replace("+Inf", "inf").replace("-Inf", "-inf")
                          .replace("NaN", "nan"))

            def _label_key(drop_le: bool) -> str:
                pairs = re.findall(
                    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\.)*)"',
                    labels)
                return ",".join(f'{k}="{v}"' for k, v in sorted(pairs)
                                if not (drop_le and k == "le"))

            if name.endswith("_bucket"):
                lm = re.search(r'le="([^"]*)"', labels)
                if not lm:
                    raise ValueError(
                        f"line {i}: histogram bucket without le label")
                le = float(lm.group(1).replace("+Inf", "inf"))
                key = _label_key(drop_le=True)
                prev = st["le"].get(key)
                if prev is not None:
                    if le <= prev[0]:
                        raise ValueError(
                            f"line {i}: bucket le={le} not increasing "
                            f"(prev {prev[0]})")
                    if value < prev[1]:
                        raise ValueError(
                            f"line {i}: cumulative bucket count "
                            f"decreased ({value} < {prev[1]})")
                st["le"][key] = (le, value)
            elif name.endswith("_count"):
                st["counts"][_label_key(drop_le=False)] = value
    for fam, st in hist_state.items():
        for key, (le, cum) in st["le"].items():
            if le != float("inf"):
                raise ValueError(
                    f"histogram {fam!r}[{key}]: bucket series does not "
                    f"end at +Inf (last le={le})")
            cnt = st["counts"].get(key)
            if cnt is not None and cnt != cum:
                raise ValueError(
                    f"histogram {fam!r}[{key}]: +Inf bucket {cum} != "
                    f"_count {cnt}")


def write_snapshot(doc: Dict, path: str, fsync: bool = True) -> str:
    """Atomic JSON snapshot write (``utils/atomicio``: temp, optional
    fsync, rename), so a scraper never reads a torn file. The rolling
    periodic dump passes ``fsync=False``: it only needs reader
    atomicity."""
    return atomic_write_text(path, render_json(doc), fsync=fsync)


class PeriodicDumper:
    """Background metrics-snapshot writer, keyed by
    ``spark.shuffle.tpu.metrics.dumpDir`` / ``metrics.
    dumpIntervalSecs`` (the service wires it): one rolling file per
    process (``metrics_<pid>.json``, atomic replace). Failures are
    logged once and never raise.

    Its cadence is also the history plane's heartbeat: ``tick_fns``
    (``TelemetryHistory.tick``) run on every beat. ``out_dir=None``
    runs a tick-only dumper (history without a dump dir).
    ``dump_every`` writes the snapshot every Nth beat, when the thread
    beats faster than the dump interval (a history window shorter than
    it)."""

    def __init__(self, collect, out_dir: Optional[str],
                 interval_s: float, tick_fns=(), dump_every: int = 1):
        self._collect = collect
        self._dir = out_dir
        self._interval = max(0.1, float(interval_s))
        self._tick_fns = list(tick_fns)
        self._dump_every = max(1, int(dump_every))
        self._beats = 0
        self._stop = threading.Event()
        self._warned = False
        self._thread = threading.Thread(
            target=self._run, name="sparkucx-metrics-dump", daemon=True)

    @property
    def path(self) -> Optional[str]:
        if self._dir is None:
            return None
        return os.path.join(self._dir, f"metrics_{os.getpid()}.json")

    def start(self) -> "PeriodicDumper":
        self._thread.start()
        return self

    def dump_once(self, force: bool = True) -> Optional[str]:
        """Tick, then write the snapshot (``force=False``, the background
        loop: only every ``dump_every``-th beat)."""
        for fn in self._tick_fns:
            try:
                fn()
            except Exception:
                if not self._warned:
                    self._warned = True
                    log.exception("dump tick %r failed; further "
                                  "failures are silenced", fn)
        if self._dir is None:
            return None
        self._beats += 1
        if not force and self._beats % self._dump_every:
            return None
        try:
            os.makedirs(self._dir, exist_ok=True)
            # rolling dump: reader-atomicity only, no fsync stalls
            return write_snapshot(self._collect(), self.path,
                                  fsync=False)
        except Exception:
            if not self._warned:
                self._warned = True
                log.exception("metrics dump to %s failed; further "
                              "failures are silenced", self._dir)
            return None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.dump_once(force=False)

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        self.dump_once()   # final snapshot so a clean stop leaves state
