"""Exchange anatomy: phase-attributed time accounting with a
conservation audit (the JAX package's ``utils/anatomy.py``).

The tracer (``utils/trace.py``) records what ran; this module answers
where the exchange wall went, by folding the spans of one exchange (keyed
by ``format_trace_id``) into a phase ledger:

    plan / compile / pack / admission_wait / agree / barrier_wait /
    transfer.ici / transfer.dcn / merge / sink / spill / verify

with a conservation audit: the attributed phase intervals are swept into
a non-overlapping cover of the exchange wall span, and whatever they do
not cover is reported as ``dark_time`` (an instrumentation hole or a
host stall). The phase milliseconds plus the dark milliseconds equal the
wall exactly, by construction. The port compiles nothing per shape, so
its ledgers never hold ``compile`` (the name stays in the taxonomy: a
document from the JAX package folds the same way).

Attribution has two matching modes, by span site:

* spans that carry a ``trace`` attr (the manager's submit, barrier,
  plan, pack and dispatch spans, the tier spans, the admission and
  full-verify spans, the settle span) match the ledger's trace id
  exactly;
* spans whose sites cannot carry one (the completion wait
  ``shuffle.exchange.wait``, ``shuffle.result``, ``shuffle.fetch``,
  ``shuffle.merge``, ``shuffle.spill``, the allgather barrier, the
  agreement round, the traceless retry dispatch) attribute by interval
  containment inside the exchange wall. Containment is exact on a serial
  read path; under concurrency an overlapping exchange's untagged span
  can co-attribute (the audit still conserves: the sweep never counts a
  wall instant twice).

Where phases overlap, the sweep gives each wall instant to the
highest-priority covering phase: transfers beat the precise waits, which
beat host work, and the submit envelope (``plan``) comes last.

On the port, the completion wait of a single-shot read
(``shuffle.exchange.wait``: the host blocks on the device's event) is
``transfer.ici``: one device's segment move and everything queued before
it on the stream.

Consumed by ``ExchangeReport.phases`` (the manager's settlement), the
``shuffle.phase.ms{phase=...}`` counters (history frames, the
``phase_regression`` doctor rule), the ``dark_time`` doctor rule and the
Perfetto child tracks of ``export.merge_timeline(anatomy=True)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# The canonical taxonomy, ledger-table order. dark_time is NOT a phase:
# it is the audit's residual, reported beside these.
PHASES: Tuple[str, ...] = (
    "plan", "compile", "pack", "admission_wait", "agree", "barrier_wait",
    "transfer.ici", "transfer.dcn", "merge", "sink", "spill", "verify")

DARK = "dark_time"

# Overlap arbitration, highest priority first: fabric transfers beat
# everything (a wall instant where the wire is moving bytes is a
# transfer instant no matter what the host overlapped on it), then the
# PRECISE wait windows (admit grant-lag, barrier blocking — recorded as
# exact blocking intervals, they must not be stolen by the broad
# pack/dispatch envelopes that contain them), then host compute, and
# the submit envelope (plan) last — it exists to absorb the slivers
# between the precise spans, never to win over one.
_PRIORITY: Dict[str, int] = {p: i for i, p in enumerate((
    "transfer.dcn", "transfer.ici", "merge", "sink", "spill", "verify",
    "admission_wait", "agree", "barrier_wait", "compile", "pack",
    "plan"))}

# The exchange wall span name (recorded at settlement by the manager).
WALL_SPAN = "shuffle.exchange"

# Span-name → phase for names that map unconditionally. Tier-carrying
# names (shuffle.tier, shuffle.exchange.wait) resolve via _span_phase.
SPAN_PHASE: Dict[str, str] = {
    "shuffle.plan": "plan",
    "shuffle.submit": "plan",
    "shuffle.result": "sink",
    "compile.step": "compile",
    "shuffle.hier.build": "compile",
    "shuffle.pack": "pack",
    "shuffle.dispatch": "pack",
    "shuffle.wave": "pack",
    "shuffle.admit.wait": "admission_wait",
    # agree() envelope (shuffle/agreement.py): one decision round's two
    # header/payload gathers. Outranks barrier_wait in the sweep so the
    # shuffle.barrier spans it CONTAINS attribute to the decision, not
    # to generic barrier blocking — phase_regression then watches
    # decision stalls for free.
    "shuffle.agree": "agree",
    "shuffle.barrier": "barrier_wait",
    "shuffle.merge": "merge",
    "shuffle.fetch": "sink",
    "shuffle.settle": "sink",
    "shuffle.spill": "spill",
    "shuffle.verify": "verify",
}

# Span names whose sites cannot carry the trace id (see module doc) —
# these attribute by containment inside the wall; everything else needs
# an exact ``trace`` attr match.
_CONTAINMENT_OK = frozenset((
    "compile.step", "shuffle.barrier", "shuffle.exchange.wait",
    "shuffle.agree",
    "shuffle.fetch", "shuffle.merge", "shuffle.spill",
    "shuffle.hier.build", "shuffle.result",
    # the pending-side redispatch (overflow retry, deferred admission)
    # has no trace id either; the manager's own dispatch spans DO carry
    # one, so containment only ever decides these traceless retries
    "shuffle.dispatch"))


def _span_phase(name: str, attrs: Dict[str, Any]) -> Optional[str]:
    """The phase a span attributes to, or None for unmapped names."""
    if name == "shuffle.tier" or name == "shuffle.exchange.wait":
        tier = str(attrs.get("tier", ""))
        return "transfer.dcn" if "dcn" in tier else "transfer.ici"
    return SPAN_PHASE.get(name)


@dataclass
class Ledger:
    """One exchange's phase-attributed time accounting.

    ``phases_ms`` are the swept (non-overlapping, wall-covering)
    milliseconds per phase; their sum plus ``dark_ms`` equals
    ``wall_ms`` exactly. ``raw_ms`` are the un-swept per-phase span
    sums — they can exceed the wall under overlap and are kept as the
    "how busy was each phase" view next to the "who owned the wall"
    view. ``dark_intervals`` are the uncovered [start, end] pairs in
    milliseconds relative to the wall start — the dark_time rule's
    evidence. ``segments`` is the full swept cover (rel-ms start, end,
    phase) that the Perfetto child-track export renders."""

    trace_id: str
    wall_start_us: float
    wall_end_us: float
    wall_ms: float
    phases_ms: Dict[str, float] = field(default_factory=dict)
    raw_ms: Dict[str, float] = field(default_factory=dict)
    dark_ms: float = 0.0
    dark_intervals: List[List[float]] = field(default_factory=list)
    segments: List[Tuple[float, float, str]] = field(default_factory=list)
    spans_matched: int = 0

    @property
    def attributed(self) -> float:
        """Fraction of the wall covered by named phases (1.0 − dark)."""
        if self.wall_ms <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.dark_ms / self.wall_ms)

    @property
    def dominant_phase(self) -> str:
        """The phase owning the most wall — ``dark_time`` when the hole
        outweighs every named phase (that IS the honest answer)."""
        best, best_ms = DARK, self.dark_ms
        for ph, ms in self.phases_ms.items():
            if ms > best_ms:
                best, best_ms = ph, ms
        return best

    @property
    def dominant_tier(self) -> str:
        """Which fabric tier the transfer time rode (empty when the
        exchange moved no attributed transfer time)."""
        ici = self.phases_ms.get("transfer.ici", 0.0)
        dcn = self.phases_ms.get("transfer.dcn", 0.0)
        if ici <= 0.0 and dcn <= 0.0:
            return ""
        return "dcn" if dcn >= ici else "ici"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "wall_ms": round(self.wall_ms, 3),
            "phases_ms": {k: round(v, 3)
                          for k, v in sorted(self.phases_ms.items())},
            "dark_ms": round(self.dark_ms, 3),
            "dark_intervals": [[round(a, 3), round(b, 3)]
                               for a, b in self.dark_intervals],
            "attributed": round(self.attributed, 4),
            "dominant_phase": self.dominant_phase,
            "dominant_tier": self.dominant_tier,
            "raw_ms": {k: round(v, 3)
                       for k, v in sorted(self.raw_ms.items())},
            "spans_matched": self.spans_matched,
        }


def _sweep(w0: float, w1: float,
           intervals: Sequence[Tuple[str, float, float]],
           ) -> Tuple[List[Tuple[float, float, str]],
                      List[List[float]]]:
    """Boundary sweep: clip ``(phase, s, e)`` intervals to the wall
    [w0, w1], cut the wall at every interval boundary, and give each
    elementary segment to its highest-priority covering phase — or to
    dark when nothing covers it. Returns (segments, dark_intervals),
    segments as (rel_ms_start, rel_ms_end, phase) with adjacent
    same-phase segments merged; everything conserves by construction."""
    clipped = []
    cuts = {w0, w1}
    for ph, s, e in intervals:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((ph, s, e))
        cuts.add(s)
        cuts.add(e)
    bounds = sorted(cuts)
    segments: List[Tuple[float, float, str]] = []
    dark: List[List[float]] = []
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        owner, owner_pri = None, len(_PRIORITY)
        for ph, s, e in clipped:
            if s <= a and e >= b:
                pri = _PRIORITY.get(ph, len(_PRIORITY))
                if pri < owner_pri:
                    owner, owner_pri = ph, pri
        name = owner if owner is not None else DARK
        ra, rb = (a - w0) / 1e3, (b - w0) / 1e3
        if segments and segments[-1][2] == name \
                and abs(segments[-1][1] - ra) < 1e-9:
            segments[-1] = (segments[-1][0], rb, name)
        else:
            segments.append((ra, rb, name))
        if name == DARK:
            if dark and abs(dark[-1][1] - ra) < 1e-9:
                dark[-1][1] = rb
            else:
                dark.append([ra, rb])
    return segments, dark


def _fold(trace_id: str, wall: Tuple[float, float],
          spans: Sequence[Tuple[str, float, float, Dict[str, Any]]],
          ) -> Ledger:
    """The shared fold core over (name, start_us, end_us, attrs) tuples."""
    w0, w1 = wall
    intervals: List[Tuple[str, float, float]] = []
    raw: Dict[str, float] = {}
    matched = 0
    for name, s, e, attrs in spans:
        ph = _span_phase(name, attrs)
        if ph is None:
            continue
        tr = attrs.get("trace")
        if tr is not None:
            if tr != trace_id:
                continue
        elif name not in _CONTAINMENT_OK:
            continue
        elif s < w0 - 0.5 or e > w1 + 0.5:
            continue        # containment candidates must sit inside
        matched += 1
        intervals.append((ph, s, e))
        dur = max(0.0, min(e, w1) - max(s, w0)) / 1e3
        raw[ph] = raw.get(ph, 0.0) + dur
    segments, dark = _sweep(w0, w1, intervals)
    phases_ms: Dict[str, float] = {}
    dark_ms = 0.0
    for a, b, ph in segments:
        if ph == DARK:
            dark_ms += b - a
        else:
            phases_ms[ph] = phases_ms.get(ph, 0.0) + (b - a)
    return Ledger(trace_id=trace_id, wall_start_us=w0, wall_end_us=w1,
                  wall_ms=(w1 - w0) / 1e3, phases_ms=phases_ms,
                  raw_ms=raw, dark_ms=dark_ms, dark_intervals=dark,
                  segments=segments, spans_matched=matched)


# -- folding from chrome-event dicts (dumps, gather_spans, snapshots) ------
def _event_tuples(events: Sequence[Dict[str, Any]]):
    for ev in events:
        if ev.get("ph", "X") != "X":
            continue
        ts = float(ev.get("ts", 0.0))
        yield (ev.get("name", ""), ts, ts + float(ev.get("dur", 0.0)),
               ev.get("args") or {})


def wall_events(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The exchange wall spans in an event list, recording order."""
    return [ev for ev in events
            if ev.get("name") == WALL_SPAN and ev.get("ph", "X") == "X"]


def trace_ids(events: Sequence[Dict[str, Any]]) -> List[str]:
    """Trace ids with a recorded wall span, recording order, deduped."""
    seen: List[str] = []
    for ev in wall_events(events):
        tr = (ev.get("args") or {}).get("trace")
        if tr and tr not in seen:
            seen.append(tr)
    return seen


def fold_events(events: Sequence[Dict[str, Any]],
                trace_id: str) -> Optional[Ledger]:
    """Fold one exchange's ledger out of chrome-trace event dicts (a
    flight dump's ``trace_events``, a gather_spans doc's ``events``).
    None when no wall span for ``trace_id`` is present — an exchange
    that never settled (or fell off the span ring) has no wall to
    conserve against. Replayed exchanges re-record the wall under the
    same trace id; the LAST (successful) wall wins."""
    wall = None
    for ev in wall_events(events):
        if (ev.get("args") or {}).get("trace") == trace_id:
            wall = ev
    if wall is None:
        return None
    w0 = float(wall.get("ts", 0.0))
    w1 = w0 + float(wall.get("dur", 0.0))
    return _fold(trace_id, (w0, w1), list(_event_tuples(events)))


def fold_tracer(tracer, trace_id: str) -> Optional[Ledger]:
    """Fold one exchange's ledger straight off a live tracer ring —
    the settlement-hook path. Cost is bounded by the exchange's own
    span window (``spans_ending_after``), not the ring capacity."""
    wall = None
    for s in reversed(tracer.spans()):
        if s.name == WALL_SPAN and s.attrs.get("trace") == trace_id:
            wall = s
            break
    if wall is None:
        return None
    w0, w1 = wall.start_us, wall.start_us + wall.dur_us
    spans = [(s.name, s.start_us, s.start_us + s.dur_us, s.attrs)
             for s in tracer.spans_ending_after(w0)]
    return _fold(trace_id, (w0, w1), spans)


# -- cluster view: clock-aligned critical path -----------------------------
def critical_path(docs: Sequence[Dict[str, Any]],
                  trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Join per-process span docs (``gather_spans`` output, snapshot or
    flight dumps) into ONE clock-corrected view of an exchange and name
    the critical path: which (process, tier, phase) bounded it. The
    straggler is the process whose wall span ENDS last on the shared
    wall-clock axis (the anchor shift is ``export.merge_timeline``'s);
    its dominant phase is the answer the distributed cell needs — the
    straggler's *phase*, not just the peer.

    ``trace_id=None`` picks the exchange present on the most processes,
    tie-broken by latest aligned end (the most recent cluster-wide
    exchange). Anchor-less docs are rejected (``require_anchor``) and
    duplicate captures of one process dedupe — the merge_timeline
    discipline, inherited wholesale."""
    from sparkucx_tpu_torch.utils.export import (dedupe_process_docs,
                                           freshest_anchor)
    docs = dedupe_process_docs(list(docs))
    if not docs:
        return {"trace_id": None, "process": None, "phase": None,
                "tier": "", "wall_ms": 0.0, "per_process": []}
    # freshest-anchor preference (export.freshest_anchor): align each
    # doc on its newest wall↔perf sample — the boot anchor goes stale
    # as a long-lived process's wall clock is slewed, and a straggler
    # verdict built on stale anchors names the wrong peer
    anch = {id(d): freshest_anchor(d, d.get("source", f"doc[{i}]"))
            for i, d in enumerate(docs)}
    t0 = min(float(a["wall_epoch"]) for a in anch.values())

    def _events(d):
        return d.get("trace_events") or d.get("events") or []

    if trace_id is None:
        counts: Dict[str, List[float]] = {}
        for d in docs:
            shift = (float(anch[id(d)]["wall_epoch"]) - t0) * 1e6
            for ev in wall_events(_events(d)):
                tr = (ev.get("args") or {}).get("trace")
                if not tr:
                    continue
                end = float(ev.get("ts", 0.0)) \
                    + float(ev.get("dur", 0.0)) + shift
                counts.setdefault(tr, []).append(end)
        if not counts:
            return {"trace_id": None, "process": None, "phase": None,
                    "tier": "", "wall_ms": 0.0, "per_process": []}
        trace_id = max(counts,
                       key=lambda tr: (len(counts[tr]), max(counts[tr])))

    per_process: List[Dict[str, Any]] = []
    straggler = None
    for d in docs:
        shift = (float(anch[id(d)]["wall_epoch"]) - t0) * 1e6
        led = fold_events(_events(d), trace_id)
        if led is None:
            continue
        pid = d.get("process_id")
        if pid is None:
            pid = int(d.get("pid", len(per_process)))
        row = {"process": pid,
               "aligned_end_us": led.wall_end_us + shift,
               "aligned_start_us": led.wall_start_us + shift,
               "wall_ms": round(led.wall_ms, 3),
               "phase": led.dominant_phase,
               "tier": led.dominant_tier,
               "attributed": round(led.attributed, 4),
               "ledger": led.to_dict()}
        per_process.append(row)
        if straggler is None \
                or row["aligned_end_us"] > straggler["aligned_end_us"]:
            straggler = row
    per_process.sort(key=lambda r: r["aligned_end_us"])
    if straggler is None:
        return {"trace_id": trace_id, "process": None, "phase": None,
                "tier": "", "wall_ms": 0.0, "per_process": []}
    first_start = min(r["aligned_start_us"] for r in per_process)
    return {
        "trace_id": trace_id,
        "process": straggler["process"],
        "phase": straggler["phase"],
        "tier": straggler["tier"],
        "wall_ms": round(
            (straggler["aligned_end_us"] - first_start) / 1e3, 3),
        "straggler_lag_ms": round(
            (straggler["aligned_end_us"]
             - min(r["aligned_end_us"] for r in per_process)) / 1e3, 3),
        "per_process": per_process,
    }


def report_from_docs(docs: Sequence[Dict[str, Any]],
                     trace_id: Optional[str] = None,
                     max_ledgers: int = 8) -> Dict[str, Any]:
    """The anatomy document (the JAX package's CLI and ``/anatomy`` route
    serve it): per-exchange ledgers (most recent last, bounded) + the cluster
    critical path when the docs span processes. Single-doc input skips
    the anchor requirement for the ledger list (a ledger is clock-local)
    but the critical path always inherits merge_timeline's rules."""
    docs = list(docs)
    all_events: List[Dict[str, Any]] = []
    for d in docs:
        all_events.extend(d.get("trace_events") or d.get("events") or [])
    ids = trace_ids(all_events)
    if trace_id is not None:
        ids = [t for t in ids if t == trace_id]
    ledgers = []
    for tr in ids[-max_ledgers:]:
        led = fold_events(all_events, tr)
        if led is not None:
            ledgers.append(led.to_dict())
    out: Dict[str, Any] = {"ledgers": ledgers,
                           "exchanges_seen": len(ids)}
    try:
        out["critical_path"] = critical_path(docs, trace_id=trace_id)
    except ValueError:
        # anchor-less single-process input: ledgers still render, the
        # cluster view honestly reports why it cannot
        out["critical_path"] = {"trace_id": None, "process": None,
                                "phase": None, "tier": "",
                                "error": "input lacks clock anchors"}
    return out


# -- rendering -------------------------------------------------------------
def render_ledger(led: Dict[str, Any]) -> str:
    """One exchange's ledger as an operator table (dict shape from
    ``Ledger.to_dict``: dumps and live folds alike)."""
    wall = led.get("wall_ms", 0.0) or 0.0
    rows = []
    phases = dict(led.get("phases_ms", {}))
    for ph in PHASES:
        if ph in phases:
            rows.append((ph, phases.pop(ph)))
    rows.extend(sorted(phases.items()))          # future/unknown phases
    rows.append((DARK, led.get("dark_ms", 0.0)))
    lines = [f"exchange {led.get('trace_id')}  wall {wall:.2f} ms  "
             f"attributed {100.0 * led.get('attributed', 0.0):.1f}%"]
    for ph, ms in rows:
        if ms <= 0.0:
            continue
        share = 100.0 * ms / wall if wall > 0 else 0.0
        bar = "#" * max(1, int(round(share / 4)))
        lines.append(f"  {ph:<14} {ms:>10.2f} ms  {share:>5.1f}%  {bar}")
    dark_iv = led.get("dark_intervals") or []
    if dark_iv:
        ivs = ", ".join(f"[{a:.2f}..{b:.2f}]" for a, b in dark_iv[:4])
        more = f" (+{len(dark_iv) - 4} more)" if len(dark_iv) > 4 else ""
        lines.append(f"  dark intervals (ms into wall): {ivs}{more}")
    return "\n".join(lines) + "\n"


def render_critical_path(cp: Dict[str, Any]) -> str:
    if cp.get("process") is None:
        why = cp.get("error", "no exchange wall spans in input")
        return f"critical path: unavailable — {why}\n"
    lines = [f"critical path: exchange {cp['trace_id']} bounded by "
             f"process {cp['process']} in phase {cp['phase']}"
             + (f" (tier {cp['tier']})" if cp.get("tier") else "")
             + f", cluster wall {cp.get('wall_ms', 0.0):.2f} ms"
             + (f", straggler lag {cp['straggler_lag_ms']:.2f} ms"
                if cp.get("straggler_lag_ms") is not None else "")]
    for row in cp.get("per_process", []):
        lines.append(
            f"  process {row['process']:>3}  wall {row['wall_ms']:>9.2f}"
            f" ms  dominant {row['phase']:<14} "
            f"attributed {100.0 * row['attributed']:.1f}%")
    return "\n".join(lines) + "\n"


# -- Perfetto child tracks -------------------------------------------------
def phase_track_events(events: Sequence[Dict[str, Any]],
                       pid: int = 0) -> List[Dict[str, Any]]:
    """Render each exchange's swept phase cover as a CHILD TRACK under
    its process: one synthetic thread per exchange (named
    ``anatomy <trace_id>`` via 'M' thread_name metadata) carrying the
    non-overlapping phase segments — including the dark ones, so the
    hole is visible as a labeled gap-filler right in Perfetto."""
    out: List[Dict[str, Any]] = []
    base_tid = 0x5AC0                      # clear of real thread idents
    for i, tr in enumerate(trace_ids(events)):
        led = fold_events(events, tr)
        if led is None:
            continue
        tid = base_tid + i
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": f"anatomy {tr}"}})
        for a, b, ph in led.segments:
            out.append({
                "name": ph, "ph": "X",
                "ts": led.wall_start_us + a * 1e3,
                "dur": (b - a) * 1e3, "pid": pid, "tid": tid,
                "args": {"trace": tr, "anatomy": True}})
    return out
