"""``python -m sparkucx_tpu_torch`` — the operator CLI (the JAX package's
``python -m sparkucx_tpu``, the same commands, flags, output and exit
codes).

Subcommands:

``keys`` (default)
    Print the conf-key table (``ShuffleConf.describe_keys``): one row per
    key the port reads, with its default and description.

``stats [--input DUMP.json | --live-url URL] [--format prometheus|json]``
    Render a telemetry snapshot: a dump written by the periodic dumper
    (``metrics.dumpDir``) or a flight-recorder postmortem, a running
    node's ``/snapshot`` (``--live-url``: its ``metrics.httpPort``
    server), or, with neither, this process's tracer over an empty
    registry (the declared histograms export with zero counts).

``trace [--input DUMP.json] [--out TRACE.json]``
    The span summary table (count / mean / p50 / p99 / max ms per span
    name) of a dump, and optionally its Chrome trace events written to a
    file Perfetto / chrome://tracing loads.

``timeline [--input DUMP_OR_DIR ...] [--out TIMELINE.json] [--anatomy]``
    Merge per-process span captures into one clock-aligned Perfetto
    timeline with a track per process. Inputs without a clock anchor are
    rejected (so are anchor-less ``stats`` / ``trace`` inputs).

``anatomy [--input DUMP_OR_DIR ... | --live-url URL] [--trace ID]
[--format text|json] [--min-attributed F] [--out TIMELINE.json]``
    Per-exchange phase ledgers (``utils/anatomy.py``) with the
    conservation audit and the cluster critical path. ``--min-attributed
    0.95`` exits 1 when a ledger conserves less than 95% of its wall;
    exit 2 when the input holds no settled exchange.

``doctor [--input DUMP_OR_DIR ... | --live-url URL] [--format text|json]
[--fail-on warn|critical]``
    The rule engine (``utils/doctor.py``) over dumps (directories expand
    to ``metrics_*.json``, ``flight_*.json``, ``history_*.jsonl`` and
    ``decisions_*.jsonl``), a running node, or this process's registries.
    ``--fail-on`` exits 3 when a finding of that grade or worse fired.

``slo [--input DUMP_OR_DIR ... | --live-url URL] [--format text|json]
[--fail-on fast|slow]``
    The SLO verdict (``utils/slo.py``) over retained history windows;
    without an input there is no node in a fresh CLI process, so it exits
    2. ``--fail-on`` exits 3 on a burn of that speed.

``cluster [--peers URL ... | --registry PATH] [--timeout-s F]
[--format text|json] [--fail-on warn|critical] [--trace ID]``
    The out-of-band fleet view (``utils/collector.py``): every peer's
    ``/snapshot`` over plain HTTP with per-peer deadlines, no
    collectives; the fleet table and the cluster doctor's findings. Exit
    2 when no registry is found or no peer answered, 3 past ``--fail-on``
    (default critical).

``decisions [--input DUMP_OR_DIR ... | --peers URL ... | --registry P]
[--format text|json] [--fail-on warn|critical]``
    The decision-plane audit (``shuffle/decisions.py``): every rank's
    agreement ledger joined by ``(epoch, seq)``, the splits, and the
    decision rules' findings. Exit 2 when no ledger record reached the
    audit, 3 past ``--fail-on``.

``workload <name> [--scale S] [--budget-mb N] [--seed K] [--arrow]
[--conf KEY=VALUE ...]``
    Run one registered external-memory pipeline (``workloads.WORKLOADS``:
    terasort, groupby, join) on the card and print its WorkloadReport
    JSON. Exit 2 on an unknown name or a malformed ``--conf``, 4 when the
    oracle fails.

``kernelbench [--reps N] [--rows-log2 K] [--out PATH]``
    The segment-reduce microbench (``ops/microbench.py``): the torch
    twins timed everywhere, the CUDA kernels timed and graded against
    them on the card (skipped with the reason elsewhere). Exit 2 when a
    grade or the build count fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _expand_inputs(paths) -> list:
    """Files stay files; a directory expands to the telemetry dumps the
    periodic dumper and flight recorder write into it. An explicitly
    passed but EMPTY --input (a shell glob that matched nothing) is an
    error — falling back to diagnosing this fresh CLI process would
    print 'healthy' and mask the missing dumps, the worst failure mode
    for a gate."""
    if not paths:
        raise FileNotFoundError(
            "--input was given but resolved to no paths (empty shell "
            "glob?); pass dump files/directories or drop --input for "
            "live mode")
    out = []
    from sparkucx_tpu_torch.shuffle.decisions import decisions_files
    from sparkucx_tpu_torch.utils.history import history_files
    for p in paths:
        if os.path.isdir(p):
            hits = sorted(glob.glob(os.path.join(p, "metrics_*.json"))
                          + glob.glob(os.path.join(p, "flight_*.json"))
                          + history_files(p) + decisions_files(p))
            if not hits:
                raise FileNotFoundError(
                    f"{p}: no metrics_*.json / flight_*.json / "
                    f"history_*.jsonl / decisions_*.jsonl dumps")
            out.extend(hits)
        else:
            out.append(p)
    return out


def _load_history_doc(path: str, strict_anchor: bool = True):
    """A ``history_*.jsonl`` window log as a snapshot-shaped doc
    (``history_frames`` key) the doctor/slo pipelines fold, or None
    when the file holds no parseable frames (empty, or every line torn
    by a mid-append death) — the dumps SITTING BESIDE a bad history
    file must still grade, so the caller skips rather than crashes.
    The frames carry their own clock anchors; anchor-less lines mean a
    pre-anchor writer and are rejected like any other dump."""
    from sparkucx_tpu_torch.utils.export import require_anchor
    from sparkucx_tpu_torch.utils.history import (frames_to_doc,
                                            load_history_file)
    frames = load_history_file(path)
    if not frames:
        print(f"warning: {path}: no parseable history frames — "
              f"skipped", file=sys.stderr)
        return None
    doc = frames_to_doc(frames, source=path)
    if strict_anchor:
        require_anchor(doc, path)
    return doc


def _load_decisions_doc(path: str):
    """A ``decisions_*.jsonl`` ledger as a snapshot-shaped doc
    (``decisions`` key) the doctor's build_view folds per-process. No
    anchor requirement: decision records carry wall-clock stamps, not
    span offsets. None when every line is torn — dumps beside a bad
    ledger must still grade (the _load_history_doc rule)."""
    from sparkucx_tpu_torch.shuffle.decisions import (decisions_to_doc,
                                                load_decisions_file)
    recs = load_decisions_file(path)
    if not recs:
        print(f"warning: {path}: no parseable decision records — "
              f"skipped", file=sys.stderr)
        return None
    return decisions_to_doc(recs, source=path)


def _load_doc(path: str, strict_anchor: bool = True):
    """Load any telemetry input: snapshot/flight JSON, history JSONL,
    or decisions JSONL (None for a frame/record-less log — the caller
    filters), anchor-checked per ``strict_anchor``."""
    if path.endswith(".jsonl"):
        if os.path.basename(path).startswith("decisions_"):
            return _load_decisions_doc(path)
        return _load_history_doc(path, strict_anchor)
    return _load_anchored(path) if strict_anchor else _load(path)


def _load_docs(paths, strict_anchor_for=lambda p: True) -> list:
    """Load many inputs, dropping frame-less history logs; all inputs
    degenerate is an error (a gate diagnosing nothing must say so, not
    print 'healthy' — the _expand_inputs discipline)."""
    docs = [_load_doc(p, strict_anchor=strict_anchor_for(p))
            for p in paths]
    docs = [d for d in docs if d is not None]
    if not docs:
        raise FileNotFoundError(
            "no usable telemetry inputs (every history log was empty "
            "or torn)")
    return docs


def _load_anchored(path: str) -> dict:
    """Load a dump and insist on its clock anchor: span epochs are
    per-process monotonic offsets, so an anchor-less dump can only be
    misaligned — fail loudly instead (satellite: snapshot clock
    anchor)."""
    from sparkucx_tpu_torch.utils.export import require_anchor
    doc = _load(path)
    require_anchor(doc, path)
    return doc


def _live_snapshot() -> dict:
    """This process's snapshot: the process tracer over an empty registry
    (a node's metrics are its own; the CLI reaches a running node through
    ``--live-url``)."""
    from sparkucx_tpu_torch.utils.export import collect_snapshot
    from sparkucx_tpu_torch.utils.metrics import Metrics
    from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
    return collect_snapshot(Metrics(), tracer=GLOBAL_TRACER)


def _fetch_live(url: str) -> dict:
    """Pull a running node's /snapshot (utils/live.py server) — the
    CLI's remote-live mode: ``stats``/``doctor`` against another
    process's scrape endpoint instead of a dump file. The JSON snapshot
    (not /metrics) is fetched so both renderers and the full rule
    engine run on the canonical document."""
    import urllib.request
    target = url.rstrip("/")
    if not target.endswith("/snapshot"):
        target += "/snapshot"
    with urllib.request.urlopen(target, timeout=10) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _cmd_stats(args) -> int:
    from sparkucx_tpu_torch.utils.export import render_json, render_prometheus
    if args.live_url:
        doc = _fetch_live(args.live_url)
    elif args.input:
        doc = _load_anchored(args.input)
    else:
        doc = _live_snapshot()
    if args.format == "prometheus":
        sys.stdout.write(render_prometheus(doc))
    else:
        sys.stdout.write(render_json(doc) + "\n")
    return 0


def _cmd_trace(args) -> int:
    doc = _load_anchored(args.input) if args.input else None
    if doc is not None:
        spans = doc.get("spans", {})
        events = doc.get("trace_events", doc.get("traceEvents", []))
    else:
        from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
        spans = GLOBAL_TRACER.summary()
        events = GLOBAL_TRACER.chrome_events()
    cols = ("count", "mean_ms", "p50_ms", "p99_ms", "max_ms")
    w = max([len(n) for n in spans] + [4])
    print(f"{'span':<{w}}  " + "  ".join(f"{c:>9}" for c in cols))
    for name in sorted(spans):
        agg = spans[name]
        print(f"{name:<{w}}  "
              + "  ".join(f"{agg.get(c, 0.0):>9.2f}" for c in cols))
    if args.out:
        from sparkucx_tpu_torch.utils.atomicio import atomic_write_json
        atomic_write_json(args.out,
                          {"traceEvents": events, "displayTimeUnit": "ms"},
                          indent=None)
        print(f"wrote {len(events)} chrome trace events -> {args.out}")
    return 0


def _cmd_timeline(args) -> int:
    from sparkucx_tpu_torch.utils.export import merge_timeline
    if args.input is not None:
        # history JSONL logs carry window deltas, not chrome events —
        # a dump dir routinely holds one next to its metrics/flight
        # dumps now, and it must not crash (or pollute) the timeline
        paths = [p for p in _expand_inputs(args.input)
                 if not p.endswith(".jsonl")]
        if not paths:
            raise FileNotFoundError(
                "--input held only history_*.jsonl window logs; the "
                "timeline needs snapshot/flight dumps (trace events)")
        docs = [_load_anchored(p) for p in paths]
    else:
        docs = [_live_snapshot()]
    doc = merge_timeline(docs, anatomy=getattr(args, "anatomy", False))
    out = args.out or "timeline.json"
    from sparkucx_tpu_torch.utils.atomicio import atomic_write_json
    atomic_write_json(out, doc, indent=None)
    n = sum(1 for ev in doc["traceEvents"] if ev.get("ph") != "M")
    print(f"wrote {n} events across {doc['metadata']['processes']} "
          f"process track(s) -> {out}")
    return 0


def _cmd_doctor(args) -> int:
    from sparkucx_tpu_torch.utils.doctor import (GRADES, diagnose,
                                           render_findings)
    if getattr(args, "live_url", None):
        # doctor over a remote node's live endpoint: diagnose the
        # fetched snapshot LOCALLY so --fail-on grades the same way as
        # dump mode (the /doctor endpoint itself serves the same
        # findings for humans/scrapers)
        findings = diagnose([_fetch_live(args.live_url)])
    elif args.input is not None:
        docs = _load_docs(
            _expand_inputs(args.input),
            strict_anchor_for=lambda p: (args.strict_anchor
                                         or p.endswith(".jsonl")))
        findings = diagnose(docs)
    else:
        # this process (a node's own diagnosis is service.doctor() or
        # --live-url)
        findings = diagnose(_live_snapshot())
    if args.format == "json":
        print(json.dumps([f.to_dict() for f in findings], indent=1))
    else:
        sys.stdout.write(render_findings(findings))
    if args.fail_on:
        floor = GRADES.index(args.fail_on)
        if any(GRADES.index(f.grade) >= floor for f in findings):
            return 3
    return 0


def _cmd_anatomy(args) -> int:
    from sparkucx_tpu_torch.utils import anatomy
    if getattr(args, "live_url", None):
        docs = [_fetch_live(args.live_url)]
    elif args.input is not None:
        # history JSONL logs carry window deltas, not trace events —
        # skip them like the timeline does; anchors are checked by the
        # critical path itself (a single-process ledger is clock-local
        # and must render even from an anchor-less dump)
        paths = [p for p in _expand_inputs(args.input)
                 if not p.endswith(".jsonl")]
        if not paths:
            raise FileNotFoundError(
                "--input held only history_*.jsonl window logs; the "
                "anatomy view needs snapshot/flight dumps (trace "
                "events)")
        docs = [_load(p) for p in paths]
    else:
        docs = [_live_snapshot()]
    rep = anatomy.report_from_docs(docs, trace_id=args.trace)
    if args.format == "json":
        print(json.dumps(rep, indent=1, default=repr))
    else:
        for led in rep["ledgers"]:
            sys.stdout.write(anatomy.render_ledger(led))
        sys.stdout.write(
            anatomy.render_critical_path(rep["critical_path"]))
    if args.out:
        from sparkucx_tpu_torch.utils.atomicio import atomic_write_json
        from sparkucx_tpu_torch.utils.export import merge_timeline
        tl = merge_timeline(docs, anatomy=True)
        atomic_write_json(args.out, tl, indent=None)
        print(f"wrote {len(tl['traceEvents'])} events (phase child "
              f"tracks included) -> {args.out}")
    if not rep["ledgers"]:
        print("anatomy: no settled exchange in input (tracer off, or "
              "no read ran)", file=sys.stderr)
        return 2
    if args.min_attributed is not None:
        worst = min(led.get("attributed", 0.0)
                    for led in rep["ledgers"])
        if worst < args.min_attributed:
            print(f"anatomy: conservation audit FAILED — worst ledger "
                  f"attributed {100.0 * worst:.1f}% "
                  f"< {100.0 * args.min_attributed:.1f}% required",
                  file=sys.stderr)
            return 1
    return 0


def _cmd_slo(args) -> int:
    from sparkucx_tpu_torch.utils.slo import render_verdict
    if getattr(args, "live_url", None):
        # prefer the node's own evaluated verdict (/slo); a pre-SLO
        # node 404s there, in which case the snapshot's embedded
        # frames+objectives grade locally — the dump-mode path
        import urllib.error
        try:
            import urllib.request
            target = args.live_url.rstrip("/") + "/slo"
            with urllib.request.urlopen(target, timeout=10) as resp:
                verdict = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError:
            verdict = _verdict_from_docs([_fetch_live(args.live_url)])
    elif args.input is not None:
        verdict = _verdict_from_docs(
            _load_docs(_expand_inputs(args.input)))
    else:
        # a node's verdict is service.slo() in its own process
        print("slo: no live node in this process; pass --input "
              "(dump/history dirs) or --live-url", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(verdict, indent=1, default=repr))
    else:
        sys.stdout.write(render_verdict(verdict))
    if args.fail_on:
        burned = verdict.get("fast_burn") if args.fail_on == "fast" \
            else (verdict.get("fast_burn") or verdict.get("slow_burn"))
        if burned:
            return 3
    return 0


def _verdict_from_docs(docs) -> dict:
    """Fold docs (snapshots, postmortems, replayed history logs) the
    same way the doctor does, then evaluate the objectives they carry —
    a restarted process grades a dead one's windows with zero conf."""
    from sparkucx_tpu_torch.utils import slo as _slo
    from sparkucx_tpu_torch.utils.doctor import build_view
    view = build_view(docs)
    objectives = _slo.objectives_from_dicts(view.slo_objectives)
    if not objectives:
        return _slo.evaluate(view.frames, [])
    return _slo.evaluate(view.frames, objectives,
                         policy=_slo.BurnPolicy.from_dict(
                             view.slo_policy))


def _cmd_kernelbench(args) -> int:
    """``kernelbench``: run the segment-reduce microbench
    (``ops/microbench.py``) on the card (the twins alone elsewhere) and
    print the artifact as one JSON document. Exit 0 only when every
    parity grade that ran passed and the build count held (at most one
    build on the first pass, none on the warm pass); a skipped ``cuda``
    arm is a clean record, not a failure."""
    from sparkucx_tpu_torch.ops.microbench import run_microbench
    out = run_microbench(reps=args.reps, rows_log2=args.rows_log2)
    if args.out:
        from sparkucx_tpu_torch.utils.atomicio import atomic_write_json
        atomic_write_json(args.out, out, indent=1)
        out["artifact"] = args.out
    print(json.dumps(out, indent=1))
    return 0 if out["ok"] else 2


def _cmd_workload(args) -> int:
    """``workload``: run one registered pipeline and print its
    WorkloadReport JSON; exit 2 on an unknown name or a malformed
    ``--conf``, 4 when the oracle fails."""
    from sparkucx_tpu_torch import workloads
    if args.name not in workloads.WORKLOADS:
        print(f"unknown workload {args.name!r}; registered: "
              f"{', '.join(sorted(workloads.WORKLOADS.keys()))}",
              file=sys.stderr)
        return 2
    overrides = {}
    for kv in args.conf or []:
        if "=" not in kv:
            print(f"--conf wants key=value, got {kv!r}", file=sys.stderr)
            return 2
        k, v = kv.split("=", 1)
        overrides[k] = v
    kwargs = {}
    if args.arrow:
        kwargs["arrow"] = True
    rep = workloads.run_workload(args.name, budget_mb=args.budget_mb,
                                 scale=args.scale, seed=args.seed,
                                 conf_overrides=overrides, **kwargs)
    print(rep.to_json())
    return 0 if rep.oracle_ok else 4


def _cmd_cluster(args) -> int:
    """``cluster``: the out-of-band fleet view + cluster doctor. The
    whole path is collective-free by construction — it must keep
    answering when the allgather channel is parked on a wedged peer."""
    from sparkucx_tpu_torch.utils import collector as fleet
    try:
        reg = fleet.resolve_registry(peers=args.peers,
                                     registry=args.registry)
    except (FileNotFoundError, ValueError) as e:
        print(f"cluster: {e}", file=sys.stderr)
        return 2
    coll = fleet.ClusterCollector(reg, timeout_s=args.timeout_s)
    view = coll.scrape()
    findings = fleet.fleet_diagnose(view)
    if args.format == "json":
        print(json.dumps(
            {"fleet": fleet.fleet_meta(view),
             "findings": [f.to_dict() for f in findings],
             "anatomy": coll.anatomy(view, trace_id=args.trace)},
            indent=1, default=repr))
    else:
        sys.stdout.write(fleet.render_fleet_view(view, findings))
    if view["processes_answered"] == 0:
        print("cluster: NO peer answered the scrape — the registry "
              "may be stale, or the fleet is down", file=sys.stderr)
        return 2
    from sparkucx_tpu_torch.utils.doctor import GRADES
    floor = GRADES.index(args.fail_on)
    if any(GRADES.index(f.grade) >= floor for f in findings):
        return 3
    return 0


_DECISION_RULES = ("decision_split", "slow_proposer", "desync")


def _cmd_decisions(args) -> int:
    """``decisions``: join the fleet's decision ledgers and audit their
    consistency (shuffle/decisions.py). Offline: ``--input`` dump
    dirs/files (decisions_*.jsonl ledgers, plus snapshots whose
    embedded tails fill retention gaps). Live: ``--peers``/
    ``--registry`` scrape every peer's /snapshot out-of-band
    (collective-free — this is the tool for a WEDGED fleet). Exit 2
    when no ledger reached the audit, 3 past --fail-on."""
    from sparkucx_tpu_torch.shuffle.decisions import align_rounds, audit_round
    from sparkucx_tpu_torch.utils.doctor import (GRADES, build_view, diagnose,
                                           render_findings)
    fleet_meta_doc = None
    if args.input is not None:
        docs = _load_docs(_expand_inputs(args.input),
                          strict_anchor_for=lambda p: False)
    else:
        from sparkucx_tpu_torch.utils import collector as fleet
        try:
            reg = fleet.resolve_registry(peers=args.peers,
                                         registry=args.registry)
        except (FileNotFoundError, ValueError) as e:
            print(f"decisions: {e}", file=sys.stderr)
            return 2
        coll = fleet.ClusterCollector(reg, timeout_s=args.timeout_s)
        view_raw = coll.scrape()
        fleet_meta_doc = fleet.fleet_meta(view_raw)
        docs = fleet.fleet_docs(view_raw)
        if not docs:
            print("decisions: NO peer answered the scrape",
                  file=sys.stderr)
            return 2
    view = build_view(docs, fleet=fleet_meta_doc)
    if not view.decisions:
        print("decisions: no decision-ledger records in the inputs "
              "(decisions.enabled off, or the fleet never ran an "
              "agreement round)", file=sys.stderr)
        return 2
    aligned = align_rounds(view.decisions)
    splits = [(row, v) for row in aligned
              for v in [audit_round(row)] if v is not None]
    findings = [f for f in diagnose(docs, fleet=fleet_meta_doc)
                if f.rule in _DECISION_RULES]
    if args.format == "json":
        print(json.dumps(
            {"fleet": fleet_meta_doc,
             "ledgers": {str(p): {"records": len(r),
                                  "newest": r[-1] if r else None}
                         for p, r in sorted(view.decisions.items())},
             "rounds_audited": len(aligned),
             "splits": [{"epoch": row["epoch"], "seq": row["seq"],
                         "topic": next(iter(row["records"].values()))
                         .get("topic"), **v} for row, v in splits],
             "findings": [f.to_dict() for f in findings]},
            indent=1, default=repr))
    else:
        print(f"decision ledgers: {len(view.decisions)} peer(s), "
              f"{len(aligned)} aligned round(s), "
              f"{len(splits)} split(s)")
        for p, recs in sorted(view.decisions.items()):
            newest = recs[-1] if recs else {}
            print(f"  p{p}: {len(recs)} record(s), newest "
                  f"(epoch {newest.get('epoch')}, seq "
                  f"{newest.get('seq')}) topic "
                  f"{newest.get('topic')!r} ok={newest.get('ok')}")
        for row, v in splits[-8:]:
            topic = next(iter(row["records"].values())).get("topic")
            print(f"  SPLIT @ (epoch {row['epoch']}, seq "
                  f"{row['seq']}) topic {topic!r}: {v['split']} "
                  f"split, dissenters {v['dissenters']}")
        sys.stdout.write(render_findings(findings))
    if args.fail_on:
        floor = GRADES.index(args.fail_on)
        if any(GRADES.index(f.grade) >= floor for f in findings):
            return 3
    return 0


def _cmd_keys(args) -> int:
    from sparkucx_tpu_torch.config import print_key_table
    print_key_table()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sparkucx_tpu_torch")
    sub = ap.add_subparsers(dest="cmd")
    sub.add_parser("keys", help="print the conf-key table (default)")
    p_stats = sub.add_parser("stats", help="render a telemetry snapshot")
    p_stats.add_argument("--input", default=None,
                         help="metrics dump / flight-recorder JSON "
                              "(default: this process, live)")
    p_stats.add_argument("--live-url", default=None,
                         help="scrape a running node's live endpoint "
                              "(metrics.httpPort server), e.g. "
                              "http://127.0.0.1:9400")
    p_stats.add_argument("--format", default="prometheus",
                         choices=("prometheus", "json"))
    p_trace = sub.add_parser("trace", help="span summary + chrome export")
    p_trace.add_argument("--input", default=None,
                         help="flight-recorder / snapshot JSON")
    p_trace.add_argument("--out", default=None,
                         help="write chrome traceEvents JSON here")
    p_tl = sub.add_parser(
        "timeline",
        help="merge per-process dumps into one clock-aligned Perfetto "
             "timeline (a track per process)")
    p_tl.add_argument("--input", nargs="*", default=None,
                      help="snapshot/flight dump files or dump "
                           "directories (default: this process, live)")
    p_tl.add_argument("--out", default=None,
                      help="output path (default timeline.json)")
    p_tl.add_argument("--anatomy", action="store_true",
                      help="also render each exchange's swept phase "
                           "cover (utils/anatomy.py ledger, dark "
                           "segments included) as child tracks under "
                           "its process")
    p_an = sub.add_parser(
        "anatomy",
        help="exchange anatomy: per-exchange phase ledgers with the "
             "conservation audit (dark_time) and the cluster critical "
             "path, from live telemetry or dumps")
    p_an.add_argument("--input", nargs="*", default=None,
                      help="snapshot/flight dump files or dump "
                           "directories; several join into the "
                           "cluster critical path (default: this "
                           "process, live)")
    p_an.add_argument("--live-url", default=None,
                      help="fold a running node's /snapshot "
                           "(metrics.httpPort server)")
    p_an.add_argument("--trace", default=None,
                      help="restrict to one exchange trace id "
                           "(default: every settled exchange, most "
                           "recent last)")
    p_an.add_argument("--format", default="text",
                      choices=("text", "json"))
    p_an.add_argument("--min-attributed", type=float, default=None,
                      metavar="FRACTION",
                      help="exit 1 when any rendered ledger attributes "
                           "less than this fraction of its wall "
                           "(e.g. 0.95 — the CI conservation gate)")
    p_an.add_argument("--out", default=None,
                      help="write the clock-merged Perfetto timeline "
                           "with phase child tracks here")
    p_doc = sub.add_parser(
        "doctor",
        help="automated diagnosis: graded findings + the conf key to "
             "turn, from live telemetry or dumps")
    p_doc.add_argument("--input", nargs="*", default=None,
                       help="snapshot/flight dump files or dump "
                            "directories; several aggregate "
                            "cluster-wide (default: this process)")
    p_doc.add_argument("--live-url", default=None,
                       help="diagnose a running node over its live "
                            "endpoint (metrics.httpPort server)")
    p_doc.add_argument("--format", default="text",
                       choices=("text", "json"))
    p_doc.add_argument("--fail-on", default=None,
                       choices=("warn", "critical"),
                       help="exit 3 when a finding of this grade or "
                            "worse fired (CI gate)")
    p_doc.add_argument("--strict-anchor", action="store_true",
                       help="also reject anchor-less dumps (doctor "
                            "rules don't need span alignment, so "
                            "pre-anchor dumps are diagnosable by "
                            "default)")
    p_slo = sub.add_parser(
        "slo",
        help="SLO verdict: error budgets + fast/slow burn rates over "
             "retained history windows, from live telemetry, dumps or "
             "history.dir JSONL logs")
    p_slo.add_argument("--input", nargs="*", default=None,
                       help="snapshot/flight dumps, history_*.jsonl "
                            "logs, or directories of either; several "
                            "aggregate cluster-wide (default: this "
                            "process's live node)")
    p_slo.add_argument("--live-url", default=None,
                       help="grade a running node over its live "
                            "endpoint (metrics.httpPort server)")
    p_slo.add_argument("--format", default="text",
                       choices=("text", "json"))
    p_slo.add_argument("--fail-on", default=None,
                       choices=("fast", "slow"),
                       help="exit 3 when a burn of this speed (slow "
                            "implies fast too) is in progress (CI "
                            "gate)")
    p_cl = sub.add_parser(
        "cluster",
        help="out-of-band fleet view: scrape /snapshot from every "
             "registered peer over plain HTTP (no collectives), "
             "render the degraded-tolerant table + cluster doctor "
             "findings; exit 3 on graded findings, 2 when nobody "
             "answered")
    p_cl.add_argument("--peers", nargs="*", default=None,
                      help="peer base URLs (http://host:port), or ONE "
                           "path to a fleet_registry.json; default: "
                           "auto-discover ./fleet_registry.json")
    p_cl.add_argument("--registry", default=None,
                      help="fleet_registry.json written at connect() "
                           "(or the failure.ledgerDir holding it)")
    p_cl.add_argument("--timeout-s", type=float, default=2.0,
                      help="per-peer scrape deadline in seconds "
                           "(default 2.0); a wedged peer costs at "
                           "most this, never a hang")
    p_cl.add_argument("--format", default="text",
                      choices=("text", "json"))
    p_cl.add_argument("--fail-on", default="critical",
                      choices=("warn", "critical"),
                      help="exit 3 when a fleet finding at/above "
                           "this grade fired (default critical)")
    p_cl.add_argument("--trace", default=None,
                      help="pin the cross-process anatomy join to "
                           "this trace id (json format only)")
    p_dec = sub.add_parser(
        "decisions",
        help="join the fleet's decision ledgers (shuffle/decisions.py "
             "agree() round records) and audit cross-peer consistency: "
             "aligned (epoch, seq) rounds must close with identical "
             "topic + winner digest; strict-audit reduced rounds with "
             "identical proposals — the silent-conf-split detector; "
             "exit 3 past --fail-on, 2 when no ledger reached the "
             "audit")
    p_dec.add_argument("--input", nargs="*", default=None,
                       help="decisions_*.jsonl ledgers, snapshot/"
                            "flight dumps (embedded ledger tails), or "
                            "directories of either; several peers "
                            "join into the audit (default: live "
                            "fleet scrape)")
    p_dec.add_argument("--peers", nargs="*", default=None,
                       help="peer base URLs (http://host:port), or "
                            "ONE path to a fleet_registry.json")
    p_dec.add_argument("--registry", default=None,
                       help="fleet_registry.json written at connect() "
                            "(or the dir holding it)")
    p_dec.add_argument("--timeout-s", type=float, default=2.0,
                       help="per-peer scrape deadline in seconds "
                            "(default 2.0)")
    p_dec.add_argument("--format", default="text",
                       choices=("text", "json"))
    p_dec.add_argument("--fail-on", default=None,
                       choices=("warn", "critical"),
                       help="exit 3 when a decision-plane finding of "
                            "this grade or worse fired (CI gate)")
    p_wl = sub.add_parser(
        "workload",
        help="run one registered analytics pipeline (terasort | "
             "groupby | join) external-memory and print its "
             "WorkloadReport JSON")
    p_wl.add_argument("name",
                      help="registry name (workloads.WORKLOADS)")
    p_wl.add_argument("--budget-mb", type=float, default=16.0,
                      help="pinned-pool memory budget in MiB; the "
                           "dataset is 10 x budget x scale bytes "
                           "(default 16)")
    p_wl.add_argument("--scale", type=float, default=1.0,
                      help="dataset multiplier over the 10x-budget "
                           "baseline (default 1.0)")
    p_wl.add_argument("--seed", type=int, default=0)
    p_wl.add_argument("--arrow", action="store_true",
                      help="route ingest/egress through the Arrow "
                           "columnar path (io/arrow.py) where the "
                           "workload supports it")
    p_wl.add_argument("--conf", nargs="*", default=None,
                      metavar="KEY=VALUE",
                      help="extra spark.shuffle.tpu.* conf overrides "
                           "(e.g. a2a.impl pins, workload.budgetMb)")
    p_kb = sub.add_parser(
        "kernelbench",
        help="segment-reduce kernel microbench (ops/microbench.py): "
             "the torch twins timed everywhere, the CUDA kernels timed "
             "on the card and recorded as a skip with the reason "
             "elsewhere, parity graded on the card, the kernel "
             "library's builds gated in the artifact; prints one JSON "
             "doc")
    p_kb.add_argument("--reps", type=int, default=5,
                      help="timed repetitions per case (default 5)")
    p_kb.add_argument("--rows-log2", type=int, default=13,
                      help="log2 rows for the bulk cases (default 13)")
    p_kb.add_argument("--out", default=None,
                      help="also write the artifact JSON here (atomic)")
    args = ap.parse_args(argv)
    if args.cmd == "kernelbench":
        return _cmd_kernelbench(args)
    if args.cmd == "workload":
        return _cmd_workload(args)
    if args.cmd == "stats":
        return _cmd_stats(args)
    if args.cmd == "trace":
        return _cmd_trace(args)
    if args.cmd == "timeline":
        return _cmd_timeline(args)
    if args.cmd == "doctor":
        return _cmd_doctor(args)
    if args.cmd == "anatomy":
        return _cmd_anatomy(args)
    if args.cmd == "slo":
        return _cmd_slo(args)
    if args.cmd == "cluster":
        return _cmd_cluster(args)
    if args.cmd == "decisions":
        return _cmd_decisions(args)
    return _cmd_keys(args)


if __name__ == "__main__":
    sys.exit(main())
