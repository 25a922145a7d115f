"""Fleet telemetry plane — out-of-band cluster scraping that survives a
wedged peer (the JAX package's ``sparkucx_tpu/utils/collector.py``).

Every cluster-wide view that rides a collective (``gather_reports``,
the clock anchors) hangs with the collective when a peer wedges. This
module is the plane that does not:

* a **fleet registry** — each process's live-telemetry URL
  (``utils/live.py``; ``metrics.httpAdvertiseHost`` rewrites the loopback
  bind host into one peers can reach) published through ONE boot-time
  allgather (``shuffle/distributed.gather_fleet_registry``), when every
  process is alive in lockstep by construction, and persisted beside the
  durable ledger (``failure.ledgerDir/fleet_registry.json``) so a
  restarted process or the offline CLI adopts the same address book
  without any collective;
* a :class:`ClusterCollector` — ``/snapshot`` scrapes of every peer over
  plain HTTP with **per-peer deadlines** on worker threads: a dead peer
  costs one bounded timeout, never a hang, and the fleet view holds
  whoever answered, with ``missing_peers``, per-peer ``collected_at``,
  ``rtt_ms`` and ``skew_s`` (the peer's scrape-time clock anchor minus its
  boot anchor from the registry, graded by the doctor's ``clock_drift``
  rule);
* the **watchdog postmortem hook** (:meth:`ClusterCollector.postmortem`,
  wired as ``runtime/watchdog.Watchdog.peer_scrape``): when a collective
  deadline fires, the survivor scrapes the fleet out of band and embeds
  each peer's last-known phase ledger in the flight dump.

Nothing here touches a collective after boot: scraping is HTTP, the
registry is a file, and the doctor runs locally over the answered docs.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Iterable, List, Optional

from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("collector")

#: The registry file written beside the durable ledger
#: (``failure.ledgerDir``) — restart adoption + offline CLI discovery.
REGISTRY_FILENAME = "fleet_registry.json"

#: Default per-peer scrape deadline (``fleet.scrapeTimeoutMs``).
DEFAULT_TIMEOUT_S = 2.0


def registry_path(root: str) -> str:
    return os.path.join(root, REGISTRY_FILENAME)


def registry_entry(process_id: int, url: str, anchor: Dict,
                   published_at: Optional[float] = None) -> Dict:
    """One process's registry row: its scrape URL plus the boot-time
    clock anchor (the baseline every later re-anchor's ``skew_s`` is
    measured against)."""
    return {"process_id": int(process_id), "url": str(url).rstrip("/"),
            "pid": os.getpid(), "anchor": dict(anchor),
            "published_at": (time.time() if published_at is None
                             else float(published_at))}


# -- advertised URL resolution ---------------------------------------------
_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1", "0.0.0.0", "::")
_warned_loopback = False


def advertised_url(conf, live, multiprocess: bool = False) -> Optional[str]:
    """The URL this process should PUBLISH for peers to scrape, or None
    when the live server is off. ``metrics.httpHost`` defaults to
    loopback (a telemetry plane opts IN to exposure), which is exactly
    wrong as a published address in a multi-process world — the new
    ``metrics.httpAdvertiseHost`` rewrites the host part without
    changing the bind. Publishing a loopback address to real peers is
    warned ONCE (fail loudly, not fatally: a single-host multi-process
    world legitimately scrapes over loopback)."""
    global _warned_loopback
    if live is None:
        return None
    adv = conf.get("spark.shuffle.tpu.metrics.httpAdvertiseHost")
    host = str(adv).strip() if adv is not None and str(adv).strip() \
        else str(live.host)
    if multiprocess and host in _LOOPBACK_HOSTS and not _warned_loopback:
        _warned_loopback = True
        log.warning(
            "fleet registry is publishing a LOOPBACK scrape address "
            "(%s:%s) to %s peers — remote processes cannot reach it; "
            "set spark.shuffle.tpu.metrics.httpAdvertiseHost to this "
            "host's cluster-reachable address (the bind host, "
            "metrics.httpHost, stays loopback)", host, live.port,
            "remote" if adv is None else "the")
    return f"http://{host}:{live.port}"


class FleetRegistry:
    """The boot-agreed address book: ``process_id -> registry entry``.

    Built from the allgathered entry list at connect, from the
    persisted ``fleet_registry.json`` (restart adoption / offline CLI),
    or from an explicit URL list (the ``cluster --peers`` path, which
    fabricates sequential ids)."""

    def __init__(self, entries: Iterable[Dict]):
        self.entries: Dict[int, Dict] = {}
        for e in entries or []:
            if not isinstance(e, dict) or not e.get("url"):
                continue  # a peer with its live server off publishes {}
            try:
                pid = int(e["process_id"])
            except (KeyError, TypeError, ValueError):
                continue
            old = self.entries.get(pid)
            if old is None or float(e.get("published_at", 0.0)) \
                    >= float(old.get("published_at", 0.0)):
                self.entries[pid] = dict(e)

    @classmethod
    def from_urls(cls, urls: Iterable[str]) -> "FleetRegistry":
        return cls([{"process_id": i, "url": u}
                    for i, u in enumerate(urls)])

    @classmethod
    def load(cls, path: str) -> "FleetRegistry":
        """Load a persisted registry; ``path`` may be the JSON file or
        the directory holding it (``failure.ledgerDir``)."""
        if os.path.isdir(path):
            path = registry_path(path)
        with open(path) as f:
            doc = json.load(f)
        return cls(doc.get("entries", []))

    def save(self, root: str) -> str:
        """Persist beside the durable ledger, MERGED with any existing
        file (newest ``published_at`` per process wins) so a rolling
        restart adopts survivors' rows instead of wiping them. Atomic —
        a torn registry would strand every restart (the
        shuffle/durable.py discipline)."""
        os.makedirs(root, exist_ok=True)
        path = registry_path(root)
        merged = dict(self.entries)
        try:
            for pid, e in FleetRegistry.load(path).entries.items():
                old = merged.get(pid)
                if old is None or float(e.get("published_at", 0.0)) \
                        > float(old.get("published_at", 0.0)):
                    merged[pid] = e
        except (OSError, ValueError):
            pass  # no/unreadable prior file: this boot's view stands
        self.entries = merged
        from sparkucx_tpu_torch.utils.atomicio import atomic_write_json
        atomic_write_json(path, self.to_doc(), indent=1)
        return path

    def to_doc(self) -> Dict:
        return {"version": 1,
                "entries": [self.entries[p]
                            for p in sorted(self.entries)]}

    def expected(self) -> List[int]:
        return sorted(self.entries)

    def peers(self) -> Dict[int, str]:
        return {p: self.entries[p]["url"] for p in sorted(self.entries)}

    def boot_anchor(self, process_id: int) -> Optional[Dict]:
        e = self.entries.get(int(process_id))
        a = e.get("anchor") if e else None
        return a if isinstance(a, dict) and "wall_epoch" in a else None

    def __len__(self) -> int:
        return len(self.entries)


# -- scraping ---------------------------------------------------------------
def scrape_snapshot(url: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> Dict:
    """One peer's ``/snapshot`` as a dict; raises on any failure (the
    caller classifies). The GET itself is the per-peer deadline."""
    target = url.rstrip("/")
    if not target.endswith("/snapshot"):
        target += "/snapshot"
    with urllib.request.urlopen(target, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


class ClusterCollector:
    """Degraded-tolerant fleet scraper over a :class:`FleetRegistry`.

    ``scrape()`` fans one worker thread per peer (daemon — an unkillable
    socket read must not pin shutdown), joins each against the per-peer
    deadline, and assembles the fleet view from whoever answered. A peer
    that misses its deadline lands in ``missing_peers`` with its error;
    the view never waits longer than ~one deadline total."""

    def __init__(self, registry: FleetRegistry,
                 self_id: Optional[int] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 fetch: Optional[Callable[[str, float], Dict]] = None):
        self.registry = registry
        self.self_id = self_id
        self.timeout_s = float(timeout_s)
        self._fetch = fetch or scrape_snapshot

    # -- the fleet view ---------------------------------------------------
    def scrape(self, timeout_s: Optional[float] = None) -> Dict:
        """Scrape every registered peer; returns the fleet view::

            {"generated_at": wall, "expected": [ids],
             "missing_peers": [ids], "processes_answered": n,
             "peers": {"<id>": {"url", "ok", "error", "collected_at",
                                "rtt_ms", "skew_s", "doc"}}}

        ``collected_at`` is THIS process's wall clock when the peer's
        bytes landed (staleness is always judged on the reader's
        clock); ``skew_s`` is the peer's scrape-time re-anchor minus
        its boot anchor from the registry — the drift estimate the
        ``clock_drift`` rule grades."""
        limit = self.timeout_s if timeout_s is None else float(timeout_s)
        peers = self.registry.peers()
        cells: Dict[str, Dict] = {}
        threads = []

        def one(pid: int, url: str) -> None:
            cell: Dict = {"url": url, "ok": False, "error": None,
                          "collected_at": None, "rtt_ms": None,
                          "skew_s": None, "doc": None}
            t0 = time.perf_counter()
            try:
                doc = self._fetch(url, limit)
                cell["ok"] = True
                cell["doc"] = doc
                cell["collected_at"] = time.time()
                cell["rtt_ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 3)
                boot = self.registry.boot_anchor(pid)
                fresh = doc.get("anchor") if isinstance(doc, dict) else None
                if boot and isinstance(fresh, dict) \
                        and "wall_epoch" in fresh:
                    cell["skew_s"] = round(
                        float(fresh["wall_epoch"])
                        - float(boot["wall_epoch"]), 6)
            except Exception as e:  # noqa: BLE001 — classified below
                cell["error"] = repr(e)[:200]
            cells[str(pid)] = cell

        for pid, url in peers.items():
            t = threading.Thread(target=one, args=(pid, url),
                                 daemon=True,
                                 name=f"sxt-fleet-scrape-{pid}")
            threads.append((pid, t))
            t.start()
        deadline = time.monotonic() + limit + 0.5
        for pid, t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                # the worker is parked past its own socket deadline
                # (DNS stall, accept-then-silence) — record the miss
                # and move on; the daemon thread ages out on its own
                cells.setdefault(str(pid), {
                    "url": peers[pid], "ok": False,
                    "error": f"scrape deadline ({limit:.1f}s) expired",
                    "collected_at": None, "rtt_ms": None,
                    "skew_s": None, "doc": None})
        missing = [p for p in peers
                   if not cells.get(str(p), {}).get("ok")]
        return {"generated_at": time.time(),
                "expected": list(peers),
                "missing_peers": missing,
                "processes_answered": len(peers) - len(missing),
                "peers": cells}

    # -- watchdog integration ---------------------------------------------
    def postmortem(self, what: str = "", trace: Optional[str] = None,
                   timeout_s: Optional[float] = None) -> Dict:
        """The out-of-band scrape a survivor's watchdog expiry runs: a
        bounded fleet scrape (never a collective — the collective just
        proved dead) whose per-peer cells carry each peer's last-known
        phase ledger for the stuck exchange. Embedded into the flight
        postmortem as ``peer_timeout.peer_postmortem``."""
        view = self.scrape(timeout_s=timeout_s)
        peers: Dict[str, Dict] = {}
        for pid, cell in view["peers"].items():
            entry = {k: cell.get(k) for k in
                     ("url", "ok", "error", "collected_at", "rtt_ms",
                      "skew_s")}
            doc = cell.get("doc")
            if isinstance(doc, dict):
                entry["last_known"] = last_known_phase(doc, trace)
                entry["last_decision"] = last_known_decision(doc)
            peers[pid] = entry
        return {"what": what, "trace": trace or "",
                "generated_at": view["generated_at"],
                "expected": view["expected"],
                "missing_peers": view["missing_peers"],
                "peers": peers}

    # -- derived documents (the /cluster routes + CLI) ---------------------
    def snapshot(self) -> Dict:
        return self.scrape()

    def doctor(self, view: Optional[Dict] = None):
        return fleet_diagnose(view or self.scrape())

    def anatomy(self, view: Optional[Dict] = None,
                trace_id: Optional[str] = None) -> Dict:
        from sparkucx_tpu_torch.utils.anatomy import report_from_docs
        view = view or self.scrape()
        docs = fleet_docs(view)
        if not docs:
            return {"ledgers": [], "exchanges_seen": 0,
                    "critical_path": {"trace_id": None, "process": None,
                                      "phase": None, "tier": "",
                                      "error": "no peer answered"},
                    "missing_peers": view["missing_peers"]}
        rep = report_from_docs(docs, trace_id=trace_id)
        rep["missing_peers"] = view["missing_peers"]
        return rep


def fleet_docs(view: Dict) -> List[Dict]:
    """The answered peers' snapshot docs, scrape order."""
    return [c["doc"] for c in (view.get("peers") or {}).values()
            if c.get("ok") and isinstance(c.get("doc"), dict)]


def fleet_meta(view: Dict) -> Dict:
    """The view minus the (large) embedded docs — what the doctor rules
    read and what findings cite as evidence."""
    peers = {pid: {k: c.get(k) for k in
                   ("url", "ok", "error", "collected_at", "rtt_ms",
                    "skew_s")}
             for pid, c in (view.get("peers") or {}).items()}
    return {"generated_at": view.get("generated_at"),
            "expected": view.get("expected", []),
            "missing_peers": view.get("missing_peers", []),
            "processes_answered": view.get("processes_answered", 0),
            "peers": peers}


def fleet_diagnose(view: Dict, thresholds=None):
    """The cluster doctor over whatever answered: ``diagnose`` with the
    fleet meta attached, so the fleet-aware rules (``peer_unresponsive``,
    ``clock_drift``) see reachability and skew next to the folded
    telemetry. Zero answered peers still grades — the missing-peer rule
    is then the whole story. Cross-process straggler attribution joins
    the anatomy critical path over the answered docs into the meta."""
    from sparkucx_tpu_torch.utils.doctor import diagnose
    docs = fleet_docs(view)
    meta = fleet_meta(view)
    if len(docs) >= 2:
        try:
            from sparkucx_tpu_torch.utils.anatomy import critical_path
            cp = critical_path(docs)
            if cp.get("process") is not None:
                meta["critical_path"] = {
                    k: cp[k] for k in ("trace_id", "process", "phase",
                                       "tier", "wall_ms",
                                       "straggler_lag_ms")
                    if k in cp}
        except (ValueError, KeyError):
            pass  # anchor-less or ledger-less docs: attribution is a
            #       bonus, never a scrape failure
    return diagnose(docs or [{}], fleet=meta, thresholds=thresholds)


def last_known_phase(doc: Dict, trace_id: Optional[str] = None) -> Dict:
    """A peer's last-known position from its scraped span ring: the
    settled ledger when the exchange finished there (``settled: true``
    — this peer is NOT the one stuck), else the newest recorded span
    and how long ago it ended on the wall clock (``since_s``) — the
    honest "it last finished <span> in <phase>, N seconds ago" a
    survivor's postmortem prints for a wedged peer. Spans record on
    END, so an in-flight collective shows as silence after its last
    completed phase — exactly the signature of a peer parked in a
    collective."""
    events = doc.get("trace_events") or doc.get("events") or []
    if trace_id:
        from sparkucx_tpu_torch.utils.anatomy import fold_events
        led = fold_events(events, trace_id)
        if led is not None:
            return {"settled": True, "trace_id": trace_id,
                    "wall_ms": round(led.wall_ms, 3),
                    "dominant_phase": led.dominant_phase,
                    "phases_ms": {k: round(v, 3)
                                  for k, v in led.phases_ms.items()
                                  if v > 0.0}}
    from sparkucx_tpu_torch.utils.anatomy import _span_phase
    best = None
    for ev in events:
        if ev.get("ph") == "M" or "ts" not in ev:
            continue
        end = float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0))
        if best is None or end > best[0]:
            best = (end, ev)
    if best is None:
        return {"settled": False, "last_span": None, "phase": None,
                "since_s": None}
    end_us, ev = best
    anchor = doc.get("anchor") or {}
    since = None
    if isinstance(anchor, dict) and "wall_epoch" in anchor:
        since = round(time.time()
                      - (float(anchor["wall_epoch"]) + end_us / 1e6), 3)
    args = ev.get("args") or {}
    return {"settled": False,
            "last_span": ev.get("name"),
            "phase": _span_phase(str(ev.get("name", "")), args),
            "trace_id": args.get("trace") or trace_id,
            "since_s": since}


def last_known_decision(doc: Dict) -> Optional[Dict]:
    """A peer's last-closed agreement round from its scraped decision
    ledger (shuffle/decisions.py records embedded in the snapshot) —
    the decision-plane twin of ``last_known_phase``, printed beside it
    in the watchdog's ``peer_postmortem``. A peer wedged INSIDE an
    agreement round shows its previous round here (records land on
    round EXIT), so "last decision (epoch,seq) lags the fleet" is the
    signature of a peer parked in the agreement collective. ``None``
    when the peer has no ledger (the plane disabled, or no round yet)."""
    recs = doc.get("decisions")
    if not isinstance(recs, list) or not recs:
        return None
    last = recs[-1]
    if not isinstance(last, dict):
        return None
    out = {k: last.get(k) for k in
           ("epoch", "seq", "topic", "ok", "ts", "winner")}
    out["since_s"] = (round(time.time() - float(last["ts"]), 3)
                      if isinstance(last.get("ts"), (int, float))
                      else None)
    return out


# -- CLI-side peer resolution ----------------------------------------------
def resolve_registry(peers: Optional[List[str]] = None,
                     registry: Optional[str] = None) -> FleetRegistry:
    """Peer discovery for the ``cluster`` CLI: explicit ``--peers``
    (URLs, or a single registry-file path), an explicit ``--registry``
    file/dir, or the default ``./fleet_registry.json``."""
    if peers:
        if len(peers) == 1 and not peers[0].startswith("http") \
                and os.path.exists(peers[0]):
            return FleetRegistry.load(peers[0])
        return FleetRegistry.from_urls(peers)
    path = registry or REGISTRY_FILENAME
    if os.path.isdir(path):
        path = registry_path(path)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no fleet registry at {path!r}: pass --peers URL... or "
            f"--registry <fleet_registry.json | failure.ledgerDir> "
            f"(written at connect when metrics.httpPort is set)")
    return FleetRegistry.load(path)


def render_fleet_view(view: Dict, findings=None) -> str:
    """Operator table: one row per expected peer, degraded cells
    explicit."""
    lines = [f"fleet: {view.get('processes_answered', 0)}/"
             f"{len(view.get('expected', []))} peer(s) answered"]
    header = (f"{'peer':>5}  {'status':<8}  {'rtt_ms':>8}  "
              f"{'skew_s':>9}  url")
    lines.append(header)
    for pid in view.get("expected", []):
        c = (view.get("peers") or {}).get(str(pid), {})
        status = "ok" if c.get("ok") else "MISSING"
        rtt = f"{c['rtt_ms']:.1f}" if c.get("rtt_ms") is not None else "-"
        skew = f"{c['skew_s']:+.4f}" if c.get("skew_s") is not None \
            else "-"
        lines.append(f"{pid:>5}  {status:<8}  {rtt:>8}  {skew:>9}  "
                     f"{c.get('url', '?')}")
        if not c.get("ok") and c.get("error"):
            lines.append(f"       error: {c['error']}")
    if findings is not None:
        from sparkucx_tpu_torch.utils.doctor import render_findings
        lines.append("")
        lines.append(render_findings(findings).rstrip("\n"))
    return "\n".join(lines) + "\n"
