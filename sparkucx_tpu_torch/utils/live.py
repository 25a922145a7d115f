"""Live telemetry server — the scrape endpoint of a running node (the JAX
package's ``sparkucx_tpu/utils/live.py``, the same routes, bodies and
content types).

A stdlib ``ThreadingHTTPServer`` on a daemon thread serves the node's
telemetry providers:

========== ==========================================================
endpoint   serves
========== ==========================================================
/metrics   Prometheus text exposition of the live snapshot
           (``utils/export.render_prometheus``)
/snapshot  the canonical JSON snapshot document (``Node.
           telemetry_snapshot``, or the service's richer one while a
           service runs)
/doctor    the doctor's graded findings as JSON (``service.doctor()``)
/slo       the SLO verdict as JSON (``Node.slo_verdict``)
/anatomy   per-exchange phase ledgers, the conservation audit and the
           critical path folded from the snapshot's span ring
           (``utils/anatomy.report_from_docs``); ``?trace=<id>``
           restricts it to one exchange
/decisions the node's decision-ledger document (``shuffle/decisions.py``)
/healthz   200/503 from ``Node.health_status``: the JSON body carries the
           epoch, the human ``reason`` and the machine ``cause``
/cluster/* the fleet routes (``utils/collector.py``, on a node with a
           fleet registry): ``/cluster/snapshot`` scrapes every
           registered peer out of band, ``/cluster/doctor`` grades that
           view, ``/cluster/anatomy`` folds the answered peers' span
           rings into the cluster critical path
========== ==========================================================

Conf: ``spark.shuffle.tpu.metrics.httpPort`` — unset = off (default),
``0`` = an ephemeral port (``node.live.url`` names it), positive = that
port; ``metrics.httpHost`` is the bind host (default 127.0.0.1). The node
starts the server at boot and stops it at ``close``.

Every request renders from a provider under try/except: a scrape never
takes down a shuffle, and a provider that raises answers 500.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("live")


class LiveTelemetryServer:
    """The background HTTP server. ``snapshot_fn`` returns the canonical
    snapshot dict; ``doctor_fn`` a findings list (objects with
    ``to_dict`` or plain dicts); ``health_fn`` a dict with at least
    ``ok: bool``."""

    def __init__(self, snapshot_fn: Callable[[], Dict],
                 doctor_fn: Callable[[], list],
                 health_fn: Callable[[], Dict],
                 port: int = 0, host: str = "127.0.0.1",
                 slo_fn: Optional[Callable[[], Dict]] = None,
                 cluster_fn: Optional[Callable[[], Dict]] = None,
                 decisions_fn: Optional[Callable[[], Dict]] = None):
        self._snapshot_fn = snapshot_fn
        self._doctor_fn = doctor_fn
        self._health_fn = health_fn
        self._slo_fn = slo_fn
        self._decisions_fn = decisions_fn
        # returns the ClusterCollector fleet view (utils/collector.py)
        # or None while no fleet registry exists on this node — the
        # /cluster/* routes 404 with a reason instead of guessing.
        # Served by ANY peer: a scrape of one process answers for the
        # whole fleet, which is the degraded-mode contract (the peer
        # you can still reach tells you about the ones you cannot).
        self._cluster_fn = cluster_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # scrape chatter must not spam the shuffle's stderr
            def log_message(self, fmt, *args):  # noqa: N802
                log.debug("live %s", fmt % args)

            def do_GET(self):  # noqa: N802
                outer._route(self)

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="sparkucx-live-http", daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "LiveTelemetryServer":
        self._thread.start()
        log.info("live telemetry server up at %s (/metrics /snapshot "
                 "/doctor /slo /anatomy /decisions /healthz /cluster/*)",
                 self.url)
        return self

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            log.debug("live server shutdown failed", exc_info=True)
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    # -- request handling --------------------------------------------------
    def _route(self, req) -> None:
        path = req.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                from sparkucx_tpu_torch.utils.export import render_prometheus
                body = render_prometheus(self._snapshot_fn())
                self._send(req, 200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/snapshot":
                from sparkucx_tpu_torch.utils.export import render_json
                self._send(req, 200, render_json(self._snapshot_fn()),
                           "application/json")
            elif path == "/doctor":
                findings = self._doctor_fn()
                body = json.dumps(
                    [f.to_dict() if hasattr(f, "to_dict") else f
                     for f in findings], indent=1)
                self._send(req, 200, body, "application/json")
            elif path == "/slo":
                if self._slo_fn is None:
                    self._send(req, 404, json.dumps(
                        {"error": "no SLO provider on this node (set "
                                  "spark.shuffle.tpu.slo.read.p99Ms / "
                                  "slo.availability)"}),
                        "application/json")
                else:
                    self._send(req, 200,
                               json.dumps(self._slo_fn(), indent=1,
                                          default=repr),
                               "application/json")
            elif path == "/decisions":
                if self._decisions_fn is None:
                    self._send(req, 404, json.dumps(
                        {"error": "no decision ledger on this node "
                                  "(spark.shuffle.tpu.decisions.enabled"
                                  "=false)"}),
                        "application/json")
                else:
                    self._send(req, 200,
                               json.dumps(self._decisions_fn(), indent=1,
                                          default=repr),
                               "application/json")
            elif path == "/anatomy":
                # folded FROM the canonical snapshot (one seam): the
                # doc embeds the span ring, so the ledgers and the
                # conservation audit render server-side; ?trace=<id>
                # restricts to one exchange
                from urllib.parse import parse_qs, urlparse
                from sparkucx_tpu_torch.utils.anatomy import report_from_docs
                q = parse_qs(urlparse(req.path).query)
                tr = (q.get("trace") or [None])[0]
                rep = report_from_docs([self._snapshot_fn()],
                                       trace_id=tr)
                self._send(req, 200,
                           json.dumps(rep, indent=1, default=repr),
                           "application/json")
            elif path in ("/cluster/snapshot", "/cluster/doctor",
                          "/cluster/anatomy"):
                self._route_cluster(req, path)
            elif path == "/healthz":
                h = self._health_fn()
                self._send(req, 200 if h.get("ok") else 503,
                           json.dumps(h, default=repr),
                           "application/json")
            else:
                self._send(req, 404, json.dumps(
                    {"error": f"unknown path {path!r}", "paths": [
                        "/metrics", "/snapshot", "/doctor", "/slo",
                        "/anatomy", "/decisions", "/healthz",
                        "/cluster/snapshot", "/cluster/doctor",
                        "/cluster/anatomy"]}),
                    "application/json")
        except Exception as e:
            log.debug("live request %s failed", path, exc_info=True)
            try:
                self._send(req, 500, json.dumps({"error": repr(e)[:300]}),
                           "application/json")
            except Exception:
                pass  # client went away mid-error; nothing to serve

    def _route_cluster(self, req, path: str) -> None:
        """The fleet routes: a FRESH scrape of every registered peer per
        request (staleness is then the requester's choice, not a cache
        policy), folded server-side like /anatomy — any reachable peer
        answers for the whole fleet, including the peers that did not."""
        if self._cluster_fn is None:
            self._send(req, 404, json.dumps(
                {"error": "no fleet registry on this node (set "
                          "spark.shuffle.tpu.metrics.httpPort so "
                          "connect() publishes a scrape URL; the "
                          "registry is allgathered at boot)"}),
                "application/json")
            return
        view = self._cluster_fn()
        if view is None:
            self._send(req, 404, json.dumps(
                {"error": "fleet registry empty (no peer published a "
                          "scrape URL at connect)"}),
                "application/json")
            return
        if path == "/cluster/snapshot":
            body = json.dumps(view, indent=1, default=repr)
        elif path == "/cluster/doctor":
            from sparkucx_tpu_torch.utils.collector import (fleet_diagnose,
                                                      fleet_meta)
            findings = fleet_diagnose(view)
            body = json.dumps(
                {"fleet": fleet_meta(view),
                 "findings": [f.to_dict() for f in findings]},
                indent=1, default=repr)
        else:  # /cluster/anatomy
            from urllib.parse import parse_qs, urlparse
            from sparkucx_tpu_torch.utils.anatomy import report_from_docs
            from sparkucx_tpu_torch.utils.collector import fleet_docs
            q = parse_qs(urlparse(req.path).query)
            tr = (q.get("trace") or [None])[0]
            docs = fleet_docs(view)
            rep = report_from_docs(docs, trace_id=tr) if docs else {
                "ledgers": [], "exchanges_seen": 0,
                "critical_path": {"error": "no peer answered"}}
            rep["missing_peers"] = view.get("missing_peers", [])
            body = json.dumps(rep, indent=1, default=repr)
        self._send(req, 200, body, "application/json")

    @staticmethod
    def _send(req, status: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        req.send_response(status)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)


def start_from_conf(conf, snapshot_fn, doctor_fn, health_fn,
                    slo_fn=None, cluster_fn=None,
                    decisions_fn=None) -> Optional[LiveTelemetryServer]:
    """Build+start the server from ``metrics.httpPort`` (None when the
    key is unset — off is the default — or the bind fails: a node must
    never fail to BOOT over its observability port, the same rule as the
    clock-anchor allgather)."""
    raw = conf.get("spark.shuffle.tpu.metrics.httpPort")
    if raw is None or str(raw).strip() == "":
        return None
    try:
        port = int(str(raw).strip())
        if port < 0:
            return None
        host = conf.get("spark.shuffle.tpu.metrics.httpHost",
                        "127.0.0.1")
        return LiveTelemetryServer(snapshot_fn, doctor_fn, health_fn,
                                   port=port, host=host, slo_fn=slo_fn,
                                   cluster_fn=cluster_fn,
                                   decisions_fn=decisions_fn).start()
    except Exception as e:
        log.warning("live telemetry server unavailable "
                    "(metrics.httpPort=%r): %s — continuing without a "
                    "scrape endpoint", raw, e)
        return None
