"""Port parity for the live telemetry server (``sparkucx_tpu_torch/utils/
live.py``) and the node's routes.

* The reference's live cases, each run unchanged on the port
  (``torch_ref_cases.port_view``): ``tests/test_devmon.py``'s two
  endpoint cases, its two ``/healthz`` cases and its ``--live-url`` CLI
  case, through a port service factory; ``tests/test_decisions.py``'s
  ``/decisions`` route, through a port copy of its ``dist_node`` fixture
  (a port node forced distributed inside a one-rank gloo world, two
  slices, so its reads run agreement rounds). The anatomy and SLO suites'
  live cases run in ``tests/test_torch_anatomy.py`` and
  ``tests/test_torch_slo.py``.
* Both packages' servers on one fixed snapshot document, findings list,
  health verdicts, SLO verdict, decision ledger and fleet view: byte-equal
  bodies, equal status codes and ``Content-Type`` on every route, the
  404s without a provider and of an unknown path, and the 500 of a
  provider that raises.
* The node: ``metrics.httpPort`` unset starts nothing; a taken port
  leaves the node up without a server; ``close`` stops it.
"""

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch.distributed as tdist

from sparkucx_tpu.utils import live as jlive
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.utils import live as tlive
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER
from torch_ref_cases import port_view, run_case

PFX = "spark.shuffle.tpu."
DEVMON_CASES = ("test_live_endpoints_match_facade",
                "test_live_endpoints_respond_during_exchange",
                "test_healthz_flips_on_epoch_bump_and_device_unhealthy",
                "test_healthz_cause_enum_flips_per_cause",
                "test_cli_live_url_stats_and_doctor")


@pytest.fixture()
def port_service_factory():
    """``make(overrides)`` -> a port service on the CPU over
    ``tests/test_devmon.py``'s base conf; a new one stops the previous
    one first."""
    base = port_view("test_devmon").BASE_CONF
    made = []

    def make(overrides=None):
        while made:
            made.pop().stop()
        svc = connect({**base, **(overrides or {})}, device="cpu",
                      use_env=False)
        made.append(svc)
        return svc

    yield make
    while made:
        made.pop().stop()


@pytest.mark.parametrize("name", DEVMON_CASES)
def test_devmon_live_case(name, request):
    """One of the reference's live-server cases, unchanged, on the port."""
    run_case(port_view("test_devmon"), name, {}, request,
             {"service_factory": "port_service_factory"})


@pytest.fixture()
def port_dist_node():
    """The reference's ``dist_node`` on the port: a node of two slices
    with the live server on, forced distributed inside a one-rank gloo
    world (its collectives fall back to that world), and its manager."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    svc = connect({PFX + "a2a.impl": "dense", PFX + "mesh.numSlices": "2",
                   PFX + "metrics.httpPort": "0"}, device="cpu",
                  use_env=False)
    svc.node.is_distributed = True
    try:
        yield svc.node, svc.manager
    finally:
        svc.node.is_distributed = False
        svc.stop()
        tdist.destroy_process_group()


def test_live_decisions_route(request):
    run_case(port_view("test_decisions"), "test_live_decisions_route", {},
             request, {"dist_node": "port_dist_node"})


# -- both packages' servers on the same documents ----------------------------
@pytest.fixture(scope="module")
def fixed_docs():
    """A port service's snapshot after two traced reads (span ring,
    histograms, reports), its findings, SLO verdict and decision ledger
    document, and a fleet view of two answered peers and a dead one."""
    from sparkucx_tpu_torch.utils import collector as tcoll
    GLOBAL_TRACER.clear()
    svc = connect({PFX + "a2a.impl": "dense", PFX + "trace.enabled": "true",
                   PFX + "history.windowSecs": "86400",
                   PFX + "slo.read.p99Ms": "0.001"}, device="cpu",
                  use_env=False)
    try:
        rng = np.random.default_rng(3)
        h = svc.register_shuffle(31, 2, 4)
        for m in range(2):
            svc.write(h, m, rng.integers(0, 64, size=512),
                      rng.integers(0, 100, (512, 2)).astype(np.int32))
        svc.read(h)
        svc.node.history.roll()
        svc.read(h, combine="sum")
        svc.node.history.roll()
        snap = json.loads(json.dumps(svc.stats("json"), default=repr))
        findings = svc.doctor("json")
        slo = svc.slo()
        decisions = svc.node.decision_ledger()
        trace = svc.report(31).trace_id
    finally:
        svc.stop()
        GLOBAL_TRACER.enabled = False
        GLOBAL_TRACER.clear()
    cells = {}
    for pid in ("0", "1", "2"):
        ok = pid != "2"
        cells[pid] = {"url": f"http://127.0.0.1:{9000 + int(pid)}",
                      "ok": ok, "error": None if ok else "URLError(111)",
                      "collected_at": 1000.5 if ok else None,
                      "rtt_ms": 1.25 if ok else None,
                      "skew_s": 0.002 if ok else None,
                      "doc": dict(snap, process_id=int(pid)) if ok else None}
    view = {"generated_at": 1001.0, "expected": [0, 1, 2],
            "missing_peers": [2], "processes_answered": 2, "peers": cells}
    assert tcoll.fleet_docs(view)
    return {"snap": snap, "findings": findings, "slo": slo,
            "decisions": decisions, "view": view, "trace": trace}


ROUTES = ("/metrics", "/snapshot", "/doctor", "/slo", "/decisions",
          "/anatomy", "/anatomy?trace={trace}", "/anatomy?trace=nope",
          "/healthz", "/cluster/snapshot", "/cluster/doctor",
          "/cluster/anatomy", "/cluster/anatomy?trace={trace}", "/nope",
          "/metrics/")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("variant", ["full", "bare", "unhealthy",
                                     "empty_fleet", "raising"])
def test_servers_answer_byte_equal(variant, fixed_docs):
    d = fixed_docs
    kw = {"snapshot_fn": lambda: d["snap"],
          "doctor_fn": lambda: d["findings"],
          "health_fn": lambda: {"ok": True, "epoch": 0, "cause": None},
          "port": 0}
    if variant in ("full", "unhealthy", "raising"):
        kw.update(slo_fn=lambda: d["slo"], decisions_fn=lambda: d["decisions"],
                  cluster_fn=lambda: d["view"])
    if variant == "unhealthy":
        kw["health_fn"] = lambda: {"ok": False, "epoch": 2,
                                   "reason": "node closed",
                                   "cause": "closed"}
    if variant == "empty_fleet":
        kw["cluster_fn"] = lambda: None
    if variant == "raising":
        def boom():
            raise RuntimeError("provider down")
        kw.update(snapshot_fn=boom, doctor_fn=boom, slo_fn=boom,
                  decisions_fn=boom, health_fn=boom, cluster_fn=boom)
    servers = [mod.LiveTelemetryServer(**kw).start()
               for mod in (jlive, tlive)]
    try:
        statuses = {}
        for route in ROUTES:
            path = route.format(trace=d["trace"])
            j, t = (_get(s.url + path) for s in servers)
            assert j == t, path
            statuses[path] = j[0]
    finally:
        for s in servers:
            s.stop()
    assert statuses["/nope"] == 404
    if variant == "full":
        assert set(statuses.values()) == {200, 404}
        assert [p for p, c in statuses.items() if c == 404] == ["/nope"]
    if variant == "bare":
        assert {p for p, c in statuses.items() if c == 404} == {
            "/slo", "/decisions", "/cluster/snapshot", "/cluster/doctor",
            "/cluster/anatomy", f"/cluster/anatomy?trace={d['trace']}",
            "/nope"}
    if variant == "unhealthy":
        assert statuses["/healthz"] == 503
    if variant == "empty_fleet":
        assert statuses["/cluster/doctor"] == 404
    if variant == "raising":
        assert statuses["/metrics"] == statuses["/healthz"] == 500
        assert statuses["/cluster/snapshot"] == 500


def test_anatomy_route_names_the_read(fixed_docs):
    srv = tlive.LiveTelemetryServer(lambda: fixed_docs["snap"], lambda: [],
                                    lambda: {"ok": True}).start()
    try:
        _, _, body = _get(srv.url + f"/anatomy?trace={fixed_docs['trace']}")
    finally:
        srv.stop()
    rep = json.loads(body)
    assert [led["trace_id"] for led in rep["ledgers"]] == \
        [fixed_docs["trace"]]


# -- the node ------------------------------------------------------------------
def test_port_unset_starts_nothing_and_taken_port_boots_without_server():
    svc = connect({}, device="cpu", use_env=False)
    try:
        assert svc.node.live is None
    finally:
        svc.stop()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        taken = s.getsockname()[1]
        svc = connect({PFX + "metrics.httpPort": str(taken)}, device="cpu",
                      use_env=False)
        try:
            assert svc.node.live is None       # the bind failed: no server
            assert svc.node.health_status()["ok"]
        finally:
            svc.stop()
    for bad in ("-1", "port"):
        svc = connect({PFX + "metrics.httpPort": bad}, device="cpu",
                      use_env=False)
        try:
            assert svc.node.live is None
        finally:
            svc.stop()


def test_close_stops_the_server_and_healthz_reads_the_node():
    svc = connect({PFX + "metrics.httpPort": "0"}, device="cpu",
                  use_env=False)
    url = svc.node.live.url
    assert _get(url + "/healthz")[0] == 200
    svc.node.mark_unhealthy("drained for maintenance")
    status, ctype, body = _get(url + "/healthz")
    assert status == 503 and ctype == "application/json"
    assert json.loads(body)["cause"] == "operator"
    svc.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/healthz", timeout=2)
