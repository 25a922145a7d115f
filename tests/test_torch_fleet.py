"""Port parity for the fleet plane (``sparkucx_tpu_torch/utils/
collector.py``, the node's fleet registry, ``shuffle/distributed.
gather_fleet_registry`` and the watchdog's expiry scrape).

* The reference's cases: every case of ``tests/test_fleet.py`` but the
  five doctor cases ``tests/test_torch_doctor.py`` runs, each run
  unchanged on the port (``torch_ref_cases.port_view``: its collector,
  live server, watchdog, flight recorder, doctor and CLI are the port's,
  and so is the subprocess peers' server). Three cases get a port copy
  with the same assertions: the loopback warning (it listens on the JAX
  package's logger name) and the two node cases (they boot the JAX node
  by hand).
* Collectors across packages: the port's ``ClusterCollector`` and the
  reference's scrape the same peers (one served by each package's live
  server, one dead) into equal views once the wall-clock fields are
  removed, and ``fleet_diagnose`` grades both alike.
* A two-process CPU world (``cluster.run_cluster``,
  ``torch_cluster_jobs.fleet_suite``): both workers hold and persist the
  same registry of two URLs, and worker 0's ``/cluster/snapshot`` answers
  for both.
"""

import json
import logging
import os
import time
import urllib.request

import pytest

from sparkucx_tpu.utils import collector as jcoll
from sparkucx_tpu.utils import live as jlive
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.cluster import run_cluster
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.utils import collector as tcoll
from sparkucx_tpu_torch.utils import live as tlive
from torch_ref_cases import case_ids, port_view, run_case

PFX = "spark.shuffle.tpu."
REF = port_view("test_fleet")
# the doctor cases tests/test_torch_doctor.py runs, and the cases with a
# port copy below
DOCTOR_CASES = {"test_peer_unresponsive_telemetry_unreachable_is_warn",
                "test_peer_unresponsive_dead_is_critical",
                "test_peer_unresponsive_wedged_reachable_names_straggler",
                "test_peer_unresponsive_quiet_when_fleet_healthy",
                "test_clock_drift_grades_and_floor"}
COPIED = {"test_advertised_url_rewrite_and_loopback_warn_once",
          "test_node_boot_publishes_registry_and_reanchors",
          "test_node_without_live_server_has_no_fleet"}
CASES = [pytest.param(n, p, id=n) for n, p in case_ids(
    REF, [n for n in dir(REF) if n.startswith("test_")
          and n not in DOCTOR_CASES | COPIED])]


@pytest.mark.parametrize("name,params", CASES)
def test_reference_case(name, params, request):
    """One reference case, unchanged, on the port."""
    run_case(REF, name, params, request)


# -- the port's copies ---------------------------------------------------------
class _FakeLive:
    host, port = "127.0.0.1", 8080


def test_advertised_url_rewrite_and_loopback_warn_once():
    """The reference's case on the port's logger
    (``sparkucx_tpu_torch.collector``)."""
    assert tcoll.advertised_url(ShuffleConf({}, use_env=False), None) is None
    conf = ShuffleConf({PFX + "metrics.httpAdvertiseHost": "tpu-host-7"},
                       use_env=False)
    assert tcoll.advertised_url(conf, _FakeLive(), multiprocess=True) \
        == "http://tpu-host-7:8080"
    bare = ShuffleConf({}, use_env=False)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("sparkucx_tpu_torch.collector")
    logger.addHandler(handler)
    try:
        tcoll._warned_loopback = False
        assert tcoll.advertised_url(bare, _FakeLive(), multiprocess=True) \
            == "http://127.0.0.1:8080"
        tcoll.advertised_url(bare, _FakeLive(), multiprocess=True)
        warns = [r for r in records if "LOOPBACK" in r.getMessage()]
        assert len(warns) == 1
        assert "httpAdvertiseHost" in warns[0].getMessage()
        tcoll._warned_loopback = False
        records.clear()
        tcoll.advertised_url(bare, _FakeLive(), multiprocess=False)
        assert not [r for r in records if "LOOPBACK" in r.getMessage()]
    finally:
        logger.removeHandler(handler)


def test_node_boot_publishes_registry_and_reanchors(tmp_path):
    """The reference's node case on a port node: the registry persisted
    beside the ledger, the watchdog's scrape hook, the snapshot's
    re-anchor and registry, the node's own /cluster/snapshot, and the
    teardown."""
    svc = connect({PFX + "metrics.httpPort": "0",
                   PFX + "failure.ledgerDir": str(tmp_path)},
                  device="cpu", use_env=False)
    node = svc.node
    try:
        reg = tcoll.FleetRegistry.load(str(tmp_path))
        assert reg.expected() == [node.process_id]
        assert reg.peers()[node.process_id] == \
            f"http://{node.live.host}:{node.live.port}"
        assert reg.boot_anchor(node.process_id) is not None
        assert node.collector is not None
        assert node.watchdog.peer_scrape == node.collector.postmortem
        snap = node.telemetry_snapshot()
        assert snap["anchors"][0]["wall_epoch"] == pytest.approx(
            reg.boot_anchor(node.process_id)["wall_epoch"])
        assert abs(snap["anchor_skew_s"]) < 5.0
        assert snap["fleet_registry"]["entries"][0]["url"] == \
            reg.peers()[node.process_id]
        view = json.loads(urllib.request.urlopen(
            f"http://{node.live.host}:{node.live.port}"
            "/cluster/snapshot", timeout=10).read())
        assert view["processes_answered"] == 1
        assert view["missing_peers"] == []
        assert view["peers"][str(node.process_id)]["skew_s"] is not None
    finally:
        svc.stop()
    assert node.collector is None and node.watchdog.peer_scrape is None
    assert node.live._thread.is_alive() is False


def test_node_without_live_server_has_no_fleet(tmp_path):
    svc = connect({PFX + "failure.ledgerDir": str(tmp_path)}, device="cpu",
                  use_env=False)
    node = svc.node
    try:
        assert node.live is None and node.collector is None
        assert len(node.fleet) == 0
        assert not os.path.exists(tcoll.registry_path(str(tmp_path)))
        assert "fleet_registry" not in node.telemetry_snapshot()
        assert "fleet_registry" not in svc.stats("json")
    finally:
        svc.stop()


def test_service_stats_carry_the_registry_and_the_routes_read_the_service(
        tmp_path):
    """The service's provider swap reaches the live routes: /snapshot is
    the service's document (exchange reports included) and carries the
    registry; after stop the server is gone."""
    svc = connect({PFX + "metrics.httpPort": "0",
                   PFX + "a2a.impl": "dense"}, device="cpu", use_env=False)
    try:
        h = svc.register_shuffle(5, 2, 4)
        for m in range(2):
            svc.write(h, m, list(range(m * 64, m * 64 + 64)))
        svc.read(h)
        snap = json.loads(urllib.request.urlopen(
            svc.node.live.url + "/snapshot", timeout=10).read())
        assert [r["shuffle_id"] for r in snap["exchange_reports"]] == [5]
        assert snap["fleet_registry"]["entries"][0]["url"] == \
            svc.node.live.url
        url = svc.node.live.url
    finally:
        svc.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/healthz", timeout=2)


# -- the collectors of both packages on the same peers -----------------------
TR = "s1.e0.x1"
WALL = {"shuffle.exchange": (0, 10_000), "shuffle.plan": (0, 1_000),
        "shuffle.pack": (1_000, 5_000), "shuffle.tier": (6_000, 3_800)}


def _peer_doc(process_id, wall_epoch):
    evs = [{"name": n, "ph": "X", "ts": float(ts), "dur": float(dur),
            "pid": 0, "tid": 1,
            "args": {"trace": TR, **({"completed": True}
                                     if n == "shuffle.exchange" else {}),
                     **({"tier": "dcn"} if n == "shuffle.tier" else {})}}
           for n, (ts, dur) in WALL.items()]
    anchor = {"wall": 50.0, "perf": 0.0, "perf_epoch": 0.0,
              "wall_epoch": float(wall_epoch), "pid": 1.0}
    return {"process_id": process_id, "anchor": anchor,
            "counters": {"shuffle.read.count": 1.0}, "trace_events": evs,
            "decisions": [{"epoch": 0, "seq": 3, "topic": "a2a.waveRows",
                           "ok": True, "ts": 1000.0, "winner": 9}]}


WALL_CLOCK_FIELDS = ("generated_at", "collected_at", "rtt_ms")


def _strip(view):
    out = {k: v for k, v in view.items() if k not in WALL_CLOCK_FIELDS}
    out["peers"] = {p: {k: v for k, v in c.items()
                        if k not in WALL_CLOCK_FIELDS}
                    for p, c in view["peers"].items()}
    return out


@pytest.fixture()
def two_package_peers():
    """A JAX-package live server and a port one, each serving a fixed
    document, plus a registry with their boot anchors and a dead third
    peer."""
    docs = [_peer_doc(0, 1000.25), _peer_doc(1, 2000.0)]
    servers = [jlive.LiveTelemetryServer(lambda: docs[0], lambda: [],
                                         lambda: {"ok": True}).start(),
               tlive.LiveTelemetryServer(lambda: docs[1], lambda: [],
                                         lambda: {"ok": True}).start()]
    entries = [{"process_id": 0, "url": servers[0].url,
                "anchor": {"wall_epoch": 1000.0}, "published_at": 1.0},
               {"process_id": 1, "url": servers[1].url,
                "anchor": {"wall_epoch": 2000.0}, "published_at": 1.0},
               {"process_id": 2, "url": "http://127.0.0.1:9",
                "anchor": {"wall_epoch": 3000.0}, "published_at": 1.0}]
    yield entries
    for s in servers:
        s.stop()


def test_collectors_give_equal_views(two_package_peers):
    views = [mod.ClusterCollector(mod.FleetRegistry(two_package_peers),
                                  timeout_s=3.0).scrape()
             for mod in (jcoll, tcoll)]
    assert _strip(views[0]) == _strip(views[1])
    v = views[1]
    assert v["missing_peers"] == [2] and v["processes_answered"] == 2
    assert v["peers"]["0"]["skew_s"] == pytest.approx(0.25)
    assert v["peers"]["1"]["skew_s"] == 0.0
    assert _strip(tcoll.fleet_meta(views[1])) == \
        _strip(jcoll.fleet_meta(views[0]))

    def graded(mod, view):
        return [(f.rule, f.grade, f.evidence.get("discriminator"))
                for f in mod.fleet_diagnose(view)]

    got = graded(tcoll, views[1])
    assert got == graded(jcoll, views[0])
    assert ("peer_unresponsive", "warn", "telemetry_unreachable") in got
    # and each package grades the other's view alike
    assert graded(tcoll, views[0]) == graded(jcoll, views[1]) == got


def test_collectors_equal_anatomy_and_render(two_package_peers):
    views, colls = [], []
    for mod in (jcoll, tcoll):
        coll = mod.ClusterCollector(mod.FleetRegistry(two_package_peers),
                                    timeout_s=3.0)
        colls.append(coll)
        views.append(coll.scrape())
    assert colls[0].anatomy(views[0], trace_id=TR) == \
        colls[1].anatomy(views[1], trace_id=TR)
    # the table without its wall-clock column
    rows = [[ln.split()[:2] + ln.split()[3:] for ln in
             mod.render_fleet_view(v).splitlines()]
            for mod, v in ((jcoll, views[0]), (tcoll, views[1]))]
    assert rows[0] == rows[1]
    pms = [c.postmortem(what="fenced allgather", trace=TR)
           for c in colls]
    for pm in pms:
        for cell in pm["peers"].values():
            for k in WALL_CLOCK_FIELDS:
                cell.pop(k, None)
            if cell.get("last_decision"):
                cell["last_decision"].pop("since_s")
        pm.pop("generated_at")
    assert pms[0] == pms[1]
    assert pms[1]["peers"]["0"]["last_known"]["settled"] is True


def test_registry_files_read_across_packages(tmp_path):
    """A registry either package saves loads in the other, and a save
    merges the other's rows."""
    anchor = {"wall_epoch": 500.0, "wall": 1.0, "perf": 0.0,
              "perf_epoch": 0.0, "pid": 1.0}
    jcoll.FleetRegistry([jcoll.registry_entry(
        0, "http://a:1", anchor, published_at=10.0)]).save(str(tmp_path))
    tcoll.FleetRegistry([tcoll.registry_entry(
        1, "http://b:1", anchor, published_at=10.0)]).save(str(tmp_path))
    for mod in (jcoll, tcoll):
        reg = mod.FleetRegistry.load(str(tmp_path))
        assert reg.peers() == {0: "http://a:1", 1: "http://b:1"}
        assert reg.boot_anchor(1)["wall_epoch"] == 500.0
    assert open(tcoll.registry_path(str(tmp_path))).read() == \
        json.dumps(jcoll.FleetRegistry.load(str(tmp_path)).to_doc(),
                   indent=1)


# -- a two-process world -------------------------------------------------------
def test_two_process_world_registry_and_cluster_view(tmp_path):
    d = tmp_path / "ledger"
    t0 = time.monotonic()
    run = run_cluster("torch_cluster_jobs:fleet_suite", 2, 8,
                      conf={PFX + "metrics.httpPort": "0",
                            PFX + "failure.ledgerDir": str(d),
                            PFX + "a2a.impl": "dense"},
                      device="cpu", timeout_s=180)
    assert time.monotonic() - t0 < 180
    assert run.returncodes == [0, 0]
    first, second = run.results
    urls = {"0": first["url"], "1": second["url"]}
    assert first["registry"] == second["registry"] == urls
    for res in run.results:
        assert res["scrape_hooked"]
        assert [e["url"] for e in res["snapshot_registry"]["entries"]] == \
            [urls["0"], urls["1"]]
    saved = tcoll.FleetRegistry.load(str(d))
    assert {str(p): u for p, u in saved.peers().items()} == urls
    assert first["snapshot"] == {"expected": [0, 1], "missing_peers": [],
                                 "processes_answered": 2}
    assert first["doctor"] == 2
    # the world read its maps as before: every partition once
    parts = sorted(int(r) for res in run.results for r in res["read"])
    assert parts == list(range(12))


def test_distributed_node_publishes_empty_entry_when_off(monkeypatch):
    """The boot round is unconditional: a distributed node whose server
    is off still calls it, publishing ``{}``, and keeps an empty
    registry."""
    from sparkucx_tpu_torch.runtime import node as node_mod
    sent = []

    def fake_allgather_json(obj):
        sent.append(obj)
        return [obj, {}]

    monkeypatch.setattr(node_mod.distributed, "allgather_json",
                        fake_allgather_json)
    node = node_mod.Node(ShuffleConf({}, use_env=False), device="cpu")
    try:
        node.is_distributed = True
        node._init_fleet()
        assert sent == [{}] and len(node.fleet) == 0
        assert node.collector is None and node.watchdog.peer_scrape is None
    finally:
        node.is_distributed = False
        node.close()
