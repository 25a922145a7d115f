"""Port parity for the collective watchdog and the epoch plane
(``runtime/watchdog.py``, ``runtime/failures.py``, ``Node.remesh``): the
cases of ``tests/test_watchdog.py`` and ``tests/test_failures.py``'s
``EpochManager`` and probe cases against the port, among them the
expiry's flight-recorder postmortem (``peer_timeout``: the trace, the
probe verdict, the stuck sections; ``test_expiry_dumps_postmortem_with_
trace_and_verdict``) with telemetry that fails never masking the verdict
(the fleet scrape's half, ``peer_postmortem``, is
``tests/test_torch_fleet.py``'s), the fence's split between a lost peer
(a transport failure or an expired collective) and a wedged local wait
(its postmortem is ``device_timeout`` and scrapes no peer), the
stale-epoch fence through the manager, and the drills on
real CPU processes (``cluster.run_cluster``): a killed peer and a silent
one each give the survivor ``PeerLostError`` within twice
``failure.collectiveTimeoutMs``, and the recovery drill fences the stale
handle and re-runs the map set on a fresh world of the survivors.
Comparisons are exact; walls are held to the stated envelopes."""

import json
import threading
import time

import numpy as np
import pytest

from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.cluster import run_cluster
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.runtime import failures as failures_mod
from sparkucx_tpu_torch.runtime.failures import (BlockCorruptionError,
                                                 DeviceUnhealthy,
                                                 EpochManager,
                                                 FlightRecorder,
                                                 HealthMonitor,
                                                 PeerLostError,
                                                 StaleEpochError,
                                                 TransientError,
                                                 TruncatedBlockError)
from sparkucx_tpu_torch.runtime.watchdog import (NULL_WATCHDOG, Watchdog,
                                                 configure_from_conf,
                                                 current_watchdog,
                                                 set_global_watchdog)
from sparkucx_tpu_torch.shuffle.distributed import (_fenced, allgather_blob,
                                                   is_transport_failure)
from sparkucx_tpu_torch.utils.metrics import (C_PEER_TIMEOUT, C_PROBE_DEAD,
                                              Metrics)

DEADLINE_MS = 1500.0


@pytest.fixture(autouse=True)
def _restore_global():
    """Every test leaves the process-global fence as it found it."""
    before = current_watchdog()
    yield
    set_global_watchdog(before if before is not NULL_WATCHDOG else None)


# -- arm / run / disarm -----------------------------------------------------
def test_disabled_runs_inline_on_caller_thread():
    wd = Watchdog(0.0)
    assert not wd.enabled
    tid = []
    assert wd.call(lambda: tid.append(threading.get_ident()) or 41) == 41
    assert tid == [threading.get_ident()]
    assert wd.armed() == [] and wd.leaked() == 0


def test_enabled_returns_value_and_disarms():
    wd = Watchdog(5_000.0)
    seen = []
    assert wd.call(lambda: seen.append(wd.armed()) or "ok",
                   what="happy path") == "ok"
    assert len(seen[0]) == 1 and seen[0][0]["what"] == "happy path"
    assert wd.armed() == [] and wd.expiries == 0 and wd.leaked() == 0


def test_worker_exception_is_relayed():
    wd = Watchdog(5_000.0)
    with pytest.raises(ValueError, match="boom"):
        wd.call(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert wd.armed() == [] and wd.expiries == 0


def test_expiry_raises_peer_lost_on_time_and_counts():
    metrics = Metrics()
    wd = Watchdog(150.0, metrics=metrics)
    release = threading.Event()
    t0 = time.perf_counter()
    with pytest.raises(PeerLostError, match="collectiveTimeoutMs"):
        wd.call(release.wait, what="dead allgather")
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert wall_ms < 150.0 + 2_000.0
    assert wd.expiries == 1
    assert metrics.get(C_PEER_TIMEOUT) == 1.0
    assert isinstance(PeerLostError("x"), TransientError)
    assert wd.leaked() == 1 and wd.armed() == []
    release.set()
    deadline = time.monotonic() + 5
    while wd.leaked() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert wd.leaked() == 0


def test_per_call_timeout_override():
    wd = Watchdog(60_000.0)
    release = threading.Event()
    try:
        with pytest.raises(PeerLostError):
            wd.call(release.wait, what="override", timeout_ms=100.0)
    finally:
        release.set()


def test_nested_fenced_sections_stack():
    wd = Watchdog(5_000.0)
    depths = []

    def inner():
        depths.append([e["what"] for e in wd.armed()])
        return 2

    def outer():
        return wd.call(inner, what="inner exchange") + 1

    assert wd.call(outer, what="outer exchange") == 3
    assert depths == [["outer exchange", "inner exchange"]]
    assert wd.armed() == []


def test_inner_expiry_fails_the_outer_section_typed():
    wd = Watchdog(200.0)
    release = threading.Event()
    try:
        with pytest.raises(PeerLostError):
            wd.call(lambda: wd.call(release.wait, what="inner"),
                    what="outer", timeout_ms=30_000.0)
        assert wd.expiries == 1
        assert wd.leaked() == 1
    finally:
        release.set()


class _StubHealth:
    def __init__(self, verdict, delay_s=0.0):
        self.verdict = verdict
        self.delay_s = delay_s
        self.timeout_ms = 500.0
        self.probes = 0

    def probe(self):
        self.probes += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return dict(self.verdict)


def test_expiry_fires_probe_and_counts_dead_devices():
    metrics = Metrics()
    health = _StubHealth({"cpu:0": True, "cpu:1": False, "cpu:2": False})
    wd = Watchdog(100.0, health=health, metrics=metrics)
    release = threading.Event()
    try:
        with pytest.raises(PeerLostError):
            wd.call(release.wait, what="probe drill")
    finally:
        release.set()
    assert health.probes == 1
    assert metrics.get(C_PROBE_DEAD) == 2.0


def test_stuck_probe_is_not_restacked():
    gate = threading.Event()

    class _WedgedHealth(_StubHealth):
        def probe(self):
            self.probes += 1
            gate.wait(10.0)
            return dict(self.verdict)

    health = _WedgedHealth({"cpu:0": False})
    wd = Watchdog(100.0, health=health)
    release = threading.Event()
    try:
        for _ in range(2):
            with pytest.raises(PeerLostError):
                wd.call(release.wait, what="wedged probe")
        assert health.probes == 1
    finally:
        gate.set()
        release.set()


def test_expiry_dumps_postmortem_with_trace_and_verdict(tmp_path):
    rec = FlightRecorder(out_dir=str(tmp_path))
    health = _StubHealth({"cpu:0": False})
    wd = Watchdog(100.0, health=health, flight=rec, metrics=Metrics())
    rec.begin_trace("s7.e0.x3")
    release = threading.Event()
    try:
        with pytest.raises(PeerLostError, match="s7.e0.x3"):
            wd.call(release.wait, what="fenced allgather")
    finally:
        release.set()
        rec.end_trace("s7.e0.x3")
    assert len(rec.dumps) == 1
    doc = json.loads(open(rec.dumps[0]).read())
    pm = doc["peer_timeout"]
    # the postmortem names which exchange was stuck and what the probe saw
    assert pm["trace"] == "s7.e0.x3"
    assert pm["what"] == "fenced allgather"
    assert pm["dead_devices"] == ["cpu:0"]
    assert pm["leaked_threads"] == 1
    # the expired section itself is in the stuck snapshot (the expiry
    # runs before the fence disarms)
    assert [s["what"] for s in pm["stuck_sections"]] == ["fenced allgather"]
    assert pm["stuck_sections"][0]["trace"] == "s7.e0.x3"
    assert pm["peer_postmortem"] is None       # no fleet scrape wired
    kinds = [e["kind"] for e in doc["events"]]
    assert "peer_timeout" in kinds


def test_telemetry_failure_does_not_mask_the_verdict(tmp_path):
    """A broken probe and a broken fleet scrape still give
    PeerLostError, and the flight recorder still dumps."""
    class _ExplodingHealth:
        timeout_ms = 100.0

        def probe(self):
            raise RuntimeError("probe plane down")

    def explode(**kw):
        raise RuntimeError("scrape plane down")

    rec = FlightRecorder(out_dir=str(tmp_path))
    wd = Watchdog(100.0, health=_ExplodingHealth(), flight=rec)
    wd.peer_scrape = explode
    release = threading.Event()
    try:
        with pytest.raises(PeerLostError):
            wd.call(release.wait, what="broken telemetry")
    finally:
        release.set()
    doc = json.loads(open(rec.dumps[0]).read())
    assert doc["peer_timeout"]["probe"] is None
    assert doc["peer_timeout"]["peer_postmortem"] is None


def test_trace_defaults_to_the_newest_in_flight_exchange():
    rec = FlightRecorder(out_dir=None)
    wd = Watchdog(5_000.0, flight=rec)
    seen = []
    rec.begin_trace("s1.e0.x1")
    rec.begin_trace("s2.e0.x2")
    try:
        wd.call(lambda: seen.append(wd.armed()))
        wd.call(lambda: seen.append(wd.armed()), trace="s9.e0.x9")
    finally:
        rec.end_trace("s2.e0.x2")
        rec.end_trace("s1.e0.x1")
    assert [a[0]["trace"] for a in seen] == ["s2.e0.x2", "s9.e0.x9"]


def test_local_expiry_dumps_a_device_timeout_and_scrapes_no_peer(tmp_path):
    rec = FlightRecorder(out_dir=str(tmp_path))
    wd = Watchdog(100.0, flight=rec)
    scraped = []
    wd.peer_scrape = lambda **kw: scraped.append(kw) or {}
    release = threading.Event()
    try:
        with pytest.raises(DeviceUnhealthy):
            wd.call(release.wait, what="exchange completion wait",
                    local=True)
    finally:
        release.set()
    assert scraped == []
    doc = json.loads(open(rec.dumps[0]).read())
    assert "peer_timeout" not in doc
    assert doc["device_timeout"]["what"] == "exchange completion wait"
    assert "peer_postmortem" not in doc["device_timeout"]
    assert doc["reason"].startswith("DeviceUnhealthy")


def test_configure_from_conf_installs_global():
    conf = ShuffleConf(
        {"spark.shuffle.tpu.failure.collectiveTimeoutMs": "1234"},
        use_env=False)
    wd = configure_from_conf(conf)
    assert current_watchdog() is wd
    assert wd.enabled and wd.timeout_ms == 1234.0
    set_global_watchdog(None)
    assert current_watchdog() is NULL_WATCHDOG


def test_conf_zero_disables_but_call_sites_stay_unconditional():
    wd = configure_from_conf(ShuffleConf({}, use_env=False))
    assert current_watchdog() is wd and not wd.enabled
    assert wd.call(lambda: "direct") == "direct"


def test_allgather_blob_rides_the_global_fence():
    class _Spy(Watchdog):
        def __init__(self):
            super().__init__(0.0)
            self.sections = []

        def call(self, fn, *a, what="collective", **kw):
            self.sections.append(what)
            return super().call(fn, *a, what=what, **kw)

    spy = _Spy()
    set_global_watchdog(spy)
    out = allgather_blob(np.arange(4, dtype=np.int64))
    assert np.asarray(out).reshape(-1).tolist() == [0, 1, 2, 3]
    assert "metadata allgather" in spy.sections


def test_node_installs_and_close_uninstalls():
    conf = {"spark.shuffle.tpu.failure.collectiveTimeoutMs": "30000"}
    svc = connect(conf, device="cpu", use_env=False)
    node = svc.node
    try:
        assert current_watchdog() is node.watchdog
        assert node.watchdog.enabled
        assert node.watchdog.health is node.health
        assert node.watchdog.flight is node.flight
    finally:
        svc.close()
    assert current_watchdog() is NULL_WATCHDOG


# -- local waits and transport errors ----------------------------------------
def test_local_wait_expiry_is_a_device_timeout_not_a_lost_peer():
    """A wait on this process's own device work names no peer: its expiry
    raises DeviceUnhealthy and leaves the peer-timeout counter alone."""
    metrics = Metrics()
    wd = Watchdog(150.0, metrics=metrics)
    release = threading.Event()
    try:
        with pytest.raises(DeviceUnhealthy, match="no peer takes part"):
            wd.call(release.wait, what="exchange completion wait",
                    local=True)
    finally:
        release.set()
    assert wd.expiries == 1
    assert metrics.get(C_PEER_TIMEOUT) == 0.0


# gloo's own texts (torch 2.x): a dead peer, a silent one past the group's
# timeout; and errors of this program, which the fence must not hide
GLOO_PEER_GONE = [
    "[third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection closed "
    "by peer [127.0.0.1]:21411. This is typically caused by a remote "
    "worker crashing.",
    "[third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:129] Timed out "
    "waiting 2000ms for send operation to complete",
    "[third_party/gloo/gloo/transport/tcp/pair.cc:598] Connection reset by "
    "peer",
]
GLOO_PROGRAM_FAULT = [
    "ProcessGroupGloo::allgather: invalid tensor size at index 0 "
    "(expected (4), got (2))",
    "[enforce fail at third_party/gloo/gloo/alltoallv.cc:138] "
    "inLengthPerRank[myRank] == outLengthPerRank[myRank].",
    "Split sizes doesn't match total dim 0 size",
]


@pytest.mark.parametrize("text", GLOO_PEER_GONE)
def test_fence_maps_a_transport_failure_to_peer_lost(text):
    assert is_transport_failure(RuntimeError(text))

    def collective():
        raise RuntimeError(text)

    with pytest.raises(PeerLostError, match="failed in its transport"):
        _fenced(collective, "size-row allgather")


@pytest.mark.parametrize("text", GLOO_PROGRAM_FAULT)
def test_fence_raises_a_program_fault_as_it_is(text):
    assert not is_transport_failure(RuntimeError(text))

    def collective():
        raise RuntimeError(text)

    with pytest.raises(RuntimeError) as info:
        _fenced(collective, "size-row allgather")
    assert not isinstance(info.value, PeerLostError)
    assert str(info.value) == text


def test_error_classes():
    assert issubclass(PeerLostError, TransientError)
    assert issubclass(TruncatedBlockError, BlockCorruptionError)
    assert issubclass(BlockCorruptionError, TransientError)
    for cls in (StaleEpochError, DeviceUnhealthy):
        assert issubclass(cls, RuntimeError)
        assert not issubclass(cls, TransientError)


# -- HealthMonitor, epochs ----------------------------------------------------
def test_probe_device_alive():
    hm = HealthMonitor("cpu", timeout_ms=30_000)
    assert hm.probe() == {"cpu": True}
    hm.assert_healthy()


def test_probe_tracks_and_skips_a_stuck_thread(monkeypatch):
    """A device op that never returns: the device is reported dead, the
    parked thread counted and warned about once, and no second thread is
    stacked on it until the first returns."""
    hm = HealthMonitor("cpu", timeout_ms=300)
    gate = threading.Event()
    spawned = []
    real = HealthMonitor._run_one

    def wedge(self, out):
        spawned.append(1)
        if not gate.is_set():
            gate.wait(20.0)
        real(self, out)

    monkeypatch.setattr(HealthMonitor, "_run_one", wedge)
    warnings = []
    monkeypatch.setattr(failures_mod.log, "warning",
                        lambda msg, *a, **kw: warnings.append(msg % a))
    try:
        assert hm.probe() == {"cpu": False}
        assert hm.leaked_probe_threads == 1
        assert hm.probe() == {"cpu": False}
        assert len(spawned) == 1
        with pytest.raises(DeviceUnhealthy):
            hm.assert_healthy()
        assert len([w for w in warnings if "remain parked" in w]) == 1
    finally:
        gate.set()
    deadline = time.monotonic() + 5
    while hm.leaked_probe_threads and time.monotonic() < deadline:
        time.sleep(0.01)
    assert hm.leaked_probe_threads == 0
    assert hm.probe() == {"cpu": True} and len(spawned) == 2


def test_epoch_bump_and_validate():
    em = EpochManager()
    assert em.current == 0
    em.validate(0)
    em.bump("device lost")
    assert em.current == 1
    with pytest.raises(StaleEpochError, match="epoch 0"):
        em.validate(0, "shuffle 3")


def test_epoch_listeners():
    em = EpochManager()
    seen = []
    em.on_bump(seen.append)
    em.bump()
    em.bump()
    em.remove_listener(seen.append)
    assert seen == [1, 2]


def _write_all(svc, h, rng, rows=32):
    for m in range(h.num_maps):
        svc.write(h, m, rng.integers(0, 1 << 20, size=rows))


def test_manager_stale_epoch_fenced(rng):
    """After a remesh, a read of an old handle fails fast; re-registering
    under the new epoch works, and the agreement sequence restarted."""
    from sparkucx_tpu_torch.shuffle.agreement import agree, current_round
    with connect(device="cpu", use_env=False) as svc:
        h = svc.register_shuffle(912, num_maps=2, num_partitions=4)
        _write_all(svc, h, rng)
        agree("epoch.unit", [1])
        assert svc.node.remesh(reason="simulated device loss") == 1
        assert current_round() == (1, 0)
        reads = svc.stats()["counters"].get("shuffle.read.count", 0.0)
        with pytest.raises(StaleEpochError, match="shuffle 912 pinned to "
                                                  "epoch 0, mesh is at 1"):
            svc.read(h)
        with pytest.raises(StaleEpochError):
            svc.submit(h)
        assert svc.stats()["counters"].get("shuffle.read.count", 0.0) == reads
        svc.unregister_shuffle(912)
        h2 = svc.register_shuffle(912, num_maps=2, num_partitions=4)
        assert h2.epoch == 1
        _write_all(svc, h2, rng)
        total = sum(k.shape[0] for _, (k, _) in svc.read(h2).partitions())
        assert total == 2 * 32


def test_remesh_shapes_the_grid_and_needs_agreement_when_distributed():
    with connect(device="cpu", use_env=False) as svc:
        node = svc.node
        assert node.remesh(shards=4) == 1 and node.num_shards == 4
        assert node.grid.shape == (4,)
        with pytest.raises(RuntimeError, match="zero surviving"):
            node.remesh(shards=[])
        node.is_distributed = True
        with pytest.raises(RuntimeError, match="explicitly agreed"):
            node.remesh()
        assert node.remesh(shards=[0, 1]) == 2 and node.num_shards == 2
        node.is_distributed = False


# -- the drills on real processes ----------------------------------------------
FENCE = {"spark.shuffle.tpu.failure.collectiveTimeoutMs": str(DEADLINE_MS)}


def test_chaos_drill_killed_peer_gives_peer_lost():
    """One of two workers is killed after both staged: the survivor's
    read raises PeerLostError within twice the deadline, never a hang."""
    run = run_cluster("chaos", 2, 8, conf=FENCE, device="cpu",
                      timeout_s=120)
    survivor, victim = run.results
    assert victim is None and run.returncodes[1] < 0
    assert survivor["peer_lost"]
    assert survivor["wall_ms"] < 2 * DEADLINE_MS


def test_silent_peer_expires_the_fence():
    """The other worker lives on but never joins the read: the fence
    expires (a watchdog expiry, its worker thread left parked) and the
    survivor raises PeerLostError within twice the deadline."""
    run = run_cluster("torch_cluster_jobs:hang", 2, 8, conf=FENCE,
                      device="cpu", timeout_s=120)
    survivor, victim = run.results
    assert victim == {"victim": True}
    assert 0.9 * DEADLINE_MS <= survivor["wall_ms"] < 2 * DEADLINE_MS
    assert survivor["expiries"] == 1 or "transport" in survivor["error"]
    assert "completeness barrier" in survivor["error"]


def test_recovery_drill_fences_and_reruns_on_the_survivors():
    """Three workers, the last killed after staging: each survivor's read
    fails typed, its remesh over the agreed shards bumps the epoch and its
    stale handle raises StaleEpochError; the full map set then re-runs on
    a fresh world of the two survivors and checks out."""
    run = run_cluster("recovery", 3, 6, conf=FENCE, device="cpu",
                      timeout_s=120)
    assert run.results[2] is None
    for res in run.results[:2]:
        assert res["peer_lost"] and res["wall_ms"] < 2 * DEADLINE_MS
        assert res["epoch"] == 1
        assert "pinned to epoch 0, mesh is at 1" in res["stale_fenced"]
    rerun = run.rerun.results
    assert [r["shards"] for r in rerun] == [[0, 1], [2, 3]]
    rows = 4 * 3 * 200
    assert sum(r["plain_rows"] for r in rerun) == rows
    assert sum(r["ordered_rows"] for r in rerun) == rows
    assert sorted(p for r in rerun for p in r["partitions"]) == \
        list(range(12))
