"""Port parity for the flight recorder (``sparkucx_tpu_torch/runtime/
failures.FlightRecorder``): the counterparts of
``tests/test_flight_recorder.py``.

Each case drives the JAX package's recorder and the port's with the same
calls (through the managers: the JAX package's ``manager_factory`` and
the port's ``connect(device="cpu")``, both ``a2a.impl=dense``, on the
same seeded keys) and holds the port's ring and postmortem to the
reference's: the ring's bound and event kinds, what triggers a dump, the
dump's reason, its fault / retry / epoch / metric events, its counters,
histograms and exchange reports (exact), and its span tracer's keys
(the in-flight trace ids, the anchor, the span summary and chrome
events: the same span names) and its doctor's findings."""

import json
import sys
import threading

import numpy as np
import pytest

from sparkucx_tpu.runtime import failures as jf
from sparkucx_tpu.utils import doctor as jdoctor
from sparkucx_tpu.utils import metrics as jmetrics
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.runtime import failures as tf
from sparkucx_tpu_torch.utils import doctor as tdoctor
from sparkucx_tpu_torch.utils import metrics as tmetrics

BOTH = [pytest.param((jf, jmetrics), id="jax"),
        pytest.param((tf, tmetrics), id="port")]


def _doc(path):
    with open(path) as f:
        return json.load(f)


def _flight_conf(tmp_path, side: str, extra=None):
    conf = {"spark.shuffle.tpu.a2a.impl": "dense",
            "spark.shuffle.tpu.flightRecorder.enabled": "true",
            "spark.shuffle.tpu.flightRecorder.dir":
                str(tmp_path / side / "flight")}
    conf.update(extra or {})
    return conf


@pytest.fixture()
def port_factory():
    made = []

    def make(conf):
        svc = connect(conf, device="cpu", use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    for svc in made:
        svc.stop()


def _rediagnosed(doctor, doc) -> list:
    """``doctor``'s findings on a dump, its own ``findings`` left out."""
    return [f.to_dict() for f in doctor.diagnose(
        {k: v for k, v in doc.items() if k != "findings"})]


def _stage(mgr, sid: int, rows: int, seed: int):
    rng = np.random.default_rng(seed)
    h = mgr.register_shuffle(sid, 2, 4)
    for m in range(2):
        w = mgr.get_writer(h, m)
        w.write(rng.integers(0, 1 << 30, size=rows, dtype=np.int64))
        w.commit(4)
    return h


@pytest.mark.parametrize("mods", BOTH)
def test_ring_is_bounded_and_records_kinds(tmp_path, mods):
    failures, _ = mods
    rec = failures.FlightRecorder(capacity=4, out_dir=str(tmp_path))
    for i in range(10):
        rec.record("metric", name="x", value=float(i))
    rec.on_epoch_bump(3)
    doc = _doc(rec.dump("test"))
    assert len(doc["events"]) == 4
    assert [e["kind"] for e in doc["events"]] == ["metric"] * 3 + ["epoch"]
    assert [e.get("value") for e in doc["events"][:3]] == [7.0, 8.0, 9.0]
    assert doc["reason"] == "test"
    assert {"reason", "ts", "pid", "events", "counters", "gauges",
            "histograms", "contexts"} <= set(doc)


@pytest.mark.parametrize("mods", BOTH)
def test_null_recorder_is_noop(tmp_path, mods):
    failures, _ = mods
    n = failures.NULL_FLIGHT_RECORDER
    n.record("x")
    n.metrics_reporter("a", 1.0)
    n.on_epoch_bump(1)
    assert n.events() == []
    assert n.dump("whatever") is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("mods", BOTH)
def test_retry_budget_exhaustion_dumps_and_observes_latency(tmp_path, mods):
    failures, metrics_mod = mods
    metrics = metrics_mod.Metrics()
    rec = failures.FlightRecorder(out_dir=str(tmp_path))
    policy = failures.RetryPolicy(max_attempts=3, backoff_ms=1.0,
                                  metrics=metrics, flight=rec)

    def always_fails():
        raise failures.TransientError("nope")

    with pytest.raises(failures.TransientError):
        policy.run(always_fails)
    assert len(rec.dumps) == 1
    doc = _doc(rec.dumps[0])
    assert "retry budget exhausted after 3 attempts" in doc["reason"]
    retries = [e for e in doc["events"] if e["kind"] == "retry"]
    assert [e["attempt"] for e in retries] == [1, 2, 3]
    assert metrics.histogram(metrics_mod.H_RETRY_MS).count == 3


@pytest.mark.parametrize("mods", BOTH)
def test_retry_success_does_not_dump(tmp_path, mods):
    failures, _ = mods
    rec = failures.FlightRecorder(out_dir=str(tmp_path))
    policy = failures.RetryPolicy(max_attempts=3, backoff_ms=1.0,
                                  flight=rec)
    calls = []

    def fails_once():
        calls.append(1)
        if len(calls) == 1:
            raise failures.TransientError("transient")
        return "ok"

    assert policy.run(fails_once) == "ok"
    assert rec.dumps == []


def test_injected_fault_postmortem_contains_reports(manager_factory,
                                                    port_factory, tmp_path):
    """A fetch fault armed past the retry budget: one dump, whose
    ``contexts.exchange_reports`` hold the failing shuffle's report and
    the healthy one's completed report, with the fault events, the read
    counter and the read-wait histogram; the recorder turned the tracer
    on, so the dump carries the healthy read's chrome spans, and the
    failing read (its fetch retried inside the read) is in flight; each
    dump carries its package's doctor ``findings`` on itself, and the
    reference's doctor finds the same in the port's dump. (The findings
    themselves may differ: the reference's dump also holds its
    process-global registry, which earlier reads of the process fed.)"""
    extra = {"spark.shuffle.tpu.failure.maxAttempts": "2",
             "spark.shuffle.tpu.failure.backoffMs": "1"}
    got = []
    for side, make in (("jax", manager_factory), ("port", port_factory)):
        mgr = make(_flight_conf(tmp_path, side, extra))
        node = mgr.node
        assert node.flight is not (jf if side == "jax" else tf) \
            .NULL_FLIGHT_RECORDER
        assert node.tracer.enabled
        node.tracer.clear()
        mgr.read(_stage(mgr, 31, 64, 0))
        node.faults.arm("fetch", fail_count=10)
        h2 = _stage(mgr, 32, 16, 1)
        with pytest.raises(Exception) as e:
            mgr.read(h2)
        assert type(e.value).__name__ == "InjectedFault"
        node.faults.disarm("fetch")
        assert len(node.flight.dumps) == 1
        doc = _doc(node.flight.dumps[0])
        reports = doc["contexts"]["exchange_reports"]
        # the port's own span (the staged verify): in its dump, and set
        # aside for the comparison
        own = {"shuffle.verify"} if side == "port" else set()
        assert own <= set(doc["spans"])
        got.append((
            "retry budget exhausted after 2 attempts" in doc["reason"],
            sorted({r["shuffle_id"] for r in reports}),
            [r["completed"] for r in reports if r["shuffle_id"] == 31],
            [e["site"] for e in doc["events"] if e["kind"] == "fault"],
            [e["attempt"] for e in doc["events"] if e["kind"] == "retry"],
            doc["counters"]["shuffle.read.count"],
            "shuffle.read.wait_ms" in doc["histograms"]
            or "shuffle.read.first_wait_ms" in doc["histograms"],
            doc["in_flight_traces"],
            {"shuffle.dispatch", "shuffle.exchange", "shuffle.publish"}
            <= {e["name"] for e in doc["trace_events"]},
            sorted(set(doc["spans"]) - {"compile.step"} - own),
            "wall_epoch" in doc["anchor"], doc["dropped_spans"],
            doc["findings"] == _rediagnosed(jdoctor if side == "jax"
                                            else tdoctor, doc)))
        port_doc = doc
        node.tracer.enabled = False
        node.tracer.clear()
    assert got[0] == got[1]
    assert got[1][:7] == (True, [31, 32], [True], ["fetch", "fetch"],
                          [1, 2], 1.0, True)
    assert got[1][7] == ["s32.e0.x2"] and got[1][8:] == (
        True, got[1][9], True, 0, True)
    # the reference's doctor reads the port's dump as the port's does
    assert _rediagnosed(jdoctor, port_doc) == port_doc["findings"]


@pytest.mark.parametrize("mods", BOTH)
def test_device_unhealthy_dumps(tmp_path, mods, mesh8, monkeypatch):
    failures, _ = mods
    rec = failures.FlightRecorder(out_dir=str(tmp_path))
    mon = failures.HealthMonitor(mesh8 if failures is jf else "cpu",
                                 flight=rec)
    monkeypatch.setattr(mon, "probe", lambda: {"dev0": False})
    with pytest.raises(failures.DeviceUnhealthy):
        mon.assert_healthy()
    assert len(rec.dumps) == 1
    doc = _doc(rec.dumps[0])
    assert "DeviceUnhealthy" in doc["reason"]
    assert [e["devices"] for e in doc["events"]
            if e["kind"] == "device_unhealthy"] == [["dev0"]]


@pytest.mark.parametrize("mods", BOTH)
def test_fault_injector_records_into_recorder(tmp_path, mods):
    failures, _ = mods
    rec = failures.FlightRecorder(out_dir=str(tmp_path))
    inj = failures.FaultInjector(flight=rec)
    inj.arm("site1", fail_count=1)
    with pytest.raises(failures.InjectedFault):
        inj.check("site1")
    doc = _doc(rec.dump("after"))
    assert [e["site"] for e in doc["events"] if e["kind"] == "fault"] \
        == ["site1"]


def test_epoch_bump_and_metric_deltas_in_ring(manager_factory, port_factory,
                                              tmp_path):
    got = []
    for side, make in (("jax", manager_factory), ("port", port_factory)):
        mgr = make(_flight_conf(tmp_path, side))
        node = mgr.node
        mgr.read(_stage(mgr, 41, 32, 2))
        if side == "jax":
            node.remesh(devices=list(node.mesh.devices.reshape(-1)),
                        reason="test bump")
        else:
            node.remesh(node.num_shards, reason="test bump")
        doc = _doc(node.flight.dump("inspect"))
        kinds = {e["kind"] for e in doc["events"]}
        names = {e["name"] for e in doc["events"] if e["kind"] == "metric"}
        got.append(("metric" in kinds, "epoch" in kinds,
                    [e["epoch"] for e in doc["events"]
                     if e["kind"] == "epoch"],
                    {"shuffle.rows", "shuffle.read.count"} <= names))
    assert got[0] == got[1] == (True, True, [1], True)


@pytest.mark.parametrize("mods", BOTH)
def test_abort_hook_installs_and_uninstalls(tmp_path, mods):
    failures, _ = mods
    prev, prev_thread = sys.excepthook, threading.excepthook
    rec = failures.FlightRecorder(out_dir=str(tmp_path))
    rec.install_abort_hook()
    try:
        assert sys.excepthook is not prev
        assert threading.excepthook is not prev_thread
        try:
            raise ValueError("boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        assert len(rec.dumps) == 1
        assert "unhandled ValueError" in _doc(rec.dumps[0])["reason"]
    finally:
        rec.uninstall_abort_hook()
    assert sys.excepthook is prev and threading.excepthook is prev_thread


def test_node_close_uninstalls_the_abort_hook(tmp_path):
    """A node with the recorder on taps the hooks until it closes, so no
    hook leaks into later code."""
    prev = sys.excepthook
    with connect(_flight_conf(tmp_path, "port"), device="cpu",
                 use_env=False) as svc:
        assert svc.node.flight.enabled and sys.excepthook is not prev
    assert sys.excepthook is prev


@pytest.mark.parametrize("mods", BOTH)
def test_dump_never_raises(tmp_path, mods):
    failures, _ = mods
    rec = failures.FlightRecorder(out_dir="/proc/definitely/not/writable")
    assert rec.dump("x") is None
    assert rec.dumps == []
