"""Port parity for the device-memory sampler (``sparkucx_tpu_torch/
runtime/devmon.py``), the gauges it publishes and their exposition:
the gauge, label, exposition, null-when-off, samples, trace-stamping and
strict-grammar cases of ``tests/test_devmon.py``, each run on both
packages.

The reference samples every local JAX device (eight virtual CPU devices
here); the port samples the one torch device its shards live on. On a
CPU node both land a sample with null device fields. The live server,
the doctor watcher, the cost capture and the bench stage of that file
wait for their modules (ROADMAP items 6b and 7; the step cache's cost
capture is not applicable). Exposition text is compared exactly."""

import re
import time

import numpy as np
import pytest

from sparkucx_tpu.utils import export as jexp
from sparkucx_tpu.utils import metrics as jmet
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.runtime import devmon as tdevmon
from sparkucx_tpu_torch.utils import export as texp
from sparkucx_tpu_torch.utils import metrics as tmet

BOTH = [pytest.param((jmet, jexp), id="jax"),
        pytest.param((tmet, texp), id="port")]
BASE_CONF = {"spark.shuffle.tpu.a2a.impl": "dense",
             "spark.shuffle.tpu.io.format": "raw"}


@pytest.fixture(params=["jax", "port"])
def service_factory(request, mesh8):
    """connect() with overrides over BASE_CONF on one package; tears
    down after (and between calls)."""
    side = request.param
    created = []

    def make(overrides=None):
        while created:
            created.pop().stop()
        conf = dict(BASE_CONF)
        conf.update(overrides or {})
        if side == "jax":
            from sparkucx_tpu.service import connect as jconnect
            svc = jconnect(conf, use_env=False)
        else:
            svc = connect(conf, device="cpu", use_env=False)
        created.append(svc)
        return svc

    make.side = side
    yield make
    while created:
        created.pop().stop()


def _run_exchange(svc, sid, rows=256, maps=2, partitions=4, seed=0):
    rng = np.random.default_rng(seed)
    h = svc.register_shuffle(sid, maps, partitions)
    for m in range(maps):
        svc.write(h, m, rng.integers(0, 1 << 30, size=rows, dtype=np.int64))
    svc.read(h).partition(0)
    svc.unregister_shuffle(sid)


# -- gauges ------------------------------------------------------------------
@pytest.mark.parametrize("mods", BOTH)
def test_gauge_set_semantics_and_clear(mods):
    m = mods[0].Metrics()
    m.set_gauge("g.x", 10)
    m.set_gauge("g.x", 3)
    assert m.get_gauge("g.x") == 3
    m.set_gauge("g.x", None)
    assert "g.x" not in m.gauges()


@pytest.mark.parametrize("mods", BOTH)
def test_labeled_roundtrip_and_pathological_values(mods):
    met = mods[0]
    ident = met.labeled("devmon.hbm.in_use", device=3)
    assert ident == 'devmon.hbm.in_use{device="3"}'
    assert met.parse_labeled(ident) == ("devmon.hbm.in_use",
                                        {"device": "3"})
    evil = 'a"b\\c\nd'
    assert met.parse_labeled(met.labeled("m", rule=evil)) == \
        ("m", {"rule": evil})
    assert met.parse_labeled("junk{not=labels") == ("junk{not=labels",
                                                    None)


@pytest.mark.parametrize("mods", BOTH)
def test_gauges_in_snapshot_and_prometheus_export(mods):
    met, exp = mods
    m = met.Metrics()
    m.set_gauge("pool.peak_bytes", 4096)
    m.set_gauge(met.labeled(met.G_HBM_IN_USE, device=0), 1e9)
    m.set_gauge(met.labeled(met.G_HBM_IN_USE, device=1), 2e9)
    doc = exp.collect_snapshot(m)
    assert doc["gauges"]["pool.peak_bytes"] == 4096
    text = exp.render_prometheus(doc)
    assert "# TYPE sparkucx_tpu_pool_peak_bytes gauge" in text
    assert "sparkucx_tpu_pool_peak_bytes 4096" in text
    assert text.count("# TYPE sparkucx_tpu_devmon_hbm_in_use gauge") == 1
    assert 'sparkucx_tpu_devmon_hbm_in_use{device="0"} 1000000000' in text
    assert 'sparkucx_tpu_devmon_hbm_in_use{device="1"} 2000000000' in text


@pytest.mark.parametrize("mods", BOTH)
def test_prometheus_hardening_golden(mods):
    met, exp = mods
    evil = 'x"y\\z\nw'
    doc = {"gauges": {met.labeled("devmon.capture", rule=evil): 1.0,
                      "junk{not=labels": 2.0}}
    text = exp.render_prometheus(doc)
    assert 'sparkucx_tpu_devmon_capture{rule="x\\"y\\\\z\\nw"} 1' in text
    assert "sparkucx_tpu_junk_not_labels 2" in text
    for ln in text.splitlines():
        if not ln.startswith("#"):
            name, val = ln.rsplit(" ", 1)
            float(val)
            assert re.match(r"^sparkucx_tpu_[A-Za-z0-9_]+(\{.*\})?$", name)
    assert text == jexp.render_prometheus(doc)


# -- the sampler -------------------------------------------------------------
def test_devmon_null_object_when_off(service_factory):
    svc = service_factory()
    mon = svc.node.devmon
    assert mon.enabled is False and mon.samples() == []
    assert mon.sample_once() is None and mon.start() is mon
    if service_factory.side == "port":
        assert mon is tdevmon.NULL_DEVMON


def test_devmon_samples_and_pool_gauges(service_factory):
    svc = service_factory({"spark.shuffle.tpu.devmon.enabled": "true",
                           "spark.shuffle.tpu.devmon.intervalMs": "20"})
    assert svc.node.devmon.enabled
    _run_exchange(svc, sid=1)
    deadline = time.monotonic() + 5.0
    while not svc.node.devmon.samples() and time.monotonic() < deadline:
        time.sleep(0.02)
    samples = svc.node.devmon.samples()
    assert samples, "sampler thread produced nothing"
    s = samples[-1]
    # a CPU device has no memory statistics: the fields are present and
    # null (eight JAX devices; the port's one torch device)
    assert len(s["devices"]) == (8 if service_factory.side == "jax" else 1)
    for d in s["devices"]:
        assert set(d) >= {"index", "in_use", "limit", "peak"}
        assert d["in_use"] is None and d["limit"] is None \
            and d["peak"] is None
    gauges = svc.node.metrics.gauges()
    assert "pool.peak_bytes" in gauges and "pool.in_use_bytes" in gauges
    # a null field clears its gauge
    assert not any(k.startswith("devmon.hbm") for k in gauges)
    assert svc.node.metrics.get("devmon.samples") >= 1
    assert svc.stats("json")["gauges"]["pool.peak_bytes"] >= 0
    assert {"t", "trace", "devices", "pool_in_use_bytes",
            "pool_peak_bytes"} <= set(s)


def test_devmon_trace_id_stamping(service_factory):
    """A sample taken while an exchange is in flight carries its trace
    id, and so does the flight ring's devmon event."""
    svc = service_factory({
        "spark.shuffle.tpu.devmon.enabled": "true",
        "spark.shuffle.tpu.devmon.intervalMs": "3600000",
        "spark.shuffle.tpu.flightRecorder.enabled": "true"})
    svc.node.flight.begin_trace("s9.e0.x9")
    try:
        assert svc.node.flight.current_trace() == "s9.e0.x9"
        svc.node.devmon.sample_once()
    finally:
        svc.node.flight.end_trace("s9.e0.x9")
    svc.node.devmon.sample_once()
    samples = svc.node.devmon.samples()
    assert samples[-2]["trace"] == "s9.e0.x9"
    assert samples[-1]["trace"] is None
    events = [e for e in list(svc.node.flight._events)
              if e["kind"] == "devmon"]
    assert [e.get("trace") for e in events] == ["s9.e0.x9"]
    # the tracer the recorder turned on holds the sampler's instants
    stamps = [s.attrs["trace"] for s in svc.node.tracer.spans(
        "devmon.sample")]
    assert stamps[-2:] == ["s9.e0.x9", ""]
    svc.node.tracer.enabled = False


def test_devmon_samples_a_read_in_flight():
    """On the port the read itself opens the trace the sampler stamps:
    a sample taken from inside the pack carries the read's trace id."""
    svc = connect(dict(BASE_CONF, **{
        "spark.shuffle.tpu.devmon.enabled": "true",
        "spark.shuffle.tpu.devmon.intervalMs": "3600000",
        "spark.shuffle.tpu.flightRecorder.enabled": "true"}),
        device="cpu", use_env=False)
    try:
        orig = svc.manager._pack_shards

        def pack(*a, **kw):
            svc.node.devmon.sample_once()
            return orig(*a, **kw)

        svc.manager._pack_shards = pack
        _run_exchange(svc, sid=4)
        assert svc.node.devmon.samples()[-1]["trace"] == "s4.e0.x1"
        assert svc.node.flight.current_trace() is None
    finally:
        svc.node.tracer.enabled = False
        svc.stop()


def test_device_memory_of_a_cpu_device_is_null():
    import torch
    assert tdevmon.device_memory(torch.device("cpu")) == {
        "in_use": None, "limit": None, "peak": None}


@pytest.mark.parametrize("mods", BOTH)
def test_prometheus_full_grammar_golden_strict_checker(mods):
    met, exp = mods
    m = met.Metrics()
    m.inc("shuffle.read.count", 7)
    m.inc(met.labeled("shuffle.read.count", tenant="whale"), 3)
    m.inc(met.labeled("shuffle.read.count", tenant='e"v\\i\nl'), 1)
    for v in (1.0, 5.0, 50.0):
        m.observe("shuffle.read.wait_ms", v)
        m.observe(met.labeled("shuffle.read.wait_ms", tenant="whale"),
                  v * 2)
    m.set_gauge("pool.peak_bytes", 4096)
    m.set_gauge(met.labeled(met.G_HBM_IN_USE, device=0), 12345)
    text = exp.render_prometheus(exp.collect_snapshot(m))
    exp.validate_exposition(text)
    broken = text.replace(
        'sparkucx_tpu_shuffle_read_wait_ms_bucket{le="+Inf"} 3',
        'sparkucx_tpu_shuffle_read_wait_ms_bucket{le="+Inf"} 0')
    assert broken != text
    with pytest.raises(ValueError):
        exp.validate_exposition(broken)
    with pytest.raises(ValueError, match="no preceding # TYPE"):
        exp.validate_exposition("orphan_metric 1\n")
    lines = text.splitlines()
    lines.append(lines[next(i for i, ln in enumerate(lines)
                            if not ln.startswith("#"))])
    with pytest.raises(ValueError, match="adjacent"):
        exp.validate_exposition("\n".join(lines))
