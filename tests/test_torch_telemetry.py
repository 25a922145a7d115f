"""Port parity for the metrics plane's histograms and exporters
(``sparkucx_tpu_torch/utils/metrics.py``, ``utils/export.py``), the
exchange report's volume fields and ``service.stats``: the cases of
``tests/test_telemetry.py`` but its two CLI cases (the port has no CLI
yet: ROADMAP item 6b), each run on both packages.

Cross-package, exactly: a :class:`Histogram`'s snapshot is byte-equal
(as JSON) to the reference's for the same observations, and so are its
window delta and its merge; ``render_prometheus`` of one document is
byte-equal; the snapshot of a plain read carries the reference's keys.
The JAX package files a read that compiled a step program under
``shuffle.read.first_wait_ms``; the port compiles nothing per shape, so
every port read lands in ``shuffle.read.wait_ms`` (the step cache is not
applicable, ROADMAP §A). Quantiles are estimates within half a bucket
(about 4.5%); they are held to numpy's within 10%, the reference's own
tolerance.

Fault C.6 (ROADMAP §C) is pinned here: ``service.stats()`` returned a
flat counter dict where the reference returns the snapshot document
(``test_stats_returns_the_reference_snapshot_document``)."""

import json
import threading

import numpy as np
import pytest

from sparkucx_tpu.utils import export as jexp
from sparkucx_tpu.utils import metrics as jmet
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.utils import export as texp
from sparkucx_tpu_torch.utils import metrics as tmet

BOTH = [pytest.param((jmet, jexp), id="jax"),
        pytest.param((tmet, texp), id="port")]
PFX = "spark.shuffle.tpu."


def _draws(dist, rng):
    return {"lognormal": lambda: rng.lognormal(3.0, 1.5, size=20000),
            "uniform": lambda: rng.uniform(0.1, 1000.0, size=20000),
            "exponential": lambda: rng.exponential(50.0, size=20000),
            }[dist]()


# -- histograms --------------------------------------------------------------
@pytest.mark.parametrize("mods", BOTH)
@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_histogram_quantiles_match_numpy(dist, mods):
    draws = _draws(dist, np.random.default_rng(0))
    h = mods[0].Histogram("t")
    for v in draws:
        h.observe(v)
    for q in (0.5, 0.9, 0.99):
        est, ref = h.quantile(q), float(np.quantile(draws, q))
        assert abs(est - ref) / ref < 0.10, (dist, q, est, ref)
    assert h.count == 20000
    assert h.max == pytest.approx(float(draws.max()))
    assert h.min == pytest.approx(float(draws.min()))


@pytest.mark.parametrize("mods", BOTH)
def test_histogram_edge_cases(mods):
    H = mods[0].Histogram
    h = H("t")
    assert h.quantile(0.5) == 0.0
    h.observe(0.0)
    h.observe(-5.0)
    assert h.quantile(0.25) == -5.0
    h2 = H("one")
    h2.observe(42.0)
    assert h2.quantile(0.5) == pytest.approx(42.0)
    assert h2.quantile(0.99) == pytest.approx(42.0)
    p = h2.percentiles()
    assert p["count"] == 1.0 and p["mean"] == pytest.approx(42.0)


@pytest.mark.parametrize("mods", BOTH)
def test_histogram_buckets_cumulative_and_terminal(mods):
    h = mods[0].Histogram("t")
    for v in (1.0, 2.0, 4.0, 1000.0):
        h.observe(v)
    buckets = h.buckets()
    cums = [c for _, c in buckets]
    assert cums == sorted(cums)
    assert buckets[-1] == (float("inf"), 4)


@pytest.mark.parametrize("mods", BOTH)
def test_metrics_observe_creates_and_reports(mods):
    met = mods[0]
    m = met.Metrics()
    seen = []
    m.add_reporter(lambda n, v: seen.append((n, v)))
    m.observe("custom.hist", 7.0)
    m.observe(met.H_FETCH_WAIT, 3.0)
    assert m.histogram("custom.hist").count == 1
    assert m.histogram(met.H_FETCH_WAIT).count == 1
    assert ("custom.hist", 7.0) in seen and (met.H_FETCH_WAIT, 3.0) in seen
    assert m.histogram("never.observed") is None


@pytest.mark.parametrize("mods", BOTH)
def test_well_known_histograms_preregistered(mods):
    met = mods[0]
    m = met.Metrics()
    for name in met.WELL_KNOWN_HISTOGRAMS:
        assert m.histogram(name) is not None
        assert name in m.histograms()
    assert m.histograms(populated_only=True) == {}


def test_well_known_histograms_match_reference():
    assert tmet.WELL_KNOWN_HISTOGRAMS == jmet.WELL_KNOWN_HISTOGRAMS
    for name in ("C_TRACE_DROPPED", "C_PHASE_MS", "G_HBM_IN_USE",
                 "G_HBM_LIMIT", "G_HBM_PEAK", "H_PEER_ROWS", "H_PEER_BYTES",
                 "H_BW", "H_FETCH_FIRST", "H_COMPILE_SECS"):
        assert getattr(tmet, name) == getattr(jmet, name)


@pytest.mark.parametrize("mods", BOTH)
def test_timeit_hist_feeds_histogram(mods):
    met = mods[0]
    m = met.Metrics()
    with m.timeit("op", hist=met.H_FETCH_WAIT):
        pass
    assert m.get("op.count") == 1
    assert m.histogram(met.H_FETCH_WAIT).count == 1


@pytest.mark.parametrize("mods", BOTH)
def test_concurrent_reporter_attach_detach_during_inc(mods):
    m = mods[0].Metrics()
    stop = threading.Event()
    INCS, THREADS = 500, 4

    def inc_loop():
        for _ in range(INCS):
            m.inc("c", 1.0)
            m.observe("h", 1.0)

    def churn_loop():
        while not stop.is_set():
            fn = lambda n, v: None  # noqa: E731
            m.add_reporter(fn)
            m.remove_reporter(fn)

    churners = [threading.Thread(target=churn_loop) for _ in range(2)]
    workers = [threading.Thread(target=inc_loop) for _ in range(THREADS)]
    for t in churners + workers:
        t.start()
    for t in workers:
        t.join()
    stop.set()
    for t in churners:
        t.join()
    assert m.get("c") == INCS * THREADS
    assert m.histogram("h").count == INCS * THREADS


@pytest.mark.parametrize("mods", BOTH)
def test_broken_reporter_logged_once_never_raises(mods):
    m = mods[0].Metrics()

    def bad(n, v):
        raise RuntimeError("boom")

    m.add_reporter(bad)
    m.inc("x")
    m.observe("y", 1.0)
    assert m.get("x") == 1


# -- cross-package: snapshots, deltas, merges --------------------------------
@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_histogram_snapshots_byte_equal(dist):
    draws = _draws(dist, np.random.default_rng(5))[:3000]
    extra = np.array([0.0, -2.5, 1e-9, 7.0])
    hs = [mod.Histogram("h") for mod in (jmet, tmet)]
    for h in hs:
        for v in np.concatenate([draws, extra]):
            h.observe(v)
    j, t = (json.dumps(h.snapshot(), sort_keys=True) for h in hs)
    assert j == t
    rebuilt = [mod.Histogram.from_snapshot(json.loads(j), "h")
               for mod in (jmet, tmet)]
    assert json.dumps(rebuilt[0].snapshot(), sort_keys=True) == \
        json.dumps(rebuilt[1].snapshot(), sort_keys=True) == j


def test_histogram_delta_and_merge_byte_equal():
    rng = np.random.default_rng(9)
    w1, w2 = rng.uniform(1, 5, 200), rng.uniform(50, 500, 300)
    out = []
    for mod in (jmet, tmet):
        h = mod.Histogram("w")
        for v in w1:
            h.observe(v)
        s0 = h.snapshot()
        for v in w2:
            h.observe(v)
        other = mod.Histogram("o")
        for v in w2[:50]:
            other.observe(v * 3)
        delta = mod.Histogram.snapshot_delta(h.snapshot(), s0)
        merged = mod.Histogram.from_snapshot(s0, "w").merge(other)
        out.append(json.dumps([delta, merged.snapshot()], sort_keys=True))
    assert out[0] == out[1]


# -- exporters ---------------------------------------------------------------
GOLDEN_DOC = {
    "counters": {"shuffle.rows": 128.0},
    "histograms": {
        "demo.ms": {"count": 3, "sum": 14.0, "min": 2.0, "max": 8.0,
                    "p50": 4.0, "p99": 8.0,
                    "buckets": [[2.0, 1], [4.0, 2], [float("inf"), 3]]},
    },
}


@pytest.mark.parametrize("mods", BOTH)
def test_prometheus_golden(mods):
    golden = "\n".join([
        "# TYPE sparkucx_tpu_shuffle_rows counter",
        "sparkucx_tpu_shuffle_rows 128",
        "# TYPE sparkucx_tpu_demo_ms histogram",
        'sparkucx_tpu_demo_ms_bucket{le="2"} 1',
        'sparkucx_tpu_demo_ms_bucket{le="4"} 2',
        'sparkucx_tpu_demo_ms_bucket{le="+Inf"} 3',
        "sparkucx_tpu_demo_ms_sum 14",
        "sparkucx_tpu_demo_ms_count 3",
        "# TYPE sparkucx_tpu_demo_ms_p50 gauge",
        "sparkucx_tpu_demo_ms_p50 4",
        "# TYPE sparkucx_tpu_demo_ms_p99 gauge",
        "sparkucx_tpu_demo_ms_p99 8",
        "# TYPE sparkucx_tpu_demo_ms_max gauge",
        "sparkucx_tpu_demo_ms_max 8",
    ]) + "\n"
    assert mods[1].render_prometheus(GOLDEN_DOC) == golden


def _full_doc(met, exp):
    """One registry exercising the whole grammar, its snapshot with
    fixed identity fields and spans."""
    m = met.Metrics()
    m.inc("shuffle.read.count", 7)
    m.inc(met.labeled("shuffle.read.count", tenant="whale"), 3)
    m.inc(met.labeled("shuffle.read.count", tenant='e"v\\i\nl'), 1)
    for v in (1.0, 5.0, 50.0, 0.0, 333.3):
        m.observe("shuffle.read.wait_ms", v)
        m.observe(met.labeled("shuffle.read.wait_ms", tenant="whale"),
                  v * 2)
    m.set_gauge("pool.peak_bytes", 4096)
    m.set_gauge(met.labeled(met.G_HBM_IN_USE, device=0), 12345)
    doc = exp.collect_snapshot(m)
    doc["spans"] = {"shuffle.plan": {"count": 2.0, "mean_ms": 0.25,
                                     "p50_ms": 0.2, "p99_ms": 0.3,
                                     "max_ms": 0.3, "total_ms": 0.5}}
    return doc


def test_render_prometheus_byte_equal_across_packages():
    jdoc = _full_doc(jmet, jexp)
    tdoc = _full_doc(tmet, texp)
    # the same document through both renderers, and each package's own
    for doc in (jdoc, tdoc):
        assert texp.render_prometheus(doc) == jexp.render_prometheus(doc)
    assert texp.render_prometheus(tdoc) == jexp.render_prometheus(jdoc)
    texp.validate_exposition(texp.render_prometheus(tdoc))


@pytest.mark.parametrize("mods", BOTH)
def test_prometheus_structurally_valid_from_live_registry(mods):
    met, exp = mods
    m = met.Metrics()
    m.inc("shuffle.rows", 10)
    for v in (1.0, 5.0, 9.0, 200.0):
        m.observe(met.H_FETCH_WAIT, v)
    text = exp.render_prometheus(exp.collect_snapshot(m))
    for ln in [ln for ln in text.splitlines() if ln]:
        if ln.startswith("# TYPE "):
            assert ln.split()[-1] in ("counter", "histogram", "gauge")
        else:
            name, val = ln.rsplit(" ", 1)
            float(val)
            assert name.startswith("sparkucx_tpu_")
    fetch = exp.prom_name(met.H_FETCH_WAIT)
    assert f'{fetch}_bucket{{le="+Inf"}} 4' in text
    assert f"{fetch}_p50 " in text and f"{fetch}_p99 " in text
    assert f"{fetch}_count 4" in text
    exp.validate_exposition(text)


@pytest.mark.parametrize("mods", BOTH)
def test_snapshot_json_roundtrip_renders_identically(mods):
    met, exp = mods
    m = met.Metrics()
    m.inc("a.b", 2)
    m.observe(met.H_FETCH_WAIT, 3.25)
    doc = exp.collect_snapshot(m)
    rendered = exp.render_prometheus(doc)
    assert exp.render_prometheus(json.loads(exp.render_json(doc))) == \
        rendered


@pytest.mark.parametrize("mods", BOTH)
def test_collect_snapshot_merges_registries(mods):
    met, exp = mods
    a, b = met.Metrics(), met.Metrics()
    a.inc("only.a", 1)
    b.inc("only.b", 2)
    a.observe("h", 1.0)
    b.observe("h", 3.0)
    doc = exp.collect_snapshot([a, b])
    assert doc["counters"] == {"only.a": 1, "only.b": 2}
    assert doc["histograms"]["h"]["count"] == 2
    assert {"ts", "pid", "anchor", "counters", "gauges",
            "histograms"} <= set(doc)


# -- the manager's report ----------------------------------------------------
@pytest.fixture()
def port_factory():
    made = []

    def make(conf=None):
        c = {PFX + "a2a.impl": "dense"}
        c.update(conf or {})
        svc = connect(c, device="cpu", use_env=False)
        made.append(svc)
        return svc.manager

    yield make
    for svc in made:
        svc.stop()


def test_exchange_report_known_skew(manager_factory, port_factory):
    """Every row in partition 0: skew_ratio is R; the volume fields and
    the per-peer histograms (one observation a shard) match the
    reference's."""
    R, M, N = 8, 4, 512
    got = []
    for make in (manager_factory, port_factory):
        mgr = make()
        h = mgr.register_shuffle(71, M, R, partitioner="direct")
        for m in range(M):
            w = mgr.get_writer(h, m)
            w.write(np.zeros(N, dtype=np.int64))
            w.commit(R)
        assert mgr.read(h).partition(0)[0].shape[0] == M * N
        rep = mgr.report(71)
        assert rep.completed and rep.error is None
        assert rep.skew_ratio == pytest.approx(R)
        assert sum(rep.peer_rows) == rep.rows_global == M * N
        assert sum(rep.peer_bytes) == rep.bytes_local
        assert rep.group_ms >= rep.dispatch_ms >= 0.0
        assert rep.retries == mgr.node.metrics.get("shuffle.retries")
        d = rep.to_dict()
        json.dumps(d)
        assert not any(k.startswith("_") for k in d)
        met = mgr.node.metrics
        got.append((rep.skew_ratio, rep.peer_rows, rep.peer_bytes,
                    rep.plan_bucket,
                    met.histogram(jmet.H_PEER_ROWS).snapshot(),
                    met.histogram(jmet.H_PEER_BYTES).snapshot(),
                    met.histogram(jmet.H_BW).count))
    assert got[0][:6] == got[1][:6]
    assert got[1][4]["count"] == 8 and got[1][6] == 1


def test_exchange_report_ring_bounded_and_gather(manager_factory,
                                                 port_factory, rng):
    from sparkucx_tpu_torch.config import REPORT_CAPACITY
    for make in (manager_factory, port_factory):
        mgr = make()
        h = mgr.register_shuffle(5, 2, 4)
        for m in range(2):
            w = mgr.get_writer(h, m)
            w.write(rng.integers(0, 1 << 30, size=64, dtype=np.int64))
            w.commit(4)
        mgr.read(h)
        assert len(mgr.reports()) <= REPORT_CAPACITY
        (g,) = mgr.gather_reports(5)
        assert g["shuffle_id"] == 5 and g["completed"] is True
        assert g["trace_id"] == "s5.e0.x1"
        assert mgr.gather_reports(999) == [] and mgr.report(999) is None
        mgr.unregister_shuffle(5)
        assert mgr.report(5) is not None
        (spans,) = mgr.gather_spans()
        assert {"process_id", "pid", "anchor", "events",
                "dropped_spans"} <= set(spans)


def test_fetch_wait_histogram_per_read(port_factory, rng):
    """Every read observes one fetch wait; the port compiles nothing per
    shape, so all three land in ``shuffle.read.wait_ms`` and none in
    the reference's ``first_wait_ms``."""
    mgr = port_factory()
    for sid in (1, 2, 3):
        h = mgr.register_shuffle(sid, 2, 4)
        for m in range(2):
            w = mgr.get_writer(h, m)
            w.write(rng.integers(0, 1 << 30, size=32, dtype=np.int64))
            w.commit(4)
        mgr.read(h)
        mgr.unregister_shuffle(sid)
    wait = mgr.node.metrics.histogram(tmet.H_FETCH_WAIT)
    first = mgr.node.metrics.histogram(tmet.H_FETCH_FIRST)
    assert wait.count == 3 and first.count == 0
    assert wait.max >= wait.quantile(0.5) > 0


# -- service.stats and the dumper --------------------------------------------
def _jax_service(conf):
    from sparkucx_tpu.config import TpuShuffleConf
    from sparkucx_tpu.service import ShuffleService
    c = {PFX + "a2a.impl": "dense", PFX + "io.format": "raw"}
    c.update(conf)
    return ShuffleService(TpuShuffleConf(c, use_env=False))


def _port_service(conf):
    c = {PFX + "a2a.impl": "dense"}
    c.update(conf)
    return connect(c, device="cpu", use_env=False)


def test_service_stats_both_formats(mesh8, rng):
    for make in (_jax_service, _port_service):
        svc = make({})
        try:
            h = svc.register_shuffle(11, 2, 4)
            for m in range(2):
                svc.write(h, m, rng.integers(0, 1 << 30, size=64,
                                             dtype=np.int64))
            svc.read(h)
            doc = svc.stats("json")
            assert doc["counters"]["shuffle.read.count"] == 1
            assert any(r["shuffle_id"] == 11
                       for r in doc["exchange_reports"])
            text = svc.stats("prometheus")
            assert f"{texp.prom_name(tmet.H_FETCH_WAIT)}_p50 " in text
            texp.validate_exposition(text)
            with pytest.raises(ValueError):
                svc.stats("xml")
        finally:
            svc.stop()


def test_stats_returns_the_reference_snapshot_document(mesh8):
    """Fault C.6: a plain read of six 700-row maps (seed 12) — the
    reference's ``stats()`` is the snapshot document (counters,
    histograms, gauges, spans, exchange reports), where the port
    returned a flat counter dict."""
    docs = []
    for make in (_jax_service, _port_service):
        rng = np.random.default_rng(12)
        svc = make({})
        try:
            h = svc.register_shuffle(12, 6, 16)
            for m in range(6):
                svc.write(h, m, rng.integers(0, 1 << 40, size=700,
                                             dtype=np.int64))
            svc.read(h).partition(0)
            docs.append(svc.stats())
        finally:
            svc.stop()
    jdoc, tdoc = docs
    for key in ("counters", "histograms", "gauges", "spans",
                "exchange_reports", "anchor", "pool", "process_id"):
        assert key in jdoc and key in tdoc, key
    for name in ("shuffle.read.count", "shuffle.rows", "shuffle.bytes",
                 "shuffle.payload.bytes"):
        assert tdoc["counters"][name] == jdoc["counters"][name], name
    for d in (jdoc, tdoc):
        assert d["histograms"]["shuffle.read.wait_ms"]["count"] + \
            d["histograms"]["shuffle.read.first_wait_ms"]["count"] == 1
        assert d["histograms"]["shuffle.peer.rows"]["count"] == 8
    (jr,), (tr,) = jdoc["exchange_reports"], tdoc["exchange_reports"]
    for k in ("shuffle_id", "trace_id", "rows_global", "payload_bytes",
              "wire_bytes", "peer_rows", "completed"):
        assert tr[k] == jr[k], k
    assert json.loads(texp.render_json(tdoc))["counters"] == \
        tdoc["counters"]


def test_periodic_dumper_writes_snapshots(mesh8, rng, tmp_path):
    """``metrics.dumpDir``: the dumper's final snapshot at stop carries
    the read, and renders offline to the exposition a live scrape
    gives (the reference renders it through its CLI)."""
    for side, make in (("jax", _jax_service), ("port", _port_service)):
        d = tmp_path / side
        svc = make({PFX + "metrics.dumpDir": str(d),
                    PFX + "metrics.dumpIntervalSecs": "3600"})
        try:
            h = svc.register_shuffle(12, 2, 4)
            for m in range(2):
                svc.write(h, m, rng.integers(0, 1 << 30, size=64,
                                             dtype=np.int64))
            svc.read(h)
        finally:
            svc.stop()
        files = list(d.glob("metrics_*.json"))
        assert len(files) == 1
        doc = json.loads(files[0].read_text())
        assert doc["counters"]["shuffle.read.count"] == 1
        text = texp.render_prometheus(doc)
        assert f"{texp.prom_name(tmet.H_FETCH_WAIT)}_p50 " in text
        texp.validate_exposition(text)


def test_periodic_dumper_cadence_and_failures(tmp_path):
    """The port's dumper: ticks every beat, writes every
    ``dump_every``-th, a tick-only dumper writes nothing, and a failing
    collect never raises."""
    ticks = []
    dumper = texp.PeriodicDumper(lambda: {"counters": {"x": 1.0}},
                                 str(tmp_path), 3600.0,
                                 tick_fns=[lambda: ticks.append(1)],
                                 dump_every=2)
    assert dumper.dump_once(force=False) is None
    assert dumper.dump_once(force=False) == dumper.path
    assert len(ticks) == 2
    assert json.loads(open(dumper.path).read()) == {"counters": {"x": 1.0}}
    tick_only = texp.PeriodicDumper(lambda: {}, None, 3600.0,
                                    tick_fns=[lambda: ticks.append(2)])
    assert tick_only.path is None and tick_only.dump_once() is None
    assert ticks[-1] == 2

    def boom():
        raise RuntimeError("collect failed")

    assert texp.PeriodicDumper(boom, str(tmp_path), 1.0).dump_once() is None
