"""Port parity for the span tracer (``sparkucx_tpu_torch/utils/
trace.py``) and the spans of the port's read path: the 17 cases of
``tests/test_trace.py``, each run on both packages, plus the port's
``torch.profiler`` device trace and, against the JAX manager, the span
names of each read mode and the reports' trace ids.

The last cases drive the same seeded reads (plain, combine, ordered,
waved, device sink; ``a2a.impl=dense``) through the JAX package's
manager and the port's ``connect(device="cpu")`` with the tracer on and
compare, read by read, the multiset of span names (exact, but for the
port's own ``shuffle.verify``, once a read)
and the report's ``trace_id`` (byte-equal). ``compile.step`` and
``shuffle.warmup`` belong to the JAX package's per-shape compiles and
are left out; ``shuffle.merge`` is compared too. Where the reference's
device trace is a TensorBoard profile from ``jax.profiler``, the port's
is ``torch.profiler``'s Chrome trace; on this CPU-only box it records
CPU activity only, as the reference's degrades here."""

import json
import threading
from collections import Counter

import numpy as np
import pytest

from sparkucx_tpu.config import TpuShuffleConf
from sparkucx_tpu.utils import metrics as jmet
from sparkucx_tpu.utils import trace as jtr
from sparkucx_tpu_torch import connect
from sparkucx_tpu_torch.config import ShuffleConf
from sparkucx_tpu_torch.utils import metrics as tmet
from sparkucx_tpu_torch.utils import trace as ttr

BOTH = [pytest.param((jtr, jmet, TpuShuffleConf), id="jax"),
        pytest.param((ttr, tmet, ShuffleConf), id="port")]
# the JAX package's per-shape compile spans: no counterpart in the port
COMPILE_SPANS = ("compile.step", "shuffle.warmup")


@pytest.mark.parametrize("mods", BOTH)
def test_disabled_tracer_records_nothing(mods):
    t = mods[0].Tracer(enabled=False)
    with t.span("x"):
        pass
    t.instant("marker")
    t.record_span("r", 0.0)
    assert t.spans() == []


@pytest.mark.parametrize("mods", BOTH)
def test_disabled_span_is_shared_noop(mods):
    t = mods[0].Tracer(enabled=False)
    assert t.span("a") is t.span("b")
    assert t.span("a").set(x=1) is t.span("a")


@pytest.mark.parametrize("mods", BOTH)
def test_span_timing_and_attrs(mods):
    t = mods[0].Tracer(enabled=True)
    with t.span("work", shuffle_id=7) as s:
        s.set(rows=123)
    (span,) = t.spans()
    assert span.name == "work"
    assert span.attrs == {"shuffle_id": 7, "rows": 123}
    assert span.dur_us >= 0 and span.depth == 0


@pytest.mark.parametrize("mods", BOTH)
def test_nesting_depth(mods):
    t = mods[0].Tracer(enabled=True)
    with t.span("outer"):
        with t.span("inner"):
            pass
    by_name = {s.name: s for s in t.spans()}
    assert by_name["outer"].depth == 0
    assert by_name["inner"].depth == 1
    assert t.spans()[0].name == "inner"


@pytest.mark.parametrize("mods", BOTH)
def test_threads_get_own_tracks(mods):
    t = mods[0].Tracer(enabled=True)

    def work():
        with t.span("threaded"):
            pass

    th = threading.Thread(target=work)
    th.start()
    th.join()
    with t.span("main"):
        pass
    assert len({s.tid for s in t.spans()}) == 2


@pytest.mark.parametrize("mods", BOTH)
def test_ring_buffer_bound_and_drop_count(mods):
    t = mods[0].Tracer(enabled=True, capacity=4)
    for i in range(10):
        t.instant(f"e{i}")
    assert len(t.spans()) == 4
    assert t.dropped == 6
    assert [s.name for s in t.spans()] == ["e6", "e7", "e8", "e9"]


@pytest.mark.parametrize("mods", BOTH)
def test_publish_dropped_watermark_delta(mods):
    tr, met, _ = mods
    t = tr.Tracer(enabled=True, capacity=4)
    m = met.Metrics()
    assert t.publish_dropped(m) == 0
    assert m.get(met.C_TRACE_DROPPED) == 0.0
    for i in range(10):
        t.instant(f"e{i}")
    assert t.publish_dropped(m) == 6
    assert m.get(met.C_TRACE_DROPPED) == 6.0
    assert t.publish_dropped(m) == 0
    t.instant("e10")
    assert t.publish_dropped(m) == 1
    assert m.get(met.C_TRACE_DROPPED) == 7.0


@pytest.mark.parametrize("mods", BOTH)
def test_summary_aggregates(mods):
    t = mods[0].Tracer(enabled=True)
    for _ in range(5):
        with t.span("op"):
            pass
    s = t.summary()["op"]
    assert s["count"] == 5
    assert s["total_ms"] >= 0
    assert s["p50_ms"] <= s["max_ms"]
    assert set(s) == {"count", "total_ms", "mean_ms", "p50_ms", "p99_ms",
                      "max_ms"}


@pytest.mark.parametrize("mods", BOTH)
def test_chrome_export(tmp_path, mods):
    t = mods[0].Tracer(enabled=True)
    with t.span("exported", k="v"):
        pass
    path = str(tmp_path / "trace.json")
    assert t.export_chrome_trace(path) == 1
    doc = json.load(open(path))
    (ev,) = doc["traceEvents"]
    assert (ev["name"], ev["ph"], ev["args"]) == ("exported", "X",
                                                  {"k": "v"})
    assert doc["displayTimeUnit"] == "ms"


@pytest.mark.parametrize("mods", BOTH)
def test_export_nonjsonable_attr(tmp_path, mods):
    t = mods[0].Tracer(enabled=True)
    t.instant("x", arr=np.arange(3))
    path = str(tmp_path / "t.json")
    t.export_chrome_trace(path)
    doc = json.load(open(path))
    assert doc["traceEvents"][0]["args"]["arr"] == repr(np.arange(3))


@pytest.mark.parametrize("mods", BOTH)
def test_configure_from_conf(mods):
    tr, _, conf_cls = mods
    conf = conf_cls({"spark.shuffle.tpu.trace.enabled": "true",
                     "spark.shuffle.tpu.trace.capacity": "128"},
                    use_env=False)
    got = tr.configure_from_conf(conf)
    try:
        assert got is tr.GLOBAL_TRACER
        assert got.enabled and got._capacity == 128
        # the conf turns on the tracer and nothing else
        assert {k for k, v in vars(got).items() if v is True} == \
            {"enabled"}
    finally:
        got.enabled = False
        got.clear()
        got.resize(65536)


@pytest.mark.parametrize("mods", BOTH)
def test_resize_shrink_counts_discards_as_dropped(mods):
    t = mods[0].Tracer(enabled=True, capacity=8)
    for i in range(10):
        t.instant(f"e{i}")
    assert t.dropped == 2
    t.resize(4)
    assert len(t.spans()) == 4
    assert t.dropped == 2 + 4
    assert [s.name for s in t.spans()] == ["e6", "e7", "e8", "e9"]
    t.resize(4)
    assert t.dropped == 6


@pytest.mark.parametrize("mods", BOTH)
def test_configure_from_conf_resize_preserves_drop_count(mods):
    tr, _, conf_cls = mods
    conf = conf_cls({"spark.shuffle.tpu.trace.enabled": "true",
                     "spark.shuffle.tpu.trace.capacity": "8"},
                    use_env=False)
    t = tr.configure_from_conf(conf)
    try:
        t.clear()
        for i in range(12):
            t.instant(f"e{i}")
        assert t.dropped == 4
        conf.set("spark.shuffle.tpu.trace.capacity", "4")
        assert tr.configure_from_conf(conf) is t
        assert t.dropped == 4 + 4
        assert len(t.spans()) == 4
    finally:
        t.enabled = False
        t.clear()
        t.resize(65536)


@pytest.mark.parametrize("mods", BOTH)
def test_dropped_read_is_locked_during_concurrent_records(mods):
    t = mods[0].Tracer(enabled=True, capacity=16)
    N, THREADS = 400, 4

    def work():
        for _ in range(N):
            t.instant("x")

    threads = [threading.Thread(target=work) for _ in range(THREADS)]
    for th in threads:
        th.start()
    reads = [t.dropped for _ in range(100)]
    for th in threads:
        th.join()
    assert reads == sorted(reads)
    assert t.dropped == N * THREADS - 16


@pytest.mark.parametrize("mods", BOTH)
def test_clear_resets(mods):
    t = mods[0].Tracer(enabled=True, capacity=2)
    for i in range(5):
        t.instant(str(i))
    t.clear()
    assert t.spans() == [] and t.dropped == 0


@pytest.mark.parametrize("mods", BOTH)
def test_device_trace_degrades_gracefully(tmp_path, mods):
    t = mods[0].Tracer(enabled=True)
    with t.device_trace(str(tmp_path / "dev")):
        with t.span("inside"):
            pass
    assert t.spans("inside")


def test_anchor_and_spans_ending_after():
    """The clock anchor's keys are the reference's, and the end-ordered
    ring answers ``spans_ending_after`` as the reference's does."""
    for tr in (jtr, ttr):
        t = tr.Tracer(enabled=True)
        assert set(t.anchor()) == {"wall", "perf", "perf_epoch",
                                   "wall_epoch", "pid"}
        for i in range(3):
            with t.span(f"s{i}"):
                pass
        s1 = t.spans("s1")[0]
        got = [s.name for s in t.spans_ending_after(s1.start_us
                                                    + s1.dur_us)]
        assert got == ["s1", "s2"]


def test_format_trace_id_byte_equal():
    for sid, epoch, seq in ((0, 0, 1), (901, 3, 12), (2 ** 40, 7, 99)):
        assert ttr.format_trace_id(sid, epoch, seq) == \
            jtr.format_trace_id(sid, epoch, seq)


def test_port_device_trace_holds_the_annotated_spans(tmp_path):
    """Inside the port's device trace every span is live, enabled or
    not: it records into the ring and opens a ``torch.profiler.
    record_function`` range, so the Chrome trace holds each span as a
    range around the torch ops inside it. After the trace, the disabled
    tracer's ``span()`` is the shared no-op again."""
    import torch
    t = ttr.Tracer(enabled=False)
    with t.device_trace(str(tmp_path / "dev")):
        assert t.live
        with t.span("shuffle.dispatch", rows=3):
            torch.arange(16).sum()
    path = t.device_trace_path
    assert path and path.startswith(str(tmp_path / "dev"))
    events = json.load(open(path))["traceEvents"]
    rng = [e for e in events if e.get("name") == "shuffle.dispatch"
           and e.get("ph") == "X"]
    assert len(rng) == 1
    lo, hi = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
    ops = [e for e in events if e.get("ph") == "X"
           and str(e.get("name", "")).startswith("aten::sum")]
    assert ops and all(lo <= e["ts"] <= hi for e in ops)
    assert t.spans("shuffle.dispatch")[0].attrs == {"rows": 3}
    assert not t.live
    assert t.span("after") is t.span("other")
    with t.span("after"):
        pass
    t.instant("after")
    t.record_span("after", 0.0)
    assert [s.name for s in t.spans()] == ["shuffle.dispatch"]


def test_device_timed_span_on_the_cpu_has_no_device_ms():
    """A span opened with ``device_time`` on the CPU records no events
    and no ``device_ms``, live or not; the export leaves the key out."""
    import torch
    cpu = torch.device("cpu")
    t = ttr.Tracer(enabled=True)
    with t.span("moe.exchange", device_time=cpu, **{"pass": "forward"}):
        torch.ones(4).sum()
    (span,) = t.spans()
    assert span.events is None and span.device_ms is None
    assert span.attrs == {"pass": "forward"}
    assert "device_ms" not in t.chrome_events()[0]["args"]
    t.enabled = False
    with t.span("moe.experts", device_time=cpu):
        pass
    assert len(t.spans()) == 1


def test_port_read_under_a_profiler_records_its_spans():
    """A port read with the tracer disabled, under a CPU-only
    ``torch.profiler`` session: its staged verify, pack and completion
    wait are profiler ranges and ring spans, and the read settles its
    wall and ledger. Once the session ends, ``span()`` is the shared
    no-op again and a read records nothing."""
    from torch.profiler import ProfilerActivity, profile
    svc = connect({"spark.shuffle.tpu.a2a.impl": "dense"}, device="cpu",
                  use_env=False)
    tracer = svc.node.tracer
    want = {"shuffle.verify", "shuffle.pack", "shuffle.exchange.wait"}
    try:
        assert not tracer.enabled
        tracer.clear()
        h = svc.register_shuffle(903, 4, 8)
        rng = np.random.default_rng(5)
        for m in range(4):
            svc.write(h, m, rng.integers(0, 1 << 20, size=256),
                      rng.standard_normal((256, 2)).astype(np.float32))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            svc.read(h).partition(0)
        assert want <= {e.name for e in prof.events()}
        assert want <= {s.name for s in tracer.spans()}
        rep = svc.report(903)
        assert tracer.spans("shuffle.exchange")[-1].attrs["trace"] == \
            rep.trace_id
        assert rep.phases["verify"] > 0.0
        held = len(tracer.spans())
        assert not tracer.live
        assert tracer.span("a") is tracer.span("b")
        svc.read(h).partition(0)
        assert len(tracer.spans()) == held
    finally:
        tracer.clear()
        svc.stop()


def test_shuffle_read_emits_spans(manager_factory):
    """A real read leaves plan / pack / dispatch / publish spans in the
    node's tracer, one publish span per map (both packages)."""
    for side in ("jax", "port"):
        conf = {"spark.shuffle.tpu.trace.enabled": "true"}
        if side == "jax":
            mgr = manager_factory(conf)
            svc = None
        else:
            conf["spark.shuffle.tpu.a2a.impl"] = "dense"
            svc = connect(conf, device="cpu", use_env=False)
            mgr = svc.manager
        tracer = mgr.node.tracer
        tracer.clear()
        try:
            h = mgr.register_shuffle(901, num_maps=4, num_partitions=8)
            rng = np.random.default_rng(0)
            for m in range(4):
                w = mgr.get_writer(h, m)
                w.write(rng.integers(0, 1 << 20, size=64))
                w.commit(h.num_partitions)
            mgr.read(h)
            names = {s.name for s in tracer.spans()}
            assert {"shuffle.plan", "shuffle.pack", "shuffle.dispatch",
                    "shuffle.publish"} <= names, side
            pub = tracer.spans("shuffle.publish")
            assert {s.attrs["map_id"] for s in pub} == {0, 1, 2, 3}
            assert all(s.attrs["rows"] == 64 for s in pub)
        finally:
            mgr.unregister_shuffle(901)
            tracer.enabled = False
            tracer.clear()
            if svc is not None:
                svc.stop()


# -- the read modes' spans against the JAX manager ---------------------------
MODES = {
    "plain": ({}, {}),
    "combine": ({}, {"combine": "sum"}),
    "ordered": ({}, {"ordered": True}),
    "waved": ({"spark.shuffle.tpu.a2a.waveRows": "100"}, {}),
    "device": ({}, {"sink": "device"}),
    "waved_device_ordered": ({"spark.shuffle.tpu.a2a.waveRows": "100"},
                             {"sink": "device", "ordered": True}),
}


def _mode_reads(mgr, kw, seed: int):
    """Three reads of three seeded shuffles (4 maps of 200 rows with two
    float32 value lanes, 8 partitions); per read: (span-name multiset,
    trace id), spans from the submit to the first partition (the host
    view on the device sink)."""
    tracer = mgr.node.tracer
    rng = np.random.default_rng(seed)
    out = []
    for sid in (1, 2, 3):
        h = mgr.register_shuffle(sid, 4, 8)
        for m in range(4):
            w = mgr.get_writer(h, m)
            w.write(rng.integers(0, 1 << 20, size=200),
                    rng.standard_normal((200, 2)).astype(np.float32))
            w.commit(8)
        tracer.clear()
        res = mgr.read(h, **kw)
        if kw.get("sink") == "device":
            res.host_view().partition(0)
        else:
            res.partition(0)
        names = Counter(s.name for s in tracer.spans()
                        if s.name not in COMPILE_SPANS)
        out.append((dict(names), mgr.report(sid).trace_id))
        mgr.unregister_shuffle(sid)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_read_spans_and_trace_ids_match_reference(mode, manager_factory):
    conf, kw = MODES[mode]
    conf = dict(conf, **{"spark.shuffle.tpu.trace.enabled": "true"})
    jgot = _mode_reads(manager_factory(conf), kw, seed=11)
    svc = connect(dict(conf, **{"spark.shuffle.tpu.a2a.impl": "dense"}),
                  device="cpu", use_env=False)
    try:
        tgot = _mode_reads(svc.manager, kw, seed=11)
        spans = [s for s in svc.node.tracer.spans()
                 if s.attrs.get("trace")]
        assert spans and {s.attrs["trace"] for s in spans} == {"s3.e0.x3"}
    finally:
        svc.node.tracer.enabled = False
        svc.stop()
    for names, _ in tgot:
        # the port's own span, once a read: the staged verify (the
        # reference's lands in its submit)
        assert names.pop("shuffle.verify") == 1
    assert tgot == jgot
    assert [t for _, t in tgot] == ["s1.e0.x1", "s2.e0.x2", "s3.e0.x3"]
